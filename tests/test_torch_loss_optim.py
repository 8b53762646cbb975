"""The port's loss, image metrics, LR schedule and Adam vs the JAX
package's, on the same seeded numpy inputs.

- ``l1_loss`` and ``ssim`` (plain and masked) and their gradients: both
  blur with the same 11-tap fp32 shift-and-add, so values agree to 1e-6
  and gradients to 1e-5 relative;
- ``mse`` / ``psnr``: 1e-6 relative;
- ``l2_loss``: 1e-6 relative; ``photometric_loss(pred, raw_pred,
  target)``: 1e-6 absolute, the SSIM's own tolerance;
- ``expon_lr``: both evaluate in fp32, 1e-6 relative;
- ``adam_step`` with a schedule, ``zero_moments`` on a slot mask and on one
  group: parameters and moments to 1e-6 relative after four steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.train import optim as joptim
from pcp_tpu.utils import general as jgeneral
from pcp_tpu.utils import image as jimage
from pcp_tpu.utils import loss as jloss
from pcp_tpu_torch.train import optim as toptim
from pcp_tpu_torch.utils import general as tgeneral
from pcp_tpu_torch.utils import image as timage
from pcp_tpu_torch.utils import loss as tloss


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _images(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    mask = np.zeros((h, w), bool)
    mask[:30, :41] = True
    return a, b, mask


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_loss_and_grads_match_jax(masked):
    a, b, mask = _images(1)

    def j_fn(x, y):
        m = jnp.asarray(mask) if masked else None
        chw = lambda t: jnp.transpose(t, (2, 0, 1))  # noqa: E731
        return (0.8 * jloss.l1_loss(x, y, m)
                + 0.2 * (1.0 - jloss.ssim(chw(x), chw(y), valid_mask=m)))

    j_val, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(a), jnp.asarray(b))
    x = torch.tensor(a, requires_grad=True)
    m = torch.from_numpy(mask) if masked else None
    chw = lambda t: t.permute(2, 0, 1)  # noqa: E731
    t_val = (0.8 * tloss.l1_loss(x, torch.from_numpy(b), m)
             + 0.2 * (1.0 - tloss.ssim(chw(x), chw(torch.from_numpy(b)),
                                       valid_mask=m)))
    t_val.backward()
    t_val = t_val.detach()
    assert abs(float(t_val) - float(j_val)) <= 1e-6 * abs(float(j_val))
    assert _rel(x.grad.numpy(), j_grad) < 1e-5
    if masked:
        assert (x.grad.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("decoupled", [False, True])
def test_l2_and_photometric_loss_match_jax(decoupled):
    a, b, _ = _images(5)
    pred = np.clip(a * 0.9 + 0.05, 0, 1) if decoupled else a
    chw = lambda x: np.ascontiguousarray(x.transpose(2, 0, 1))  # noqa: E731
    j_args = [jnp.asarray(chw(x)) for x in (pred, a, b)]
    t_args = [torch.from_numpy(chw(x)) for x in (pred, a, b)]
    for lam in (0.2, 0.5):
        j = float(jloss.photometric_loss(*j_args, lambda_dssim=lam))
        t = float(tloss.photometric_loss(*t_args, lambda_dssim=lam))
        assert abs(t - j) <= 1e-6
    j = float(jloss.l2_loss(jnp.asarray(a), jnp.asarray(b)))
    t = float(tloss.l2_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(t - j) <= 1e-6 * j


def test_ssim_components_match_jax():
    a, b, _ = _images(2)
    for img1, img2 in ((a, b), (a, a)):
        j = float(jloss.ssim(jnp.asarray(img1.transpose(2, 0, 1)),
                             jnp.asarray(img2.transpose(2, 0, 1))))
        t = float(tloss.ssim(torch.from_numpy(img1).permute(2, 0, 1),
                             torch.from_numpy(img2).permute(2, 0, 1)))
        assert abs(t - j) <= 1e-6
    assert abs(t - 1.0) < 1e-6          # identical images


def test_psnr_matches_jax():
    a, b, _ = _images(3)
    x, y = np.stack([a, b]), np.stack([b, b])
    j = np.asarray(jimage.psnr(jnp.asarray(x), jnp.asarray(y)))
    t = timage.psnr(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert _rel(t[:1], j[:1]) < 1e-6
    assert t[1] == j[1] == pytest.approx(120.0)    # mse clamped at 1e-12


@pytest.mark.parametrize("delay", [0, 100])
def test_expon_lr_matches_jax(delay):
    for step in (0, 1, 17, 500, 29_999, 30_000, 40_000):
        kw = dict(lr_init=0.00016 * 5.53, lr_final=0.0000016 * 5.53,
                  lr_delay_steps=delay, lr_delay_mult=0.01, max_steps=30_000)
        j = float(jgeneral.expon_lr(step, **kw))
        t = tgeneral.expon_lr(step, **kw)
        assert abs(t - j) <= 1e-6 * j, (step, t, j)
    assert tgeneral.expon_lr(5, 0.0, 1e-3) == 0.0


def test_adam_and_moment_surgery_match_jax():
    rng = np.random.default_rng(4)
    c = 64
    shapes = {"xyz": (c, 3), "f_rest": (c, 15, 3), "opacity": (c, 1)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    lrs_j = {"xyz": lambda s: jgeneral.expon_lr(s, 1e-3, 1e-5,
                                                max_steps=10),
             "f_rest": 0.0025 / 20.0, "opacity": 0.05}
    lrs_t = {"xyz": lambda s: tgeneral.expon_lr(s, 1e-3, 1e-5,
                                                max_steps=10),
             "f_rest": 0.0025 / 20.0, "opacity": 0.05}
    j_p = {k: jnp.asarray(v) for k, v in params.items()}
    j_s = joptim.init_adam(j_p)
    t_p = {k: torch.tensor(v) for k, v in params.items()}
    t_s = toptim.init_adam(t_p)
    written = rng.uniform(size=c) < 0.3
    for it in range(4):
        grads = {k: rng.normal(0, 10.0 ** -it, size=s).astype(np.float32)
                 for k, s in shapes.items()}
        j_p, j_s = joptim.adam_step(j_p, {k: jnp.asarray(v)
                                          for k, v in grads.items()},
                                    j_s, lrs_j)
        toptim.adam_step(t_p, {k: torch.tensor(v) for k, v in grads.items()},
                         t_s, lrs_t)
        if it == 1:
            j_s = joptim.zero_moments(j_s, jnp.asarray(written))
            toptim.zero_moments(t_s, torch.from_numpy(written))
        if it == 2:
            j_s = joptim.zero_moments(j_s, jnp.ones(c, bool),
                                      keys=("opacity",))
            toptim.zero_moments(t_s, torch.ones(c, dtype=torch.bool),
                                keys=("opacity",))
    assert t_s["count"] == int(j_s["count"]) == 4
    for k in shapes:
        assert _rel(t_p[k].numpy(), j_p[k]) < 1e-6, k
        assert _rel(t_s["mu"][k][0].numpy(), j_s["mu"][k]) < 1e-6, k
        assert _rel(t_s["nu"][k][0].numpy(), j_s["nu"][k]) < 1e-6, k
