"""A full block: every slot live, as a block at the reference's
6,000,000-Gaussian densify cap is (train.py:146), held to the benchmark's
plain reference (``gpubench/reference/train.py``) on the CPU at a small size.

- ``densify_impl`` on a block whose capacity (3,000 slots, not a power of
  two) equals its live count, with hot clones and splits that outnumber the
  free slots: the same alive slots and values as the reference's
  ``densify``, and as many children dropped; and on the same block with a
  third of its slots dead, where every child is placed. Params to 1e-5
  relative and 1e-6 absolute, the JAX comparison's tolerance
  (``tests/test_torch_densify.py``): a child's offset is a rotation times
  the noise in another summation order. The counters ``densify_impl``
  fills: placed + dropped = wanted, placed <= free, and each equals what
  the masks give.
- Two ``train_step_impl`` steps and a densify at the cap, through the
  benchmark's own loop and check (``gpubench/drivers/train``) against the
  reference from the same inputs: each step's loss within 1e-5 relative
  (the port's plain blend and the reference's grouped one sum a pixel's
  samples in the same order, the SSIM and L1 means in another); every
  leaf's first gradient within 1e-4 of its norm or the median leaf's,
  whichever is larger (the parity rule for gradients; the port's is read
  from Adam's first moment, as the benchmark reads it); densify gives the
  same population and, replayed slot for slot on the port's pre-densify
  state, the same slots and values to 1e-6.
"""

import numpy as np
import pytest
import torch

from gpubench import scene
from gpubench.drivers import train as bench_train
from gpubench.reference import train as ref_train
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.train.step import TrainState, densify_impl

CAPACITY = 3000
EXTENT = 3.0
RULES = {"densify_grad_threshold": 0.0002, "min_opacity": 0.005,
         "percent_dense": 0.01}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # parallel test workers: a multithreaded CPU torch oversubscribes cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def full_block(seed, c=CAPACITY):
    """A block with every slot live: hot clones and splits (a third of the
    slots reach the gradient threshold), low opacities to prune and large
    screen radii for ``prune_big``."""
    rng = np.random.default_rng(seed)
    params = {
        "xyz": rng.normal(size=(c, 3)),
        "f_dc": rng.normal(size=(c, 3)),
        "f_rest": rng.normal(size=(c, 15, 3)),
        "scaling": rng.uniform(-4.5, -2.5, (c, 3)),
        "rotation": rng.normal(size=(c, 4)),
        "opacity": rng.uniform(-7, 2, (c, 1)),
    }
    stats = {
        "grad_accum": rng.uniform(0, 0.0006, c),
        "denom": rng.integers(1, 4, c),
        "max_radii2d": rng.uniform(0, 25, c),
    }
    as_t = lambda d: {k: torch.tensor(v, dtype=torch.float32)  # noqa: E731
                      for k, v in d.items()}
    return as_t(params), torch.ones(c, dtype=torch.bool), as_t(stats)


def masks(params, alive, stats, prune_big):
    """The densify masks written out from the rules (gaussian_model.py:
    377-429): clone, split, pruned by opacity or size, free after both."""
    grads = stats["grad_accum"] / torch.clamp_min(stats["denom"], 1.0)
    smax = torch.exp(params["scaling"]).max(dim=1).values
    hot = alive & (grads >= RULES["densify_grad_threshold"])
    big = smax > RULES["percent_dense"] * EXTENT
    pruned = alive & (torch.sigmoid(params["opacity"][:, 0])
                      < RULES["min_opacity"])
    if prune_big:
        pruned |= alive & ((stats["max_radii2d"] > 20.0)
                           | (smax > 0.1 * EXTENT))
    split = hot & big
    return hot & ~big, split, pruned, ~(alive & ~pruned & ~split)


def port_densify(params, alive, stats, noise, prune_big):
    opt = optim.init_adam(params)
    for leaves in opt["mu"].values():
        leaves[0].fill_(1.0)
    state = TrainState({k: v.clone() for k, v in params.items()}, None,
                       opt, None, alive.clone(),
                       {k: v.clone() for k, v in stats.items()})
    counts = {}
    out = densify_impl(state, None, EXTENT, ocfg=OptimConfig(
        **RULES, capacity=alive.shape[0]),
        prune_big=prune_big, noise=noise, counts=counts)
    return out, counts


@pytest.mark.parametrize("prune_big,live", [(False, CAPACITY),
                                            (True, CAPACITY), (True, 2000)],
                         ids=["False", "True", "free_slots"])
def test_full_block_densify_matches_reference(prune_big, live):
    # ``free_slots``: a third of the slots dead, so every child is placed
    params, alive, stats = full_block(3)
    alive[live:] = False
    for k in ("scaling", "opacity"):
        params[k][live:] = G.DEAD_FILL
    noise = scene.split_noise(11, 5000, CAPACITY, "cpu")
    out, counts = port_densify(params, alive, stats, noise, prune_big)
    r_p, r_alive = ref_train.densify(params, alive, stats, noise, RULES,
                                     EXTENT, prune_big)
    np.testing.assert_array_equal(out.alive.numpy(), r_alive.numpy())
    for k in G.PARAM_KEYS:
        np.testing.assert_allclose(out.params[k].numpy(), r_p[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the counters: 0-d device tensors, each what the masks give
    assert set(counts) == {"wanted", "placed", "dropped", "pruned", "free"}
    assert all(v.dim() == 0 and v.dtype == torch.int64
               for v in counts.values())
    c = {k: int(v) for k, v in counts.items()}
    clone, split, pruned, free = masks(params, alive, stats, prune_big)
    assert c["wanted"] == int(clone.sum() + 2 * split.sum())
    assert c["pruned"] == int(pruned.sum())
    assert c["free"] == int(free.sum())
    assert c["placed"] + c["dropped"] == c["wanted"]
    assert c["placed"] == min(c["wanted"], c["free"])
    assert c["placed"] == int((out.alive & free).sum())
    if live == CAPACITY:
        # the reference fills every free slot and drops the rest
        assert bool(r_alive.all())
        assert c["dropped"] == c["wanted"] - c["free"] > 0
    else:
        assert c["dropped"] == 0 and c["placed"] < c["free"]
    # the moment surgery: the moments of every slot written are zeroed,
    # the others kept
    written = free & out.alive
    for k in G.PARAM_KEYS:
        m = out.opt_g["mu"][k][0]
        assert not bool(m[written].any()), k
        assert bool((m[alive & ~free] == 1.0).all()), k


def tiny_cap_config():
    """The benchmark's cap6m configuration at a test's size: a full block
    of 400 Gaussians in 400 slots at 48x32, a dozen cameras."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "gpubench"
                      / "configs" / "cap6m.json").read_text())
    cfg.update(width=48, height=32, fx=32.0)
    cfg["block"].update(capacity=400, live=400, fine_sigma=0.5,
                        coarse_sigma=1.0)
    cfg["block"]["rig"].update(ring_cameras=12, hold=4)
    return cfg


def test_steps_and_densify_at_the_cap_match_reference(monkeypatch):
    from pcp_tpu_torch.train import step

    counts = {}
    real = step.densify_impl
    monkeypatch.setattr(step, "densify_impl", lambda *a, **kw: real(
        *a, **dict(kw, counts=counts)))
    cfg = tiny_cap_config()
    seed = 2 ** 31 + 7
    block = bench_train.Block(cfg, seed, "cpu")
    ocfg = bench_train.optim_config(cfg)
    assert ocfg.capacity == cfg["block"]["live"]
    start = bench_train.check_start(4998, 2, ocfg)
    order = scene.camera_order(seed, len(block.views), 2)
    loop = bench_train.Loop(block, bench_train.port_state(block, start),
                            ocfg, order, start)
    prog = bench_train.check_steps(loop, start, 2, seed)
    notes, values = bench_train.reference_check(block, start, 2, order,
                                                prog)
    assert values["loss_gap"] <= 1e-5, notes["loss"]
    assert values["grad_gap"] <= 1e-4, notes["grad_gaps"]
    # the population after densify, and densify itself slot for slot
    assert values["densify_alive_gap"] == 0.0
    assert notes["densify_slots_apart"] == 0
    assert notes["densify_value_gap"] <= 1e-6
    # the block was full: every slot live before and after densify
    assert bool(prog["densify_in"]["alive"].all())
    assert bool(prog["densify_out"]["alive"].all())
    assert int(counts["dropped"]) > 0
