"""The port's training step and loop vs the JAX package's, on the
``tests/synthetic.py`` scene on the CPU.

Milestone: one ``train_step_impl`` and then ten steps with a densify in
between match JAX's ``make_train_step`` / ``make_densify_step`` (appearance
on, SH degree 3). The JAX state is carried across with
``train_state_from_numpy``; the split noise JAX draws from its key is fed to
the port's densify.

Tolerances: the first step's loss within 1e-5 relative; its gradients
within 1e-4 relative per group (max |port - jax| / max |jax|), read from
Adam's first moment, which after one step is exactly (1 - B1) * g in both.
The tenth loss within 1e-4 relative.

Parameters after the first step are held only where the JAX gradient is
above 1e-2 of its group's largest: with EPS = 1e-15 Adam's first update is
+-lr for every nonzero gradient, so where |g| is at rounding noise its sign,
and with it the parameter, may differ by 2 lr between the packages. Where
the gradient is well above the noise both move by the same lr.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.scene import cameras as jcam
from pcp_tpu.scene import load_colmap_scene as j_load
from pcp_tpu.train import config as jcfg
from pcp_tpu.train.loop import init_state as j_init_state
from pcp_tpu.train.step import make_densify_step, make_train_step
from pcp_tpu_torch.models.gaussians import PARAM_KEYS
from pcp_tpu_torch.scene import cameras as tcam
from pcp_tpu_torch.scene import load_colmap_scene as t_load
from pcp_tpu_torch.train import config as tcfg
from pcp_tpu_torch.train.step import (
    app_groups,
    densify_impl,
    train_state_from_numpy,
    train_step_impl,
)
from tests.synthetic import write_synthetic_scene

SH = 3
CAPACITY = 256


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    write_synthetic_scene(str(d), np.random.default_rng(3), n_points=80,
                          n_cams=6)
    return str(d)


def _ocfgs():
    kw = dict(capacity=CAPACITY, max_per_tile=128)
    return jcfg.OptimConfig(**kw), tcfg.OptimConfig(**kw)


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _port_state(j_state):
    s = _np_tree(j_state)
    return train_state_from_numpy(s.params, s.app, s.opt_g, s.opt_a,
                                  s.alive, s.stats, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _j_moments(j_state):
    """First moments per group, flattened the port's way."""
    from pcp_tpu_torch.models.appearance import net_tensors_from_flax

    mu = _np_tree(j_state.opt_g["mu"])
    out = {k: mu[k] for k in PARAM_KEYS}
    mu_a = _np_tree(j_state.opt_a["mu"])
    out["embeddings"] = mu_a["embeddings"]
    for i, t in enumerate(net_tensors_from_flax(mu_a["net"], "cpu")):
        out[f"net{i}"] = t.numpy()
    return out


def _t_moments(t_state):
    out = {k: t_state.opt_g["mu"][k][0].numpy() for k in PARAM_KEYS}
    out["embeddings"] = t_state.opt_a["mu"]["embeddings"][0].numpy()
    for i, t in enumerate(t_state.opt_a["mu"]["net"]):
        out[f"net{i}"] = t.numpy()
    return out


class _Pair:
    """The same synthetic scene, cameras and start state in both packages."""

    def __init__(self, scene_dir):
        self.j_scene = j_load(scene_dir)
        self.t_scene = t_load(scene_dir)
        self.j_cams = [jcam.from_info(i, 1) for i in self.j_scene.cameras]
        self.t_cams = [tcam.from_info(i, 1) for i in self.t_scene.cameras]
        self.j_ocfg, self.t_ocfg = _ocfgs()
        cfg = jcfg.TrainRunConfig(
            model=jcfg.ModelConfig(sh_degree=SH), optim=self.j_ocfg,
            pipeline=jcfg.PipelineConfig(use_appearance=True))
        cam = self.j_cams[0]
        self.size = (cam.width, cam.height)
        j_state = j_init_state(self.j_scene, cfg, self.size,
                               jax.random.PRNGKey(4))
        # kNN init is isotropic with zero SH rest, where the rotation and
        # SH-rest gradients are rounding noise: give the live Gaussians
        # seeded anisotropy, rotations and view-dependent colour
        rng = np.random.default_rng(12)
        p = _np_tree(j_state.params)
        n = int(np.asarray(j_state.alive).sum())
        p["scaling"][:n] += rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
        p["rotation"][:n] = rng.normal(size=(n, 4)).astype(np.float32)
        p["f_rest"][:n] = rng.normal(0, 0.1, p["f_rest"][:n].shape).astype(
            np.float32)
        self.j_state = j_state._replace(
            params={k: jnp.asarray(v) for k, v in p.items()})
        self.t_state = _port_state(self.j_state)
        self.j_step = make_train_step(self.j_ocfg, self.size,
                                      self.j_scene.extent)
        self.bg = np.zeros(3, np.float32)

    def gt_u8(self, i):
        return np.round(self.j_cams[i].gt_image * 255.0).astype(np.uint8)

    def step(self, i):
        """Camera ``i`` through both steps; returns (jax loss, port loss)."""
        j_cam, t_cam = self.j_cams[i], self.t_cams[i]
        viewmat, intrin = jcam.camera_device_arrays(j_cam)
        self.j_state, j_m = self.j_step(
            self.j_state, viewmat, intrin, jnp.asarray(self.gt_u8(i)),
            jnp.int32(j_cam.uid), jnp.asarray(self.bg), SH)
        t_view, t_intrin = tcam.camera_tensors(t_cam, torch.device("cpu"))
        self.t_state, t_m = train_step_impl(
            self.t_state, t_view, t_intrin, torch.from_numpy(self.gt_u8(i)),
            t_cam.uid, torch.from_numpy(self.bg), self.t_scene.extent,
            ocfg=self.t_ocfg, image_size=self.size, sh_degree=SH,
            use_appearance=True)
        assert t_m["n_pairs"] == int(j_m["n_pairs"])
        assert t_m["n_dropped"] == 0 and int(j_m["n_dropped"]) == 0
        assert int(t_m["n_visible"]) == int(j_m["n_visible"])
        return float(j_m["loss"]), float(t_m["loss"])


@pytest.fixture(scope="module")
def pair(scene_dir):
    return _Pair(scene_dir)


def test_carried_state_matches(pair):
    s = pair.t_state
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(s.params[k].numpy(),
                                      np.asarray(pair.j_state.params[k]))
    assert s.opt_g["count"] == 0 and int(s.alive.sum()) == 80
    assert len(app_groups(s.app)["net"]) == 14


def test_one_step_matches_jax(pair):
    j_params0 = _np_tree(pair.j_state.params)
    j_loss, t_loss = pair.step(0)
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss), (t_loss, j_loss)
    j_mu, t_mu = _j_moments(pair.j_state), _t_moments(pair.t_state)
    rel = {k: _rel(t_mu[k], j_mu[k]) for k in j_mu}
    for k in j_mu:
        assert np.abs(j_mu[k]).max() > 0, k
        assert rel[k] < 1e-4, (k, rel[k])
    for k in PARAM_KEYS:
        g = j_mu[k]
        sure = np.abs(g) > 1e-2 * np.abs(g).max()
        moved = np.asarray(pair.j_state.params[k]) - j_params0[k]
        t_moved = pair.t_state.params[k].numpy() - j_params0[k]
        np.testing.assert_allclose(t_moved[sure], moved[sure], rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(pair.t_state.stats[k].numpy(),
                                   np.asarray(pair.j_state.stats[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_ten_steps_with_densify_match_jax(pair):
    # runs after test_one_step_matches_jax: steps 2..10, densify after 5
    densify = make_densify_step(pair.j_ocfg, pair.j_scene.extent)
    n_cams = len(pair.j_cams)
    for it in range(2, 11):
        j_loss, t_loss = pair.step(it % n_cams)
        if it == 5:
            key = jax.random.PRNGKey(9)
            k0, k1 = jax.random.split(key)
            noise = tuple(torch.from_numpy(np.array(
                jax.random.normal(k, (CAPACITY, 3)))) for k in (k0, k1))
            alive0 = int(pair.t_state.alive.sum())
            pair.j_state = densify(pair.j_state, key, False)
            pair.t_state = densify_impl(
                pair.t_state, None, pair.t_scene.extent, ocfg=pair.t_ocfg,
                prune_big=False, noise=noise)
            np.testing.assert_array_equal(pair.t_state.alive.numpy(),
                                          np.asarray(pair.j_state.alive))
            assert int(pair.t_state.alive.sum()) != alive0
    assert pair.t_state.opt_g["count"] == 10
    assert abs(t_loss - j_loss) <= 1e-4 * abs(j_loss), (t_loss, j_loss)


def test_cli_trains_on_the_cpu(scene_dir, tmp_path, monkeypatch):
    from pcp_tpu_torch.cli import train
    from pcp_tpu_torch.train import loop
    from pcp_tpu_torch.train.config import load_cfg_args

    # the JSONL log only: importing TensorBoard here costs a minute
    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))

    out = str(tmp_path / "out")
    state = train.main([
        "-s", scene_dir, "-m", out, "--device", "cpu", "--iterations", "30",
        "--save_iterations", "30", "--test_iterations", "30", "--eval",
        "--llffhold", "3", "--capacity", str(CAPACITY), "--max_per_tile",
        "128", "--densify_from_iter", "5", "--densification_interval", "10",
        "--opacity_reset_interval", "20", "--log_interval", "10", "--quiet"])
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_30",
                                       "point_cloud.ply"))
    assert int(state.alive.sum()) > 80          # densify ran
    assert state.opt_g["count"] == 30
    cfg = load_cfg_args(out)
    assert cfg.optim.iterations == 30 and cfg.pipeline.use_appearance
    assert os.path.exists(os.path.join(out, "eval_30.json"))
    logged = open(os.path.join(out, "train_log.jsonl")).read().splitlines()
    assert len(logged) >= 4


def test_cfg_args_load_across_packages(tmp_path):
    # a cfg_args.json written by the JAX package loads in the port
    j = jcfg.TrainRunConfig(optim=jcfg.OptimConfig(iterations=7,
                                                   max_per_tile=0))
    jcfg.save_cfg_args(str(tmp_path), j)
    t = tcfg.load_cfg_args(str(tmp_path))
    assert t.optim.iterations == 7 and t.optim.tile_clamp() == 1 << 30
    assert t.model == tcfg.ModelConfig()
