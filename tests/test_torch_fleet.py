"""The port's fleet (``pcp_tpu_torch.parallel.fleet``) on the CPU.

- Against JAX: two blocks whose cameras alternate between full and half
  resolution (``tests/test_mixed_sizes.py``'s pad-and-mask), appearance
  on, through JAX's ``make_fleet_step`` on a one-device mesh and the
  port's ``make_fleet_step`` from the same carried state, with
  ``share_appearance`` on and off: each block's loss within 1e-5 relative
  at every one of 3 steps, params and appearance leaves within 1e-4
  relative (max |port - jax| / max |jax| per leaf), and one appearance
  for both blocks when shared.
- Block independence, port against port: each block of a 4-block fleet
  equals the port's own single-block ``train_step_impl`` on the same
  cameras, bit for bit (JAX's key contract, ``tests/test_fleet.py``).
- The banked step (``--device_data``) equals the host-fed one, bit for
  bit, on mixed resolutions with a shared appearance.
- Block 0 of ``train_blocks_parallel`` without sharing writes
  ``train_scene``'s PLY bytes.
- Checkpoint and resume: stopped at iteration 40 of 60 with a rolling
  checkpoint every 20, the fleet resumes from the oldest block checkpoint,
  the progress records name it, and two resumes give the same bits.
- Masked L1 and SSIM equal their native-size values, and JAX's.
"""

import copy
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu_torch.models.gaussians import PARAM_KEYS
from pcp_tpu_torch.train import checkpoint as ckpt
from tests.synthetic import write_synthetic_scene

SH = 3
CAPACITY = 128
STEPS = 3


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("PCP_TENSORBOARD", "0")
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleetscene")
    write_synthetic_scene(str(d), np.random.default_rng(11), n_points=120,
                          n_cams=8)
    return str(d)


@pytest.fixture(scope="module")
def block_dirs(scene_dir, tmp_path_factory):
    """Two blocks (~37 points each) of the scene, partitioned."""
    from tests.torch_parallel_workers import partition_scene

    root = tmp_path_factory.mktemp("fb") / "s"
    shutil.copytree(scene_dir, root)
    visible = partition_scene(str(root))
    return [os.path.join(visible, b, f"partition_{b}")
            for b in sorted(os.listdir(visible))[:2]]


def _mixed(scene):
    """Every other camera declared at half resolution; the loaders resize
    its ground truth (loadCam semantics)."""
    for i, c in enumerate(scene.cameras):
        if i % 2 == 1:
            scene.cameras[i] = dataclasses.replace(
                c, width=c.width // 2, height=c.height // 2)
    return scene


def _t_cfg(**optim):
    from pcp_tpu_torch.train import config as tcfg

    kw = dict(capacity=CAPACITY, max_per_tile=128)
    kw.update(optim)
    return tcfg.TrainRunConfig(
        model=tcfg.ModelConfig(sh_degree=SH, resolution=1),
        optim=tcfg.OptimConfig(**kw),
        pipeline=tcfg.PipelineConfig(use_appearance=True),
        test_iterations=[], save_iterations=[])


def _perturb(params, alive, seed):
    """Seeded anisotropy, rotations and view-dependent colour on the live
    Gaussians (numpy, in place), as ``tests/test_torch_train.py`` gives
    them: the kNN init leaves those gradients at rounding noise."""
    rng = np.random.default_rng(seed)
    n = int(np.asarray(alive).sum())
    params["scaling"][:n] += rng.uniform(-0.4, 0.4, (n, 3)).astype(
        np.float32)
    params["rotation"][:n] = rng.normal(size=(n, 4)).astype(np.float32)
    params["f_rest"][:n] = rng.normal(
        0, 0.1, params["f_rest"][:n].shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("share", [False, True])
def test_fleet_step_matches_jax(scene_dir, share):
    from pcp_tpu.ops.projection import CameraIntrin as JIntrin
    from pcp_tpu.parallel.fleet import (
        block_mesh,
        make_fleet_step as j_make_fleet_step,
        pad_blocks,
        shard_fleet,
        unstack_state,
    )
    from pcp_tpu.scene import cameras as jcam
    from pcp_tpu.scene import load_colmap_scene as j_load
    from pcp_tpu.train import config as jcfg
    from pcp_tpu.train.loop import init_state as j_init_state
    from pcp_tpu_torch.models.appearance import net_tensors_from_flax
    from pcp_tpu_torch.parallel.fleet import (
        build_camera_bank,
        make_fleet_step,
    )
    from pcp_tpu_torch.scene import cameras as tcam
    from pcp_tpu_torch.scene import load_colmap_scene as t_load
    from pcp_tpu_torch.train.step import TrainState, train_state_from_numpy

    j_scene, t_scene = _mixed(j_load(scene_dir)), _mixed(t_load(scene_dir))
    j_cams = [jcam.from_info(i, 1) for i in j_scene.cameras]
    t_cams = [tcam.from_info(i, 1) for i in t_scene.cameras]
    frame = (max(c.width for c in j_cams), max(c.height for c in j_cams))
    assert len({(c.width, c.height) for c in j_cams}) == 2
    j_ocfg = jcfg.OptimConfig(capacity=CAPACITY, max_per_tile=128)
    cfg = jcfg.TrainRunConfig(
        model=jcfg.ModelConfig(sh_degree=SH), optim=j_ocfg,
        pipeline=jcfg.PipelineConfig(use_appearance=True))
    j_states = []
    for b in range(2):
        st = j_init_state(j_scene, cfg, frame, jax.random.PRNGKey(4 + b))
        p = jax.tree_util.tree_map(np.array, st.params)
        _perturb(p, st.alive, 12 + b)
        st = st._replace(params={k: jnp.asarray(v) for k, v in p.items()})
        if share and j_states:
            st = st._replace(app=j_states[0].app, opt_a=j_states[0].opt_a)
        j_states.append(st)
    t_states = []
    for st in j_states:
        s = jax.tree_util.tree_map(np.array, st)
        t_states.append(train_state_from_numpy(
            s.params, s.app, s.opt_g, s.opt_a, s.alive, s.stats,
            device="cpu"))
    shared = None
    if share:
        shared = TrainState({}, t_states[0].app, None, t_states[0].opt_a,
                            None, {})
        t_states[1].app, t_states[1].opt_a = shared.app, shared.opt_a

    mesh = block_mesh(1)
    extent = j_scene.extent
    fleet = shard_fleet(pad_blocks(j_states, [extent] * 2, 1), mesh)
    j_step = j_make_fleet_step(j_ocfg, frame, mesh, use_appearance=True,
                               share_appearance=share)
    t_step = make_fleet_step(_t_cfg().optim, frame, use_appearance=True,
                             share_appearance=share, n_blocks=2)
    (bank,) = build_camera_bank([t_cams], frame, torch.device("cpu"))
    bg = np.zeros(3, np.float32)
    for i in range(STEPS):
        idx = [i, i + 1]        # block 0 full, half, full; block 1 opposite
        chosen = [j_cams[k] for k in idx]
        gts = np.zeros((2, frame[1], frame[0], 3), np.float32)
        for b, c in enumerate(chosen):
            gts[b, :c.height, :c.width] = c.gt_image
        fleet, j_m = j_step(
            fleet, jnp.asarray(np.stack([c.viewmat for c in chosen])),
            JIntrin(fx=jnp.asarray([c.fx for c in chosen], jnp.float32),
                    fy=jnp.asarray([c.fy for c in chosen], jnp.float32),
                    cx=jnp.asarray([c.width / 2.0 for c in chosen],
                                   jnp.float32),
                    cy=jnp.asarray([c.height / 2.0 for c in chosen],
                                   jnp.float32)),
            jnp.asarray(gts), jnp.asarray([c.uid for c in chosen], jnp.int32),
            jnp.asarray([(c.width, c.height) for c in chosen], jnp.int32),
            jnp.asarray(bg), SH)
        views = [bank.view(k) for k in idx]
        t_m = t_step(t_states, [t_scene.extent] * 2, views,
                     torch.from_numpy(bg), SH, [0, 1], shared)
        for b in range(2):
            jl, tl = float(np.asarray(j_m["loss"])[b]), float(t_m[b]["loss"])
            assert abs(tl - jl) <= 1e-5 * abs(jl), (i, b, tl, jl)

    host = jax.device_get(fleet)
    for b in range(2):
        j_st, t_st = unstack_state(host.state, b), t_states[b]
        for k in PARAM_KEYS:
            assert _rel(t_st.params[k].numpy(), j_st.params[k]) < 1e-4, (b, k)
        assert _rel(t_st.app["embeddings"].numpy(),
                    j_st.app["embeddings"]) < 1e-4, b
        j_net = net_tensors_from_flax(jax.tree_util.tree_map(
            np.asarray, j_st.app["net"]), "cpu")
        for n, (t, j) in enumerate(zip(t_st.app["net"].parameters(), j_net)):
            assert _rel(t.detach().numpy(), j.numpy()) < 1e-4, (b, n)
    if share:
        assert t_states[0].app is t_states[1].app
        j0, j1 = unstack_state(host.state, 0), unstack_state(host.state, 1)
        np.testing.assert_array_equal(np.asarray(j0.app["embeddings"]),
                                      np.asarray(j1.app["embeddings"]))


def _clone(state):
    return copy.deepcopy(state)


def _leaves_equal(a, b):
    la, lb = ckpt.host_leaves(a), ckpt.host_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def test_fleet_blocks_are_independent(scene_dir):
    from pcp_tpu_torch.parallel.fleet import (
        build_camera_bank,
        make_fleet_step,
    )
    from pcp_tpu_torch.scene import cameras as tcam
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.loop import init_state
    from pcp_tpu_torch.train.step import train_step_impl

    scene = load_colmap_scene(scene_dir)
    cams = [tcam.from_info(i, 1) for i in scene.cameras]
    frame = (cams[0].width, cams[0].height)
    cfg = _t_cfg()
    states = [init_state(scene, cfg, torch.Generator().manual_seed(b), "cpu")
              for b in range(4)]
    singles = [_clone(s) for s in states]
    step = make_fleet_step(cfg.optim, frame, use_appearance=True)
    cpu = torch.device("cpu")
    (bank,) = build_camera_bank([cams], frame, cpu)
    bg = torch.zeros(3)
    for i in range(STEPS):
        order = [(i + b) % 4 for b in range(4)]
        step(states, [scene.extent] * 4,
             [bank.view(k) for k in order], bg, SH,
             range(4))
        for b, k in enumerate(order):
            vm, intr = tcam.camera_tensors(cams[k], cpu)
            train_step_impl(singles[b], vm, intr,
                            torch.from_numpy(cams[k].gt_image), cams[k].uid,
                            bg, scene.extent, ocfg=cfg.optim,
                            image_size=frame, sh_degree=SH,
                            use_appearance=True)
    for b in range(4):
        _leaves_equal(states[b], singles[b])


def test_banked_equals_host_fed(scene_dir):
    from pcp_tpu_torch.parallel.fleet import train_blocks_parallel
    from pcp_tpu_torch.scene import load_colmap_scene

    scenes = [_mixed(load_colmap_scene(scene_dir)) for _ in range(2)]
    cfg = _t_cfg(iterations=6, densify_from_iter=2,
                 densification_interval=3)
    cfg.pipeline.share_appearance = True
    runs = [train_blocks_parallel(scenes, cfg, log_fn=None, seed=3,
                                  device_data=dd, device="cpu")
            for dd in (False, True)]
    for a, b in zip(*runs):
        _leaves_equal(a, b)
    assert runs[0][0].app is runs[0][1].app
    assert runs[0][0].opt_a["count"] == 6


def test_block0_equals_train_scene(scene_dir, tmp_path):
    from pcp_tpu_torch.parallel.fleet import train_blocks_parallel
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.loop import save_model, train_scene

    scene = load_colmap_scene(scene_dir)
    cfg = _t_cfg(iterations=12, densify_from_iter=5,
                 densification_interval=5)
    cfg.model.model_path = str(tmp_path / "single")
    alone = train_scene(scene, cfg, log_fn=None, device="cpu")
    assert int(alone.alive.sum()) != 120          # the densify ran
    states = train_blocks_parallel(
        [scene, load_colmap_scene(scene_dir)], cfg, log_fn=None,
        seed=cfg.seed, block_dirs=[str(tmp_path / "b0"),
                                   str(tmp_path / "b1")], device="cpu")
    path = save_model(states[0], str(tmp_path / "b0"), 12, "point_cloud")
    single = tmp_path / "single" / "point_cloud" / "iteration_12"
    assert open(path, "rb").read() == (single / "point_cloud.ply").read_bytes()
    # block 1 draws from seed + 17: another block
    assert not torch.equal(states[1].params["xyz"], states[0].params["xyz"])


def test_fleet_checkpoint_and_resume(block_dirs, tmp_path):
    from pcp_tpu_torch.parallel.fleet import (
        FLEET_CKPT_NAME,
        train_blocks_parallel,
    )
    from pcp_tpu_torch.scene import load_colmap_scene

    scenes = [load_colmap_scene(d) for d in block_dirs]
    cfg = _t_cfg(iterations=60, densify_from_iter=5,
                 densification_interval=10)
    cfg.pipeline.share_appearance = True
    first = [str(tmp_path / "first" / f"b{b}") for b in range(2)]
    progress = []
    train_blocks_parallel(
        scenes, cfg, iterations=40, log_fn=None, block_dirs=first,
        block_ids=["b0", "b1"], checkpoint_interval=20, device="cpu",
        progress_fn=lambda bid, **kw: progress.append((bid, kw)))
    assert progress == [(b, {"status": "running", "ckpt_iter": it})
                        for it in (20, 40) for b in ("b0", "b1")]
    for d in first:
        assert ckpt.load(os.path.join(d, FLEET_CKPT_NAME),
                         _clone_template(scenes[0], cfg))[1] == 40
    resumed = []
    for run in ("a", "b"):
        dirs = [str(tmp_path / run / f"b{b}") for b in range(2)]
        for src, dst in zip(first, dirs):
            shutil.copytree(src, dst)
        logged = []
        states = train_blocks_parallel(
            scenes, cfg, log_fn=logged.append, block_dirs=dirs,
            checkpoint_interval=20, resume=True, device="cpu")
        assert any("resuming from iteration 40" in m for m in logged)
        resumed.append(states)
    for a, b in zip(*resumed):
        _leaves_equal(a, b)
        assert a.opt_g["count"] == 60
    # the oldest block checkpoint sets the restart
    older = str(tmp_path / "older")
    shutil.copytree(str(tmp_path / "first"), older)
    st, _ = ckpt.load(os.path.join(first[1], FLEET_CKPT_NAME),
                      _clone_template(scenes[0], cfg))
    ckpt.save(os.path.join(older, "b1", FLEET_CKPT_NAME), st, 20)
    logged = []
    train_blocks_parallel(
        scenes, cfg, iterations=21, log_fn=logged.append,
        block_dirs=[os.path.join(older, f"b{b}") for b in range(2)],
        resume=True, device="cpu")
    assert any("resuming from iteration 20" in m for m in logged), logged


def _clone_template(scene, cfg):
    from pcp_tpu_torch.train.loop import init_state

    return init_state(scene, cfg, torch.Generator().manual_seed(0), "cpu")


def test_masked_losses_match_native_and_jax():
    from pcp_tpu.utils.loss import l1_loss as j_l1
    from pcp_tpu.utils.loss import ssim as j_ssim
    from pcp_tpu_torch.train.step import valid_mask
    from pcp_tpu_torch.utils.loss import l1_loss, ssim

    rng = np.random.default_rng(0)
    h, w, hp, wp = 24, 32, 40, 48
    a = rng.uniform(size=(h, w, 3)).astype(np.float32)
    b = rng.uniform(size=(h, w, 3)).astype(np.float32)
    ap, bp = (np.zeros((hp, wp, 3), np.float32) for _ in range(2))
    ap[:h, :w], bp[:h, :w] = a, b
    mask = valid_mask((w, h), (wp, hp), torch.device("cpu"))
    t = torch.from_numpy
    chw = lambda x: x.permute(2, 0, 1)  # noqa: E731
    l1_m, l1_n = float(l1_loss(t(ap), t(bp), mask)), float(l1_loss(t(a), t(b)))
    s_m = float(ssim(chw(t(ap)), chw(t(bp)), valid_mask=mask))
    s_n = float(ssim(chw(t(a)), chw(t(b))))
    np.testing.assert_allclose(l1_m, l1_n, rtol=1e-6)
    np.testing.assert_allclose(s_m, s_n, rtol=1e-5)
    j_mask = jnp.asarray(mask.numpy())
    jchw = lambda x: jnp.transpose(jnp.asarray(x), (2, 0, 1))  # noqa: E731
    np.testing.assert_allclose(
        l1_m, float(j_l1(jnp.asarray(ap), jnp.asarray(bp), j_mask)),
        rtol=1e-6)
    np.testing.assert_allclose(
        s_m, float(j_ssim(jchw(ap), jchw(bp), valid_mask=j_mask)), rtol=1e-5)
