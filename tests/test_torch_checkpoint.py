"""The port's checkpoints, resume, ``--debug`` dump, profile trace and
``app_map_scale`` against the JAX package, on the ``tests/synthetic.py``
scene on the CPU.

Resume parity: the same start state (a JAX ``init_state`` carried across
with ``train_state_from_numpy``) resumes at iteration K in JAX's
``train_scene(state=..., start_iter=K)`` and in the port's ``cli.train
--start_checkpoint`` from a ``chkpnt<K>.pth`` of it. Both loops restart the
camera shuffle from the seed, so the view uids must be identical; the
losses of every step must agree within 1e-4 relative (the tenth-step
tolerance of ``tests/test_torch_train.py``). The window ends on a densify
(after the last step's loss), whose split noise comes from each package's
own generator: the noise moves the split children, not the alive count,
which must agree.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.models import appearance as japp
from pcp_tpu.scene import load_colmap_scene as j_load
from pcp_tpu.train import config as jcfg
from pcp_tpu.train import loop as jloop
from pcp_tpu_torch.models import appearance as tapp
from pcp_tpu_torch.scene import load_colmap_scene as t_load
from pcp_tpu_torch.train import checkpoint as ckpt
from pcp_tpu_torch.train import config as tcfg
from pcp_tpu_torch.train import loop as tloop
from pcp_tpu_torch.train.step import train_state_from_numpy
from tests.synthetic import write_synthetic_scene

CAPACITY = 256
K = 20           # the resumed checkpoint's iteration
END = 30         # densify at 30 (> DENSIFY_FROM, every 10), after its loss
DENSIFY_FROM = 20
PORT_STEP = tloop.train_step_impl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers, and a multithreaded CPU torch then
    # oversubscribes the cores (a step of these small scenes waits on idle
    # threads); one thread runs them about as fast as eight do alone.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    write_synthetic_scene(str(d), np.random.default_rng(3), n_points=80,
                          n_cams=6)
    return str(d)


@pytest.fixture(autouse=True, scope="module")
def _jsonl_only():
    # both loops log to JSONL only: importing TensorBoard costs a minute
    import pcp_tpu.train.logging as jlog

    real = tloop.TrainLogger, jlog.TrainLogger
    tloop.TrainLogger = functools.partial(real[0], use_tensorboard=False)
    jlog.TrainLogger = functools.partial(real[1], use_tensorboard=False)
    yield
    tloop.TrainLogger, jlog.TrainLogger = real


def _np_tree(x):
    return jax.tree_util.tree_map(np.array, x)


def _flags(scene_dir, out, *extra):
    return ["-s", scene_dir, "-m", str(out), "--device", "cpu",
            "--capacity", str(CAPACITY), "--max_per_tile", "128",
            "--resolution", "1", "--densify_from_iter", str(DENSIFY_FROM),
            "--densification_interval", "10",
            "--opacity_reset_interval", "100000",
            "--test_iterations", "0", "--save_iterations", "0",
            "--log_interval", "1", "--quiet", *extra]


def _record_port_steps(monkeypatch):
    """(uid, loss) of every port step."""
    seen = []

    def spy(state, viewmat, intrin, gt, uid, *a, **kw):
        state, m = PORT_STEP(state, viewmat, intrin, gt, uid, *a, **kw)
        seen.append((int(uid), float(m["loss"])))
        return state, m

    monkeypatch.setattr(tloop, "train_step_impl", spy)
    return seen


def _port_state(scene_dir):
    """A port TrainState after two CLI steps and a densify: nonzero Adam
    moments and counts, densify stats and appearance weights."""
    from pcp_tpu_torch.cli import train

    return train.main(["-s", scene_dir, "-m", os.path.join(
        scene_dir, "_ckpt_state"), "--device", "cpu", "--iterations", "3",
        "--capacity", str(CAPACITY), "--max_per_tile", "128",
        "--densify_from_iter", "1", "--densification_interval", "2",
        "--test_iterations", "0", "--save_iterations", "0", "--quiet"])


def test_round_trip_is_bit_for_bit(scene_dir, tmp_path):
    state = _port_state(scene_dir)
    assert state.opt_g["count"] == 3 and state.opt_a["count"] == 3
    assert float(state.stats["denom"].sum()) > 0
    path = str(tmp_path / "chkpnt3.pth")
    ckpt.save(path, state, 3)

    cfg = tcfg.TrainRunConfig(optim=tcfg.OptimConfig(capacity=CAPACITY))
    template = tloop.init_state(t_load(scene_dir), cfg,
                                torch.Generator().manual_seed(7), "cpu")
    loaded, it = ckpt.load(path, template)
    assert it == 3
    before, after = ckpt.leaves(state), ckpt.leaves(loaded)
    assert len(before) == len(after) == 69
    for a, b in zip(before, after):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b == 3
    assert loaded.opt_a["count"] == 3
    assert torch.equal(loaded.stats["grad_accum"],
                       state.stats["grad_accum"])
    for p, q in zip(loaded.app["net"].parameters(),
                    state.app["net"].parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("change,words", [
    ({"capacity": 2 * CAPACITY}, "capacity or model config mismatch"),
    ({"use_appearance": False},
     "different capacity or use_appearance setting"),
])
def test_load_rejects_another_config(scene_dir, tmp_path, change, words):
    state = tloop.init_state(
        t_load(scene_dir),
        tcfg.TrainRunConfig(optim=tcfg.OptimConfig(capacity=CAPACITY)),
        torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "chkpnt1.pth")
    ckpt.save(path, state, 1)
    cfg = tcfg.TrainRunConfig(
        optim=tcfg.OptimConfig(capacity=change.get("capacity", CAPACITY)),
        pipeline=tcfg.PipelineConfig(
            use_appearance=change.get("use_appearance", True)))
    template = tloop.init_state(t_load(scene_dir), cfg,
                                torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=words):
        ckpt.load(path, template)


@pytest.fixture(scope="module")
def start(scene_dir, tmp_path_factory):
    """JAX's start state and a port checkpoint of the same numbers."""
    j_scene = j_load(scene_dir)
    cfg = jcfg.TrainRunConfig(optim=jcfg.OptimConfig(capacity=CAPACITY,
                                                     max_per_tile=128))
    cam = j_scene.cameras[0]
    j_state = jloop.init_state(j_scene, cfg, (cam.width, cam.height),
                               jax.random.PRNGKey(4))
    s = _np_tree(j_state)
    t_state = train_state_from_numpy(s.params, s.app, s.opt_g, s.opt_a,
                                     s.alive, s.stats, device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / f"chkpnt{K}.pth")
    ckpt.save(path, t_state, K)
    return s, path


def _j_state(np_state):
    """JAX's step donates its state: a fresh device copy for each run."""
    return jax.tree_util.tree_map(jnp.asarray, np_state)


@pytest.fixture(scope="module")
def jax_resume(scene_dir, start, tmp_path_factory):
    """JAX's train_scene resumed at K: (uid, loss) per step, final alive."""
    seen = []
    real = jloop.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def run(state, viewmat, intrin, gt, uid, *rest):
            state, m = step(state, viewmat, intrin, gt, uid, *rest)
            seen.append((int(uid), float(m["loss"])))
            return state, m
        return run

    cfg = jcfg.TrainRunConfig(
        model=jcfg.ModelConfig(model_path=str(tmp_path_factory.mktemp("j")),
                               resolution=1),
        optim=jcfg.OptimConfig(
            iterations=END, capacity=CAPACITY, max_per_tile=128,
            densify_from_iter=DENSIFY_FROM, densification_interval=10,
            opacity_reset_interval=100000),
        test_iterations=[], save_iterations=[])
    jloop.make_train_step = make
    try:
        final = jloop.train_scene(j_load(scene_dir), cfg, log_fn=None,
                                  state=_j_state(start[0]), start_iter=K)
    finally:
        jloop.make_train_step = real
    return seen, int(np.asarray(final.alive).sum())


def test_resume_matches_jax(scene_dir, start, jax_resume, tmp_path,
                            monkeypatch):
    from pcp_tpu_torch.cli import train

    j_seen, j_alive = jax_resume
    seen = _record_port_steps(monkeypatch)
    state = train.main(_flags(scene_dir, tmp_path / "out", "--iterations",
                              str(END), "--start_checkpoint", start[1]))
    assert len(seen) == len(j_seen) == END - K
    assert [u for u, _ in seen] == [u for u, _ in j_seen]
    for (_, t), (_, j) in zip(seen, j_seen):
        assert abs(t - j) <= 1e-4 * abs(j), (t, j)
    assert state.opt_g["count"] == END - K
    assert int(state.alive.sum()) == j_alive != 80   # the densify ran


def test_two_resumes_give_the_same_bits(scene_dir, start, tmp_path,
                                        monkeypatch):
    from pcp_tpu_torch.cli import train

    runs = []
    for name in ("a", "b"):
        seen = _record_port_steps(monkeypatch)
        out = tmp_path / name
        train.main(_flags(scene_dir, out, "--iterations", str(END),
                          "--start_checkpoint", start[1],
                          "--checkpoint_iterations", str(END)))
        ply = out / "point_cloud" / f"iteration_{END}" / "point_cloud.ply"
        runs.append((seen, ply.read_bytes(),
                     ckpt.leaves(_template_loaded(
                         scene_dir, str(out / f"chkpnt{END}.pth")))))
    (seen_a, ply_a, leaves_a), (seen_b, ply_b, leaves_b) = runs
    assert seen_a == seen_b and ply_a == ply_b
    for a, b in zip(leaves_a, leaves_b):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _template(scene_dir):
    cfg = tcfg.TrainRunConfig(optim=tcfg.OptimConfig(capacity=CAPACITY))
    return tloop.init_state(t_load(scene_dir), cfg,
                            torch.Generator().manual_seed(0), "cpu")


def test_debug_dump_has_jax_keys(scene_dir, start, tmp_path, monkeypatch):
    """A forced NaN loss: both loops dump the step's inputs under the same
    keys and raise FloatingPointError."""
    from pcp_tpu_torch.cli import train

    real_j = jloop.make_train_step

    def make_nan(*a, **kw):
        step = real_j(*a, **kw)
        return lambda *args: (lambda s, m: (s, {**m, "loss": jnp.nan}))(
            *step(*args))

    j_out = tmp_path / "j"
    cfg = jcfg.TrainRunConfig(
        model=jcfg.ModelConfig(model_path=str(j_out), resolution=1),
        optim=jcfg.OptimConfig(iterations=K + 1, capacity=CAPACITY,
                               max_per_tile=128),
        test_iterations=[], save_iterations=[])
    monkeypatch.setattr(jloop, "make_train_step", make_nan)
    with pytest.raises(FloatingPointError):
        jloop.train_scene(j_load(scene_dir), cfg, log_fn=None,
                          state=_j_state(start[0]), start_iter=K, debug=True)

    def step_nan(*a, **kw):
        s, m = PORT_STEP(*a, **kw)
        return s, {**m, "loss": torch.tensor(float("nan"))}

    monkeypatch.setattr(tloop, "train_step_impl", step_nan)
    t_out = tmp_path / "t"
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train.main(_flags(scene_dir, t_out, "--iterations", str(K + 1),
                          "--start_checkpoint", start[1], "--debug"))
    name = f"nan_snapshot_{K + 1}.npz"
    j_dump, t_dump = np.load(j_out / name), np.load(t_out / name)
    assert sorted(t_dump.files) == sorted(j_dump.files)
    assert int(t_dump["iteration"]) == K + 1
    assert int(t_dump["view_uid"]) == int(j_dump["view_uid"])
    np.testing.assert_array_equal(t_dump["gt_image"], j_dump["gt_image"])
    np.testing.assert_array_equal(t_dump["intrin"], j_dump["intrin"])
    # the pre-step state: the checkpoint's leaves
    for i, leaf in enumerate(ckpt.host_leaves(_template_loaded(scene_dir,
                                                                start[1]))):
        np.testing.assert_array_equal(t_dump[f"state_leaf_{i}"], leaf)


def _template_loaded(scene_dir, path):
    return ckpt.load(path, _template(scene_dir))[0]


def test_profile_writes_a_trace(scene_dir, tmp_path):
    cfg = tcfg.TrainRunConfig(
        model=tcfg.ModelConfig(model_path=str(tmp_path), resolution=1),
        optim=tcfg.OptimConfig(iterations=2, capacity=CAPACITY,
                               max_per_tile=128),
        test_iterations=[], save_iterations=[])
    tloop.train_scene(t_load(scene_dir), cfg, log_fn=None, profile=True,
                      device="cpu")
    traces = os.listdir(tmp_path / "trace")
    assert traces and all(t.endswith(".json") for t in traces)
    assert (tmp_path / "point_cloud" / "iteration_2" /
            "point_cloud.ply").exists()


def test_app_map_scale_two_matches_jax(monkeypatch):
    """The map scale * sigmoid(x) (JAX's PCP_APP_MAP_SCALE) at 2: the same
    decoupled image and map within 1e-5."""
    flax_app = jax.tree_util.tree_map(
        np.asarray, japp.init_appearance(jax.random.PRNGKey(3), (64, 48),
                                         num_embeddings=16))
    rng = np.random.default_rng(2)
    image = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    monkeypatch.setattr(japp, "APP_MAP_SCALE", 2.0)
    j_out, j_map = japp.decouple_appearance(
        jnp.asarray(image), jax.tree_util.tree_map(jnp.asarray, flax_app), 5)
    app = tapp.appearance_from_flax(flax_app, "cpu", map_scale=2.0)
    with torch.no_grad():
        out, mapping = tapp.decouple_appearance(torch.tensor(image), app, 5)
    assert float(mapping.max()) > 1.0          # the widened range is used
    np.testing.assert_allclose(mapping.numpy(), np.asarray(j_map), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)


def test_app_map_scale_comes_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("PCP_APP_MAP_SCALE", "2")
    cfg = tcfg.TrainRunConfig()
    assert cfg.pipeline.app_map_scale == 2.0
    tcfg.save_cfg_args(str(tmp_path), cfg)
    monkeypatch.delenv("PCP_APP_MAP_SCALE")
    with pytest.warns(UserWarning, match="app_map_scale=2.0"):
        loaded = tcfg.load_cfg_args(str(tmp_path))
    assert loaded.pipeline.app_map_scale == 2.0
    state = tloop.init_state(
        _scene_of_points(), tcfg.TrainRunConfig(
            optim=tcfg.OptimConfig(capacity=16),
            pipeline=loaded.pipeline),
        torch.Generator().manual_seed(0), "cpu")
    assert state.app["net"].map_scale == 2.0


def _scene_of_points():
    from pcp_tpu_torch.scene import SceneInfo

    rng = np.random.default_rng(0)
    return SceneInfo(cameras=[], points=rng.normal(size=(8, 3)).astype(
        np.float32), colors=rng.uniform(size=(8, 3)).astype(np.float32),
        extent=1.0)
