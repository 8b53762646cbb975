"""The port's measurement tools (``pcp_tpu_torch.bench``,
``pcp_tpu_torch.tools.{bench_scene,step_bench,roofline,profile_stages,
partition_bench}``) against the JAX package's, on the CPU.

The bench scene and the partition scene make the JAX tools' numpy draws in
their order, so one seed gives the same arrays: positions and opacity
logits bit for bit, the rest within 1e-6. The first train step on the bench
scene agrees with JAX's at the tolerances of ``tests/test_torch_train.py``
(the loss to 1e-5 relative, the image to 3e-5). The scene is cut to 2000
Gaussians in 4096 slots at 160x120 (fx 140: the bench's 800x600 field of
view); its splats are wide (28 px sigma at 2000 live), so a tile holds up to
~1260 of them.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.bench_scene as j_bench_scene
import tools.partition_bench as j_partition_bench
from pcp_tpu.models import gaussians as JG
from pcp_tpu.models.appearance import init_appearance as j_init_appearance
from pcp_tpu.ops import binning as j_binning
from pcp_tpu.train import optim as j_optim
from pcp_tpu.train.config import OptimConfig as JOptimConfig
from pcp_tpu.train.step import TrainState as JTrainState
from pcp_tpu.train.step import make_train_step
from pcp_tpu.train.step import render_gaussians as j_render
from pcp_tpu_torch import bench
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.models.appearance import appearance_from_flax
from pcp_tpu_torch.tools import (
    bench_scene,
    partition_bench,
    profile_stages,
    roofline,
    step_bench,
)
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.train.step import (
    TrainState,
    app_groups,
    render_gaussians,
    train_step_impl,
)

ROOT = Path(__file__).resolve().parent.parent
N, CAPACITY = 2000, 4096
W, H, FX = 160, 120, 140.0
SMALL = dict(n_points=N, capacity=CAPACITY, width=W, height=H, fx=FX)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # parallel test workers: a multithreaded CPU torch oversubscribes the
    # cores (a step of these small scenes waits on idle threads)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_scene(monkeypatch, n, capacity, width, height, fx, seed=0):
    monkeypatch.setattr(j_bench_scene, "W", width)
    monkeypatch.setattr(j_bench_scene, "H", height)
    monkeypatch.setattr(j_bench_scene, "FX", fx)
    monkeypatch.setattr(j_bench_scene, "FY", fx)
    rng = np.random.default_rng(seed)
    params, alive = j_bench_scene.make_scene(rng, n_points=n,
                                             capacity=capacity)
    return rng, {k: np.asarray(v) for k, v in params.items()}, \
        np.asarray(alive)


@pytest.mark.parametrize("geometry", [(800, 600, 700.0), (W, H, FX)])
def test_bench_scene_matches_jax(monkeypatch, geometry):
    width, height, fx = geometry
    _, j_params, j_alive = _jax_scene(monkeypatch, N, CAPACITY, width,
                                      height, fx)
    params, alive = bench_scene.make_scene(
        np.random.default_rng(0), N, CAPACITY, width, height, fx, "cpu")
    np.testing.assert_array_equal(alive.numpy(), j_alive)
    assert int(alive.sum()) == N
    for k in ("xyz", "opacity"):
        np.testing.assert_array_equal(params[k].numpy(), j_params[k],
                                      err_msg=k)
    for k in G.PARAM_KEYS:
        np.testing.assert_allclose(params[k].numpy(), j_params[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    dead = ~alive.numpy()
    assert (params["scaling"].numpy()[dead] == -10.0).all()
    assert (params["opacity"].numpy()[dead] == -10.0).all()


@pytest.mark.parametrize("n", [100_000, 500_000, 719_802, 1_000_000])
def test_capacity_rule_is_the_jax_tools(n):
    # tools/bench_scene.py: CAPACITY (2^17) at N_POINTS, else this formula
    jax_rule = (j_bench_scene.CAPACITY if n == j_bench_scene.N_POINTS
                else 1 << max(17, int(np.ceil(np.log2(n * 1.31)))))
    assert bench_scene.capacity_for(n) == jax_rule


@pytest.fixture(scope="module")
def first_step():
    """The first train step of the small bench scene through both packages:
    JAX's built as tools/step_bench.py builds it, with max_per_tile above
    the port's measured maximum tile load and room for every pair, so that
    neither package clamps or drops a pair; the binning is JAX's v1 (its
    v2 class tables cap wide footprints at a share of the slots, and every
    splat here is wide). Both start from the same appearance net."""
    mp = pytest.MonkeyPatch()
    try:
        rng, j_params, j_alive = _jax_scene(mp, N, CAPACITY, W, H, FX)
        gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        j_app = j_init_appearance(jax.random.PRNGKey(0), (W, H))

        params, alive = bench_scene.make_scene(
            np.random.default_rng(0), N, CAPACITY, W, H, FX, "cpu")
        app = appearance_from_flax(j_app, "cpu")
        state = TrainState(params, app, optim.init_adam(params),
                           optim.init_adam(app_groups(app)), alive,
                           G.init_densify_stats(CAPACITY, "cpu"))
        viewmat, intrin = bench_scene.camera(W, H, FX, "cpu")
        bg = torch.zeros(3)
        with torch.no_grad():
            image, _ = render_gaussians(params, alive, viewmat, intrin,
                                        (W, H), bg, 3, max_per_tile=1 << 30,
                                        device="cpu")
        _, m = train_step_impl(
            state, viewmat, intrin, torch.from_numpy(gt), 0, bg,
            bench.EXTENT, ocfg=OptimConfig(capacity=CAPACITY, max_per_tile=0),
            image_size=(W, H), sh_degree=3, use_appearance=True)

        k = -(-int(m["max_tile_load"]) // 128) * 128
        ppg = -(-m["n_pairs"] // CAPACITY) + 1
        mp.setattr(j_binning, "BINNING_VERSION", "v1")
        j_params = {k2: jnp.asarray(v) for k2, v in j_params.items()}
        j_view, j_intrin = j_bench_scene.camera()
        j_image, _ = jax.jit(lambda p: j_render(
            p, j_alive, j_view, j_intrin, (W, H), jnp.zeros(3), 3,
            max_per_tile=k, max_pairs=ppg * CAPACITY))(j_params)
        j_state = JTrainState(
            params=j_params, app=j_app, opt_g=j_optim.init_adam(j_params),
            opt_a=j_optim.init_adam(j_app), alive=jnp.asarray(j_alive),
            stats=JG.init_densify_stats(CAPACITY))
        j_step = make_train_step(
            JOptimConfig(capacity=CAPACITY, max_per_tile=k,
                         pairs_per_gaussian=ppg), (W, H), bench.EXTENT,
            use_appearance=True)
        _, j_m = j_step(j_state, j_view, j_intrin, jnp.asarray(gt),
                        jnp.int32(0), jnp.zeros(3), 3)
        j_m = {k2: np.asarray(v) for k2, v in j_m.items()}
    finally:
        mp.undo()
    return {"image": image.numpy(), "j_image": np.asarray(j_image),
            "m": m, "j_m": j_m}


def test_first_step_loss_matches_jax(first_step):
    m, j_m = first_step["m"], first_step["j_m"]
    assert m["n_dropped"] == 0 and int(j_m["n_dropped"]) == 0
    assert m["n_pairs"] == int(j_m["n_pairs"])
    assert int(m["max_tile_load"]) == int(j_m["max_tile_load"]) > 1000
    assert not bool(m["tile_saturated"]) and not bool(j_m["tile_saturated"])
    loss, j_loss = float(m["loss"]), float(j_m["loss"])
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss), (loss, j_loss)


def test_first_step_image_matches_jax(first_step):
    np.testing.assert_allclose(first_step["image"], first_step["j_image"],
                               rtol=0, atol=3e-5)


def _roofline_ok(r):
    assert 0 < r["speed_of_light_ms"] and 0 < r["sol_fraction"] <= 1.0
    assert r["kernel_work"] == "walked samples"
    assert set(r["stage_ideal_ms"]) == {
        "preprocess", "binning", "composite_fwd", "appearance + loss",
        "composite_bwd", "segment_sum", "densify stats + adam",
        "preprocess backward", "appearance + loss backward"}


@pytest.fixture(scope="module")
def small_point():
    """``bench.run_point`` on the CPU at the small scene: 1 + 2 steps."""
    return bench.run_point(warmup=1, iters=2, device="cpu", **SMALL)


def test_run_point_on_the_cpu(small_point):
    ips, h = small_point
    assert ips > 0
    assert {k: h[k] for k in ("n_live", "capacity", "n_dropped", "overflow",
                              "tile_saturated")} == {
        "n_live": N, "capacity": CAPACITY, "n_dropped": 0,
        "overflow": False, "tile_saturated": False}
    assert h["max_tile_load"] > 1000 and h["n_pairs"] > 80_000
    assert h["breakdown"] is None
    _roofline_ok(h["roofline"])
    assert "stage_share" not in h["roofline"]


def test_bench_main_on_the_cpu(small_point, monkeypatch, capsys):
    """``python -m pcp_tpu_torch.bench --device cpu`` prints bench.py's keys
    and asks ``run_point`` for the canonical point with the breakdown, then
    the sweep (500k and 1M at 800x600, the reference-scale point); each
    point here is ``small_point``'s (a step at 1M live takes minutes on the
    CPU), the breakdown ``stage_breakdown`` of a small step."""
    calls = []

    def run_point(**kw):
        calls.append(kw)
        ips, h = small_point
        bd = (profile_stages.stage_breakdown(_tiny_step, kw["breakdown_reps"])
              if kw.get("breakdown_reps") else None)
        return ips, dict(h, breakdown=bd)

    monkeypatch.setattr(bench, "run_point", run_point)
    monkeypatch.delenv("PCP_BENCH_SWEEP", raising=False)
    monkeypatch.delenv("PCP_BENCH_BREAKDOWN", raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(r) == {
        "metric", "value", "unit", "vs_baseline", "pairs_per_sec", "n_pairs",
        "max_tile_load", "overflow", "tile_saturated", "n_dropped",
        "roofline", "geometry", "scale_sweep", "breakdown",
        "device_busy_ms", "device_idle_share", "peak_memory_bytes",
        "device"}
    ips, h = small_point
    assert r["metric"] == "train_iters_per_sec_100k_gauss_800x600"
    assert r["value"] == ips and r["vs_baseline"] == ips / 20.0
    assert r["pairs_per_sec"] == h["n_pairs"] * ips
    assert not r["overflow"] and not r["tile_saturated"]
    assert r["n_dropped"] == 0 and r["device"] == "cpu"
    assert r["breakdown"]["step_ms"] > 0
    assert r["device_busy_ms"] is None and r["peak_memory_bytes"] is None
    assert [(c["n_points"], c["width"], c["height"]) for c in calls] == [
        (100_000, 800, 600), (500_000, 800, 600), (1_000_000, 800, 600),
        (719_802, 1280, 800)]
    assert calls[0]["breakdown_reps"] == bench.BREAKDOWN_REPS
    assert calls[-1]["capacity"] == 1 << 21 and calls[-1]["fx"] == 850.0
    assert [p["width"] for p in r["scale_sweep"]] == [800, 800, 1280]
    assert all("breakdown" not in p and p["iters_per_sec"] == ips
               for p in r["scale_sweep"])

    monkeypatch.setenv("PCP_BENCH_SWEEP", "0")
    monkeypatch.setenv("PCP_BENCH_BREAKDOWN", "0")
    assert bench.main(["--device", "cpu"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["scale_sweep"] == [] and r["breakdown"] is None
    assert calls[-1]["breakdown_reps"] == 0


def _tiny_step():
    x = torch.ones(64, 64)
    return None, {"n_pairs": int((x @ x).sum() > 0)}


def test_stage_breakdown_on_the_cpu():
    """The breakdown's timing on the CPU: the warm steps are timed, and no
    device time is claimed where the profiler saw no card."""
    bd = profile_stages.stage_breakdown(_tiny_step, 4)
    assert len(bd["step_ms_all"]) == 4 and bd["step_ms"] > 0
    assert bd["n_pairs"] == 1 and bd["profiled_steps"] == 3
    for k in ("stage_device_ms", "device_busy_ms", "device_idle_share",
              "peak_memory_bytes", "device_launches_per_step"):
        assert bd[k] is None, k


def test_step_bench_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, "CANONICAL", dict(SMALL))
    monkeypatch.setattr(step_bench, "WARMUP", 1)
    monkeypatch.setattr(step_bench, "ITERS", 2)
    assert step_bench.main(["--device", "cpu"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(r) == {"step_ms", "iters_per_sec", "n_pairs", "max_tile_load",
                      "overflow", "n_dropped", "tile_saturated",
                      "max_per_tile", "binning"}
    assert r["binning"] == "exact" and r["max_per_tile"] == 0
    assert r["n_dropped"] == 0 and not r["overflow"]
    assert not r["tile_saturated"] and r["max_tile_load"] > 1000
    assert r["step_ms"] == pytest.approx(1e3 / r["iters_per_sec"])


def test_roofline_segment_sum_and_sol_fraction():
    """B3's bytes at phase 9's geometry (1,885,275 pairs in 2^20 slots,
    1280x800) are PERF.md's formula; ``sol_fraction`` is the step's ideal
    over the measured step; each range's share is its stages' ideals over
    its time, the two backward ideals over the rest's."""
    pairs, n = 1_885_275, 1 << 20
    kw = dict(capacity=n, n_pairs=pairs, width=1280, height=800, sh_degree=3)
    b = roofline.budget(**kw)
    seg = b["stages"]["segment_sum"]
    assert seg["MB"] * 1e6 == 36 * pairs + 8 * pairs + 4 * (n + 1) + 36 * n
    assert seg["bound_by"] == "bytes"
    assert seg["ideal_ms"] == pytest.approx(seg["MB"] * 1e6 / 3.35e12 * 1e3)
    assert b["speed_of_light_ms"] == pytest.approx(
        sum(v["ideal_ms"] for v in b["stages"].values()))
    assert b["kernel_work"] == "byte floor"

    stage_ms = {k: 1.0 for k in profile_stages.STAGES}
    stage_ms[profile_stages.REST] = 20.0
    r = roofline.summarize(47.383, stage_ms=stage_ms, **kw)
    assert r["sol_fraction"] == r["speed_of_light_ms"] / 47.383
    st = r["stages"]
    assert r["stage_share"]["segment_sum"] == st["segment_sum"]["ideal_ms"]
    assert r["stage_share"][profile_stages.REST] == pytest.approx(
        (st["preprocess backward"]["ideal_ms"]
         + st["appearance + loss backward"]["ideal_ms"]) / 20.0)
    assert set(r["stage_share"]) == set(stage_ms)
    assert "stage_share" not in roofline.summarize(47.383, **kw)


def test_partition_scene_matches_jax(monkeypatch):
    monkeypatch.setattr(j_partition_bench, "N_POINTS", 20_000)
    monkeypatch.setattr(j_partition_bench, "N_CAMS", 50)
    j_scene = j_partition_bench.make_scene()
    scene = partition_bench.make_scene(20_000, 50)
    np.testing.assert_array_equal(scene.points, j_scene.points)
    np.testing.assert_array_equal(scene.colors, j_scene.colors)
    assert scene.extent == j_scene.extent
    assert len(scene.cameras) == len(j_scene.cameras) == 50
    for c, j in zip(scene.cameras, j_scene.cameras):
        for k in ("uid", "image_id", "fovx", "fovy", "width", "height",
                  "image_name"):
            assert getattr(c, k) == getattr(j, k), k
        np.testing.assert_array_equal(c.R, j.R)
        np.testing.assert_array_equal(c.t, j.t)


def test_partition_bench_writes_only_its_out(tmp_path, monkeypatch, capsys):
    import tempfile

    record = ROOT / "PARTITION_BENCH.json"
    before = record.read_bytes()
    work = tmp_path / "tmp"
    work.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(work))
    monkeypatch.setattr(partition_bench, "N_POINTS", 20_000)
    monkeypatch.setattr(partition_bench, "N_CAMS", 50)
    out = tmp_path / "part.json"
    assert partition_bench.main(["--device", "cpu", "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    r = json.loads(line)
    assert json.loads(out.read_text()) == r
    assert r["metric"] == "partition_5M_points_seconds" and r["value"] > 0
    assert r["n_points"] == 20_000 and r["n_cameras"] == 50
    assert r["n_blocks"] >= 1 and r["all_assigned"]
    assert r["n_points_assigned"] + r["n_outliers"] == 20_000
    assert r["device"] == "cpu"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["part.json", "tmp"]
    assert list(work.iterdir()) == []
    assert record.read_bytes() == before
    assert not (ROOT / "PARTITION_BENCH_torch.json").exists()
