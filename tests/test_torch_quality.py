"""The quality slice of the port against the JAX package, on the CPU.

(1) ``pcp_tpu_torch.tools.synthetic.write_synthetic_scene`` against
    ``tests/synthetic.py``: the same ``sparse/0/*.bin`` bytes, and PNGs
    within one level on at most 0.5% of the values (the two fp32 renders
    agree within 3e-5 and straddle a rounding boundary rarely);
(2) the scale tool's scene builders against ``tools/quality_scale_run.py``'s
    bit for bit, under a shrunken preset;
(3) the dense oracle against ``pcp_tpu.ops.oracle`` (image and final T
    within 1e-5) and against the port's production ``rasterize`` (3e-5, the
    render parity's tolerance);
(4) ``tools.quality_run`` at a tiny size: all five variants, the JAX
    tool's keys, finite metrics, and a ``--skip_*`` rerun's merge;
(5) ``tools.train_check`` with its iterations cut: it trains and reports.
"""

import functools
import importlib
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu_torch.tools import oracle as t_oracle
from pcp_tpu_torch.tools import quality_run as t_qr
from pcp_tpu_torch.tools import quality_scale_run as t_qsr
from pcp_tpu_torch.tools import synthetic as t_syn
from pcp_tpu_torch.tools import train_check as t_tc

PNG_LEVELS, PNG_SHARE = 1, 0.005
ORACLE_ATOL, PRODUCTION_ATOL = 1e-5, 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # parallel test workers: a multithreaded CPU torch oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    # the JSONL log only: importing TensorBoard costs a minute here
    from pcp_tpu_torch.train import loop

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))


# ---------------------------------------------------------------- (1) scene

SCENE_CASES = {
    "plain": {},
    "jitter_field_holdout": dict(appearance_jitter=0.45,
                                 appearance_field=0.6, jitter_holdout=3),
}


@pytest.fixture(scope="module")
def jax_render_jitted():
    """``tests/synthetic.py``'s GT renders through ``pcp_tpu``'s
    ``rasterize`` under ``jax.jit``: one compile per image size, where the
    eager call compiles every operation of the path on first use."""
    import jax

    import pcp_tpu.ops.rasterize as j_rast

    orig = j_rast.rasterize

    @functools.lru_cache(maxsize=None)
    def compiled(size, deg):
        return jax.jit(lambda xyz, sc, q, op, sh, vm, intr, bg: orig(
            xyz, sc, q, op, sh, vm, intr, size, bg, deg))

    def rasterize(xyz, sc, q, op, sh, vm, intr, size, bg, deg):
        return compiled(tuple(size), deg)(xyz, sc, q, op, sh, vm, intr, bg)

    j_rast.rasterize = rasterize
    yield
    j_rast.rasterize = orig


@pytest.mark.parametrize("case", sorted(SCENE_CASES))
def test_synthetic_scene_matches_the_jax_factory(tmp_path, case,
                                                 jax_render_jitted):
    from PIL import Image as PILImage

    from tests.synthetic import write_synthetic_scene

    kw = SCENE_CASES[case]
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    got = t_syn.write_synthetic_scene(
        str(ours), np.random.default_rng(4), n_points=60, n_cams=6, W=64,
        H=48, device="cpu", **kw)
    want = write_synthetic_scene(
        str(theirs), np.random.default_rng(4), n_points=60, n_cams=6, W=64,
        H=48, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for f in sorted((theirs / "sparse" / "0").iterdir()):
        assert (ours / "sparse" / "0" / f.name).read_bytes() \
            == f.read_bytes(), f.name
    pngs = sorted((theirs / "images").iterdir())
    assert [p.name for p in sorted((ours / "images").iterdir())] \
        == [p.name for p in pngs]
    diff = np.concatenate([
        np.abs(np.asarray(PILImage.open(ours / "images" / p.name), int)
               - np.asarray(PILImage.open(p), int)).ravel() for p in pngs])
    assert diff.max() <= PNG_LEVELS
    assert np.mean(diff > 0) <= PNG_SHARE


def test_look_at_keeps_float64():
    from tests.synthetic import look_at_w2c

    for pos, tgt in [((4.0, 1.0, 2.0), (0, 0, 0)), ((0, 0, 5.0), (0, 0, 0))]:
        R, t = t_syn.look_at_w2c(pos, tgt)
        R0, t0 = look_at_w2c(pos, tgt)
        assert R.dtype == np.float64
        np.testing.assert_array_equal(R, R0)
        np.testing.assert_array_equal(t, t0)


# ------------------------------------------------------- (2) scale builders


@pytest.fixture
def scale_modules(monkeypatch, request):
    """Both scale tools, reloaded under the requested preset and shrunk
    (fewer Gaussians and cameras; the same shapes of draw)."""
    monkeypatch.setenv("PCP_QSR_PRESET", request.param)
    jax_mod = importlib.reload(importlib.import_module(
        "tools.quality_scale_run"))
    ours = importlib.reload(t_qsr)
    for mod in (jax_mod, ours):
        monkeypatch.setattr(mod, "N_FINE", 3000)
        monkeypatch.setattr(mod, "N_COARSE", 1700)
        monkeypatch.setattr(mod, "N_CAMS_RING", 12)
        monkeypatch.setattr(mod, "N_CAMS_GRID", 7)
    yield jax_mod, ours
    monkeypatch.delenv("PCP_QSR_PRESET")
    importlib.reload(t_qsr)


@pytest.mark.parametrize("scale_modules", ["ref500k", "ref100k"],
                         indirect=True)
def test_scale_builders_are_bit_equal(scale_modules):
    jax_mod, ours = scale_modules
    for k in ("W", "H", "FX", "SLAB", "N_SFM", "DETAIL_R", "CAPACITY",
              "CAPACITY_CONTROL", "LLFFHOLD", "THRESHOLD", "PRESET"):
        assert getattr(ours, k) == getattr(jax_mod, k), k
    np.testing.assert_array_equal(ours.DETAIL_CENTER, jax_mod.DETAIL_CENTER)

    ra, rb = np.random.default_rng(31), np.random.default_rng(31)
    for a, b in zip(ours.make_true_cloud(ra), jax_mod.make_true_cloud(rb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ca, cb = ours.make_cameras(ra), jax_mod.make_cameras(rb)
    assert len(ca) == len(cb) == 12 + 7
    for (pa, ta), (pb, tb) in zip(ca, cb):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ta, tb)
    xyz = ra.normal(size=(500, 3)).astype(np.float32)
    rb.normal(size=(500, 3))
    np.testing.assert_array_equal(ours.spectral_colors(xyz, ra),
                                  jax_mod.spectral_colors(xyz, rb))
    assert ra.integers(1 << 30) == rb.integers(1 << 30)


# --------------------------------------------------------------- (3) oracle


def _oracle_inputs():
    rng = np.random.default_rng(7)
    n = 50
    xyz = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.4, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    op = rng.uniform(0.3, 0.99, n).astype(np.float32)
    sh = rng.normal(0.0, 0.5, (n, 16, 3)).astype(np.float32)
    R, t = t_syn.look_at_w2c((4.0, 1.0, 2.0), (0.0, 0.0, 0.0))
    return (xyz, scales, quats, op, sh, t_syn.viewmat_of(R, t),
            (40.0, 40.0, 24.0, 16.0), (48, 32),
            np.array([0.1, 0.2, 0.3], np.float32), 3)


def test_oracle_matches_jax_and_the_production_path(monkeypatch):
    from pcp_tpu.ops import oracle as j_oracle
    from pcp_tpu.ops.projection import CameraIntrin as JIntrin

    from pcp_tpu_torch.ops.projection import CameraIntrin
    from pcp_tpu_torch.ops.rasterize import rasterize

    (xyz, scales, quats, op, sh, vm, intr, size, bg, deg) = _oracle_inputs()
    j_in = (xyz, scales, quats, op, sh, vm,
            JIntrin(*(jnp.float32(v) for v in intr)), size, bg, deg)
    t_intr = CameraIntrin(*(np.float32(v) for v in intr))
    wants = [j_oracle.rasterize_dense(*j_in),
             j_oracle.rasterize_dense_jax(*j_in)]
    # one band and long chunks, several bands and chunks shorter than a
    # tile's list: the same answer
    for chunk, band_rows in [(512, 1), (7, 2)]:
        monkeypatch.setattr(t_oracle, "CHUNK", chunk)
        monkeypatch.setattr(t_oracle, "BAND_ROWS", band_rows)
        img, t_fin = t_oracle.rasterize_dense(
            xyz, scales, quats, op, sh, vm, t_intr, size, bg, deg,
            device="cpu")
        assert img.shape == (32, 48, 3) and t_fin.shape == (32, 48)
        for w_img, w_t in wants:
            np.testing.assert_allclose(img, w_img, atol=ORACLE_ATOL, rtol=0)
            np.testing.assert_allclose(t_fin, w_t, atol=ORACLE_ATOL, rtol=0)
    assert t_fin.min() < 0.05      # some pixels are nearly covered
    prod, aux = rasterize(xyz, scales, quats, op, sh, vm, t_intr, size, bg,
                          deg, device="cpu")
    np.testing.assert_allclose(img, prod.numpy(), atol=PRODUCTION_ATOL,
                               rtol=0)
    np.testing.assert_allclose(t_fin, aux["final_t"].numpy(),
                               atol=PRODUCTION_ATOL, rtol=0)


def test_oracle_in_the_key_order_matches_both_production_paths(
        jax_render_jitted):
    """Two wide Gaussians on the axis, the farther first, their depths 6
    ulp apart: the pair key keeps the top ``key_depth_bits`` bits of each
    depth's fp32 pattern, so the port's production path blends them in
    index order, and the oracle in the key's order gives its image; the
    exact oracle puts the nearer first. JAX's production path parts from
    the exact oracle too, but its sort leaves equal keys in an order of
    its own (index order in some tiles, not in all)."""
    import jax.numpy as jnp

    import pcp_tpu.ops.rasterize as j_rast
    from pcp_tpu.ops.projection import CameraIntrin as JIntrin

    from pcp_tpu_torch.ops.binning import key_depth_bits
    from pcp_tpu_torch.ops.projection import CameraIntrin
    from pcp_tpu_torch.ops.rasterize import rasterize
    from pcp_tpu_torch.utils.sh import rgb_to_sh

    ulp = np.spacing(np.float32(3.0))
    xyz = np.array([[0.0, 0.0, 3.0 + 6 * ulp], [0.02, 0.0, 3.0]], np.float32)
    rgb = np.array([[0.9, 0.1, 0.1], [0.1, 0.1, 0.9]], np.float32)
    scales = np.full((2, 3), 0.5, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (2, 1))
    op = np.array([0.9, 0.9], np.float32)
    sh = rgb_to_sh(rgb)[:, None, :]
    intr = (40.0, 40.0, 32.0, 24.0)
    size, bg = (64, 48), np.zeros(3, np.float32)
    args = (xyz, scales, quats, op, sh, np.eye(4, dtype=np.float32),
            CameraIntrin(*(np.float32(v) for v in intr)), size, bg, 0)
    prod = rasterize(*args, device="cpu")[0].numpy()
    theirs = np.asarray(j_rast.rasterize(
        *(jnp.asarray(a) for a in args[:6]),
        JIntrin(*(jnp.float32(v) for v in intr)), size, jnp.asarray(bg),
        0)[0])
    exact = t_oracle.rasterize_dense(*args, device="cpu")[0]
    keyed = t_oracle.rasterize_dense(
        *args, depth_bits=key_depth_bits(4 * 3), device="cpu")[0]
    np.testing.assert_allclose(keyed, prod, atol=PRODUCTION_ATOL, rtol=0)
    assert np.abs(exact - prod).max() > 0.3
    assert np.abs(exact - theirs).max() > 0.3


# ---------------------------------------------------------- (4) quality_run

QR_TINY = dict(W=48, H=32, N_POINTS=160, N_CAMS=8, CAPACITY=512,
               THRESHOLD=90)
JAX_ROW_KEYS = {"variant", "iterations", "densify", "appearance", "PSNR",
                "SSIM", "LPIPS", "lpips_weights", "wall_minutes", "blocks"}
VARIANTS = {"densify", "no_densify_control", "jitter_appearance_shared",
            "jitter_appearance_on", "jitter_appearance_off"}


def test_quality_run_small_on_the_cpu(tmp_path, monkeypatch):
    from pcp_tpu_torch.cli import common

    for k, v in QR_TINY.items():
        monkeypatch.setattr(t_qr, k, v)
    # every block also saves a PLY at 10: the snapshot curve's point
    config_from_args = common.config_from_args

    def with_snapshot(args):
        cfg = config_from_args(args)
        cfg.save_iterations = [10]
        return cfg

    monkeypatch.setattr(common, "config_from_args", with_snapshot)
    art = tmp_path / "QUALITY_small.json"
    monkeypatch.setattr(t_qr, "ARTIFACT", str(art))
    scene = str(tmp_path / "scene")
    t_qr.main(["--scene", scene, "--iters", "12", "--skip_appearance_pair",
               "--device", "cpu"])
    first = json.loads(art.read_text())
    assert [r["variant"] for r in first["runs"]] \
        == ["densify", "no_densify_control"]
    out = t_qr.main(["--scene", scene, "--skip_densify_pair",
                     "--app_iters", "6", "--device", "cpu"])
    assert json.loads(art.read_text()) == out
    assert set(out) >= {"workload", "runs", "card"}
    assert out["card"] is None and out["device"] == "cpu"
    assert {r["variant"] for r in out["runs"]} == VARIANTS
    assert out["runs"][:2] == first["runs"]
    for r in out["runs"]:
        assert set(r) == JAX_ROW_KEYS | {"snapshot_curve",
                                         "population_curve"}
        assert r["blocks"] >= 2
        for k in ("PSNR", "SSIM", "LPIPS"):
            assert math.isfinite(r[k]), (r["variant"], k)
        pair = r["variant"] in ("densify", "no_densify_control")
        assert r["iterations"] == (12 if pair else 6)
        # a snapshot at 10 of the 12-step runs; none in the 6-step ones;
        # no 1000-step point in either log
        assert [c["iter"] for c in r["snapshot_curve"]] == ([10] if pair
                                                            else [])
        for c in r["snapshot_curve"]:
            assert math.isfinite(c["PSNR"]) and math.isfinite(c["SSIM"])
        assert r["population_curve"] == []
    assert not any(r["appearance"] for r in out["runs"]
                   if r["variant"] == "jitter_appearance_off")
    assert Path(scene + "_jitter", "model_jitter_appearance_shared").is_dir()


# ------------------------------------------------------ the training logs


def _write_log(out_dir: Path, rows) -> None:
    out_dir.mkdir(parents=True)
    with open(out_dir / "train_log.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)


def test_train_log_curves_of_both_tools(tmp_path):
    """One reader under both tools: the reports at multiples of 1000, the
    last report of a step winning after a resume; the scale tool's wall
    time with each gap cut at 5 minutes; the small tool's sum over blocks."""
    def report(step, alive, ts, dt=0.02):
        return {"step": step, "ts": ts, "total_points": alive,
                "iter_time": dt, "n_pairs": 10 * alive,
                "train_loss_patches/total_loss": 0.1}

    first = [report(1, 100, 0.0), report(1000, 150, 10.0),
             {"step": 1000, "ts": 11.0, "test/psnr": 20.0},
             report(1500, 170, 15.0), report(2000, 180, 20.0)]
    # resumed from 1000 an hour later: 2000 again, then 3000
    resumed = [report(1001, 150, 3620.0), report(2000, 190, 3630.0, 0.03),
               report(3000, 200, 3640.0)]
    a, b = tmp_path / "v" / "a" / "partition_a" / "output", \
        tmp_path / "v" / "b" / "partition_b" / "output"
    _write_log(a, first + resumed)
    _write_log(b, [report(1000, 50, 0.0), report(2000, 60, 5.0)])

    curve, wall = t_qsr.train_log_curve(str(a))
    assert curve == [
        {"iter": 1000, "alive": 150, "step_ms": 20.0, "n_pairs": 1500},
        {"iter": 2000, "alive": 190, "step_ms": 30.0, "n_pairs": 1900},
        {"iter": 3000, "alive": 200, "step_ms": 20.0, "n_pairs": 2000}]
    assert wall == pytest.approx(20.0 + 300.0 + 20.0)
    assert t_qsr.train_log_curve(str(tmp_path / "none")) == ([], 0.0)

    pop = t_qr._population_curve(str(tmp_path / "v"), ["a", "b"])
    assert pop == [{"iter": 1000, "total_points": 200, "step_ms": 20.0},
                   {"iter": 2000, "total_points": 250, "step_ms": 25.0},
                   {"iter": 3000, "total_points": 200, "step_ms": 20.0}]


# ---------------------------------------------------------- (5) train_check


def test_train_check_runs_and_reports(monkeypatch, capsys):
    monkeypatch.setattr(t_tc, "ITERATIONS", 15)
    rc = t_tc.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert ("TRAIN QUALITY OK" in out) == (rc == 0)
    before, after = (float(v) for v in
                     out.split("PSNR ")[1].split(" on ")[0].split(" -> "))
    assert math.isfinite(before) and after > before


def test_train_check_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        t_tc.main([])


def test_synthetic_lpips_weights_seed0_match_the_jax_tool():
    from pcp_tpu_torch.eval.lpips import synthetic_weights
    from tools.make_lpips_weights import synthetic_bundle

    got, want = synthetic_weights(0), synthetic_bundle(0)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
