#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render and training paths on one CUDA card
and hold every kernel on them against its plain PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run it from the root of a checkout: it builds the kernels from the sources
there, needs no install step and nothing from the network. Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the TF32 flags;
2. build every kernel of both paths (one ``nvcc`` per source, together);
3. write a synthetic scene from ``--seed``: a COLMAP binary model of
   1280x800 cameras with GT PNGs and ``N_GAUSSIANS`` points, and a Gaussian
   PLY at SH degree 3 whose density statistics are those of the repo's
   reference-scale bench scene (``tools/bench_scene.py`` at 719k Gaussians,
   1280x800);
4. the render path: ``pcp_tpu_torch.cli.render.main`` on ``cuda``, with
   every launch count set to 0 just before and read just after;
5. ``composite_fwd`` against its plain version on one full-width view;
6. its kernel, plain-version and render times, and its bound;
7. a small scene rendered through the same code on the CPU and on the card;
8. the training path: ``pcp_tpu_torch.cli.train.main`` on ``cuda`` from
   the scene's points (~720k alive Gaussians in 2^20 slots, appearance on)
   for ``TRAIN_ITERS`` steps with one densify and one opacity reset, counts
   set to 0 just before and read just after;
9. a full-width train step at SH degree 3 on the 720k PLY: the warm step
   time, each stage's device time from the profiler ranges that the step
   marks, device busy time and idle share;
10. ``composite_bwd`` and ``sorted_segment_sum`` against their plain
    versions on the inputs they got in that step, with their times and
    bounds;
11. one train step of a small scene on the CPU and on the card;
12. one ``{"kernels": [...]}`` line, the card's name and power limit, and
    the ``{"ok": true, ...}`` line last.

Any failed check raises: the script then exits non-zero and prints no
result line. Without a CUDA card it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

from pcp_tpu_torch.cli import render as render_cli
from pcp_tpu_torch.cli import train as train_cli
from pcp_tpu_torch.device import resolve_device
from pcp_tpu_torch.eval.render_batch import render_view
from pcp_tpu_torch.io import colmap
from pcp_tpu_torch.io.ply import save_gaussian_ply
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.models.appearance import init_appearance
from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops import composite, segsum
from pcp_tpu_torch.ops import rasterize as rasterize_mod
from pcp_tpu_torch.ops.binning import bin_gaussians
from pcp_tpu_torch.ops.projection import TILE, preprocess
from pcp_tpu_torch.ops.rasterize import rasterize, untile
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.scene import load_colmap_scene, split_train_test
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.train.step import TrainState, app_groups, train_step_impl
from pcp_tpu_torch.utils.graphics import rotmat_to_qvec
from pcp_tpu_torch.utils.sh import rgb_to_sh

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "_smoke"          # scene files; listed in .gitignore

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

W, H = 1280, 800
FX = FY = 850.0                    # tools/profile_scale.py's camera
SH_DEGREE = 3
N_GAUSSIANS = 720_000              # the reference block's 719,802, rounded
TEST_VIEWS = 8
LLFFHOLD = 2                       # every 2nd camera is a test view
CAPACITY = 1 << 20                 # the JAX package's default slot count
# The training path: TRAIN_ITERS steps through the CLI; densify at
# iterations 10 and 20 (> DENSIFY_FROM, every DENSIFY_EVERY), opacity reset
# at RESET_EVERY, and no densify after it (that one would also prune every
# Gaussian wider than 20 px or a tenth of the camera extent).
TRAIN_ITERS = 28
DENSIFY_FROM, DENSIFY_EVERY, RESET_EVERY = 5, 10, 25
STEP_REPS = 5                      # timed warm steps at full width

# Every kernel of both paths. ``replaces`` is the TPU kernel's pallas_call.
KERNELS = [
    {"name": "composite_fwd", "route": "cuda",
     "source": "pcp_tpu_torch/csrc/composite_fwd.cu",
     "replaces": "pcp_tpu/ops/pallas_composite.py:1021"},
    {"name": "composite_bwd", "route": "cuda",
     "source": "pcp_tpu_torch/csrc/composite_bwd.cu",
     "replaces": "pcp_tpu/ops/pallas_composite.py:1101"},
    {"name": "sorted_segment_sum", "route": "cuda",
     "source": "pcp_tpu_torch/csrc/segsum.cu",
     "replaces": "pcp_tpu/ops/segsum_pallas.py:164"},
]

# Kernel vs plain version on the card: the same fp32 operations in the same
# order (the kernel is built with --fmad=false), so they agree to rounding
# of expf; n_contrib may differ only where that flips a threshold.
KERNEL_ATOL = 1e-5
NCONTRIB_AGREE = 0.9999
# The backward and the segment sum take their sums in another order than
# the plain version: the backward's 256-pixel shuffle tree, each plane to
# 1e-5 of its largest value; the segment sum against index_add_'s atomics,
# to 1e-6 of the sum of |terms| of each segment (fp32 rounding grows with a
# segment's length).
KERNEL_RSUM = 1e-5
KERNEL_RSEG = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# --------------------------------------------------------------------------
# 1. the card
# --------------------------------------------------------------------------


def card() -> str:
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60, cwd=ROOT,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(dev)}, "
        f"{torch.cuda.device_count()} card(s)")
    log(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    return smi


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------


def build() -> float:
    t0 = time.perf_counter()
    stems = [Path(k["source"]).stem for k in KERNELS]
    _build.build_all(stems)
    dt = time.perf_counter() - t0
    log(f"built {stems} in {dt:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    return dt


# --------------------------------------------------------------------------
# 3. synthetic scene
# --------------------------------------------------------------------------


def _rot(yaw: float, pitch: float) -> np.ndarray:
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), \
        math.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    return rx @ ry


def write_scene(root: Path, seed: int, n: int, n_cams: int) -> tuple:
    """COLMAP model + GT PNGs under ``root/scene`` and a Gaussian PLY at
    ``root/model/point_cloud.ply``.

    The Gaussians follow tools/bench_scene.py: depths 8..60 filling a
    1280x800 frustum with ~20% spill, splat sigma lognormal in pixels
    (median 4 px x sqrt(100k / n), log-std 0.6) with mild anisotropy,
    opacity uniform in [0.1, 0.8]; here also random rotations and SH rest
    coefficients so SH degree 3 does work. The COLMAP points are the same
    ``n`` positions, so training starts at full width. Cameras jitter
    around the bench camera by a few degrees and a little translation."""
    from PIL import Image as PILImage

    rng = np.random.default_rng(seed)
    depth = rng.uniform(8.0, 60.0, n)
    half_w = (W / 2 + 60) / FX * depth
    half_h = (H / 2 + 60) / FY * depth
    xyz = np.stack([rng.uniform(-1, 1, n) * half_w,
                    rng.uniform(-1, 1, n) * half_h, depth], -1)
    sigma_px = np.exp(rng.normal(np.log(4.0 * math.sqrt(100_000 / n)), 0.6,
                                 n))
    scaling = (np.log(sigma_px * depth / FX)[:, None]
               + rng.uniform(-0.35, 0.35, (n, 3)))
    opac = rng.uniform(0.1, 0.8, n)
    model = root / "model"
    model.mkdir(parents=True)
    save_gaussian_ply(
        str(model / "point_cloud.ply"), xyz.astype(np.float32),
        rgb_to_sh(rng.uniform(0, 1, (n, 3))).astype(np.float32),
        rng.normal(0.0, 0.05, (n, 15, 3)).astype(np.float32),
        np.log(opac / (1 - opac))[:, None].astype(np.float32),
        scaling.astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
    )

    scene = root / "scene"
    (scene / "images").mkdir(parents=True)
    cams = {1: colmap.Camera(1, "PINHOLE", W, H,
                             np.array([FX, FY, W / 2, H / 2]))}
    ramp = np.linspace(0, 255, W, dtype=np.float32)[None, :, None]
    images = {}
    for i in range(n_cams):
        R = _rot(*np.radians(rng.uniform(-3, 3, 2)))
        t = rng.uniform(-0.5, 0.5, 3) * [1, 1, 2]
        name = f"im{i:03d}.png"
        gt = np.broadcast_to((ramp + 9 * i) % 256, (H, W, 3)).astype(np.uint8)
        PILImage.fromarray(gt).save(scene / "images" / name)
        images[i + 1] = colmap.Image(i + 1, rotmat_to_qvec(R), t, 1, name)
    pts = colmap.Points3D.from_arrays(
        xyz, rng.integers(0, 256, (n, 3)).astype(np.uint8))
    colmap.write_model(cams, images, pts, str(scene / "sparse" / "0"),
                       ext=".bin")
    return scene, model


# --------------------------------------------------------------------------
# 4. the render path
# --------------------------------------------------------------------------


def main_path(scene: Path, model: Path) -> dict:
    argv = ["-s", str(scene), "-m", str(model), "--llffhold",
            str(LLFFHOLD), "--device", "cuda"]
    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    stats = render_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k["name"]: composite.LAUNCHES[k["name"]] for k in KERNELS}
    views = stats["test"]
    out = model / "test" / "ours_merged"
    for sub in ("renders", "gt"):
        pngs = sorted(os.listdir(out / sub))
        check(pngs == [f"{i:05d}.png" for i in range(len(views))],
              f"{sub}/ holds one PNG per view")
    check(launches == {"composite_fwd": len(views), "composite_bwd": 0,
                       "sorted_segment_sum": 0},
          f"the render path launches the forward kernel only: {launches}")
    check(len(views) == TEST_VIEWS, f"{TEST_VIEWS} test views rendered")
    check(all(v["n_dropped"] == 0 for v in views), "n_dropped == 0")
    log(f"cli render: {len(views)} views in {wall:.1f} s, launches "
        f"{launches}, n_pairs {[v['n_pairs'] for v in views]}, "
        f"max_tile_load {[v['max_tile_load'] for v in views]}")
    return {"launches": launches, "views": views}


# --------------------------------------------------------------------------
# 5./6. kernel vs plain version, times, bounds
# --------------------------------------------------------------------------


def view_prep_bins(params, alive, cam, dev, max_per_tile, stages=None):
    """preprocess and bin_gaussians for one view, as rasterize runs them;
    with ``stages``, adds each one's synchronised wall time to it."""
    viewmat, intrin = cam_mod.camera_tensors(cam, dev)
    t = time.perf_counter()
    prep = preprocess(
        params["xyz"], G.scaling_act(params["scaling"]), params["rotation"],
        G.opacity_act(params["opacity"])[:, 0] * alive.float(),
        G.sh_coeffs(params), viewmat, intrin, (cam.width, cam.height),
        SH_DEGREE)
    if stages is not None:
        torch.cuda.synchronize()
        stages["preprocess"] += time.perf_counter() - t
        t = time.perf_counter()
    tiles_x = (cam.width + TILE - 1) // TILE
    tiles_y = (cam.height + TILE - 1) // TILE
    bins = bin_gaussians(prep["rect"], prep["depths"], tiles_x, tiles_y,
                         max_per_tile)
    if stages is not None:
        torch.cuda.synchronize()
        stages["binning"] += time.perf_counter() - t
    return prep, bins


def blend_work(pack, gids, tile_start, tile_count, tiles_x):
    """What the blend must do for these inputs, slot by slot as the plain
    version walks them: samples evaluated (pixel not yet done), of those
    with power <= 0 (an expf), with alpha >= 1/255 (tested against the
    stop) and applied."""
    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x,
                                     pack.device)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    start, count = tile_start.long(), tile_count.long()
    work = torch.zeros(4, dtype=torch.int64, device=pack.device)
    for k in range(int(count.max())):
        live = k < count
        att = pack[gids[torch.where(live, start + k, 0)].long()]
        dx, dy = px - att[:, 0:1], py - att[:, 1:2]
        power = (-0.5 * (att[:, 2:3] * dx * dx + att[:, 4:5] * dy * dy)
                 - att[:, 3:4] * dx * dy)
        alpha = torch.clamp_max(att[:, 8:9] * torch.exp(power),
                                composite.ALPHA_MAX)
        ev = live[:, None] & ~done
        ex = ev & (power <= 0)
        ok = ex & (alpha >= composite.ALPHA_MIN)
        test_t = T * (1 - alpha)
        stop = ok & (test_t < composite.T_EPS)
        app = ok & ~stop
        done |= stop
        T = torch.where(app, test_t, T)
        work += torch.stack([ev.sum(), ex.sum(), ok.sum(), app.sum()])
    return [int(v) for v in work]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def composite_checks(args, bins) -> dict:
    pack, gids, start, count, tiles_x = args
    k_color, k_tfin, k_nc = composite.composite_fwd(*args)
    p_color, p_tfin, p_nc = composite.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    err = max(float((k_color - p_color).abs().max()),
              float((k_tfin - p_tfin).abs().max()))
    agree = float((k_nc == p_nc).float().mean())
    log(f"composite_fwd vs plain: max_abs_err {err:.3e} (tol "
        f"{KERNEL_ATOL}), n_contrib agree {agree:.6f} (min "
        f"{NCONTRIB_AGREE})")
    check(err <= KERNEL_ATOL, "composite_fwd color/t_fin vs plain")
    check(agree >= NCONTRIB_AGREE, "composite_fwd n_contrib vs plain")

    ms = cuda_ms(lambda: composite.composite_fwd(*args), reps=50)
    plain_ms = cuda_ms(lambda: composite.composite_fwd_plain(*args), reps=2,
                       warm=1)
    nt = start.shape[0]
    ev, ex, ok, app = blend_work(*args)
    # bytes: each referenced attribute row, the pair list and the ranges
    # read once; color, t_fin and n_contrib written once
    n_rows = int(torch.unique(gids).numel())
    nbytes = 36 * n_rows + 4 * gids.numel() + 8 * nt + 20 * nt * TILE * TILE
    # fp32 operations (kernel source, one per add/mul/compare, expf as 1):
    # 12 per evaluated sample, 4 more with an expf, 3 more tested, 7 more
    # applied
    ops = 12 * ev + 4 * ex + 3 * ok + 7 * app
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    log(f"blend work: n_pairs {bins.n_pairs}, max_tile_load "
        f"{int(bins.max_tile_load)}, samples evaluated / expf / tested / "
        f"applied {[ev, ex, ok, app]}, bytes {nbytes} ({t_bytes:.4f} ms), "
        f"fp32 ops {ops} ({t_ops:.4f} ms)")
    log(f"composite_fwd {ms:.4f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "n_contrib_agree": agree, "ms": ms,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "n_pairs": bins.n_pairs,
            "max_tile_load": int(bins.max_tile_load)}


def render_times(params, alive, cams, dev, max_per_tile) -> dict:
    """Warm render ms/view through render_view (image back on the host);
    the time of each stage, with the card synchronised after each; and,
    from the profiler, the device time by kernel and the idle share of the
    unprofiled wall time."""
    bg = torch.zeros(3, device=dev)

    def one_pass():
        for cam in cams:
            render_view(params, alive, cam, SH_DEGREE, bg,
                        max_per_tile=max_per_tile, device=dev)
        torch.cuda.synchronize()

    one_pass()
    t0 = time.perf_counter()
    one_pass()
    ms_view = (time.perf_counter() - t0) * 1e3 / len(cams)

    stages = dict.fromkeys(("preprocess", "binning", "composite",
                            "image_to_host"), 0.0)
    for cam in cams:
        prep, bins = view_prep_bins(params, alive, cam, dev, max_per_tile,
                                    stages)
        t = time.perf_counter()
        tiles_x = (cam.width + TILE - 1) // TILE
        tiles_y = (cam.height + TILE - 1) // TILE
        color, t_fin, _ = composite.composite_fwd(
            composite.pack_attributes(prep), bins.gids, bins.tile_start,
            bins.tile_count, tiles_x)
        torch.cuda.synchronize()
        stages["composite"] += time.perf_counter() - t
        t = time.perf_counter()
        size = (tiles_x, tiles_y, cam.width, cam.height)
        image = (untile(color, *size)
                 + untile(t_fin[:, None], *size) * bg.reshape(1, 1, 3))
        torch.clamp(image, 0.0, 1.0).cpu().numpy()
        stages["image_to_host"] += time.perf_counter() - t
    stages = {k: v * 1e3 / len(cams) for k, v in stages.items()}

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        one_pass()
    rows = device_kernels(prof, len(cams))
    busy = sum(ms for _, ms in rows)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    log(f"render {ms_view:.3f} ms/view; stages (synchronised) "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms/view; device busy {busy:.3f} ms/view")
    for key, ms in top:
        log(f"  {ms:8.3f} ms/view  {key[:90]}")
    measured = busy > 0
    return {"render_ms_per_view": ms_view, "stage_ms_per_view": stages,
            "device_busy_ms_per_view": busy if measured else None,
            "device_idle_share": 1 - busy / ms_view if measured else None,
            "top_device_ms_per_view": [[k[:90], ms] for k, ms in top]}


# --------------------------------------------------------------------------
# 7. CPU vs card on a small scene
# --------------------------------------------------------------------------


def cpu_vs_cuda(params, alive, cam, n_small: int) -> None:
    """The first ``n_small`` Gaussians at a quarter of the resolution on
    both devices. CPU and CUDA libm round exp/log/sqrt differently in the
    last bits, so a sample at alpha = 1/255 or a pixel at the T = 1e-4 stop
    may flip: a flip moves a pixel by at most about 1/255 * T."""
    small = cam_mod.Camera(uid=0, viewmat=cam.viewmat, fx=cam.fx / 4,
                           fy=cam.fy / 4, width=cam.width // 4,
                           height=cam.height // 4)
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v[:n_small].to(dev) for k, v in params.items()}
        viewmat, intrin = cam_mod.camera_tensors(small, torch.device(dev))
        img, aux = rasterize(
            p["xyz"], G.scaling_act(p["scaling"]), p["rotation"],
            G.opacity_act(p["opacity"])[:, 0] * alive[:n_small].to(dev),
            G.sh_coeffs(p), viewmat, intrin, (small.width, small.height),
            torch.zeros(3), SH_DEGREE, device=dev)
        out[dev] = (img.cpu(), aux["final_t"].cpu(), aux["n_pairs"])
    diff = torch.cat([(out["cpu"][i] - out["cuda"][i]).abs().flatten()
                      for i in (0, 1)])
    near = float((diff <= 1e-4).float().mean())
    log(f"small scene cpu vs cuda: max abs diff {float(diff.max()):.3e}, "
        f"{near:.6f} of values within 1e-4, n_pairs {out['cpu'][2]} / "
        f"{out['cuda'][2]}")
    check(float(diff.max()) <= 5e-3 and near >= 0.999,
          "CPU and CUDA agree on the small scene")
    check(abs(out["cpu"][2] - out["cuda"][2]) <= 1e-3 * out["cpu"][2],
          "CPU and CUDA pair counts agree to 0.1%")



# --------------------------------------------------------------------------
# 8. the training path
# --------------------------------------------------------------------------


def train_path(scene: Path, out: Path) -> dict:
    """``cli.train`` on the card for TRAIN_ITERS steps, metrics logged at
    every step; checks the losses, the densify, the opacity reset, the PLY
    and the launch counts."""
    argv = ["-s", str(scene), "-m", str(out), "--device", "cuda",
            "--eval", "--llffhold", str(LLFFHOLD),
            "--iterations", str(TRAIN_ITERS),
            "--densify_from_iter", str(DENSIFY_FROM),
            "--densification_interval", str(DENSIFY_EVERY),
            "--opacity_reset_interval", str(RESET_EVERY),
            "--save_iterations", str(TRAIN_ITERS),
            "--test_iterations", str(TRAIN_ITERS),
            "--log_interval", "1", "--quiet"]
    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k["name"]: composite.LAUNCHES[k["name"]] for k in KERNELS}
    logs = [json.loads(line) for line in
            (out / "train_log.jsonl").read_text().splitlines()]
    steps = [r for r in logs if "train_loss_patches/total_loss" in r]
    losses = [r["train_loss_patches/total_loss"] for r in steps]
    alive = {r["step"]: r["total_points"] for r in steps}
    check(len(steps) == TRAIN_ITERS, "one logged record per step")
    check(all(math.isfinite(v) for v in losses), "finite loss at every step")
    check(all(r["n_dropped"] == 0 for r in steps), "n_dropped == 0")
    first = DENSIFY_FROM + DENSIFY_EVERY - DENSIFY_FROM % DENSIFY_EVERY
    check(alive[first] != alive[first - 1],
          f"the densify at {first} changed the alive count")
    check(alive[1] > 0.99 * N_GAUSSIANS, "training starts at full width")
    live_op = state.params["opacity"][state.alive]
    cap = math.log(0.01 / 0.99) + 3.2 * OptimConfig().opacity_lr * (
        TRAIN_ITERS - RESET_EVERY)
    check(float(live_op.max()) <= cap, "the opacity reset ran")
    ply = out / "point_cloud" / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply"
    check(ply.exists(), "the trained PLY is written")
    check(launches["composite_bwd"] == TRAIN_ITERS
          and launches["sorted_segment_sum"] == TRAIN_ITERS,
          f"one backward and one segment sum per step: {launches}")
    check(launches["composite_fwd"] == TRAIN_ITERS + TEST_VIEWS,
          f"one forward per step and per eval view: {launches}")
    ev = json.loads((out / f"eval_{TRAIN_ITERS}.json").read_text())
    log(f"cli train: {TRAIN_ITERS} steps in {wall:.1f} s, launches "
        f"{launches}, loss {losses[0]:.5f} -> {losses[-1]:.5f}, alive "
        f"{alive[1]} -> {alive[TRAIN_ITERS]} (densify at {first}: "
        f"{alive[first - 1]} -> {alive[first]}), n_pairs "
        f"{steps[0]['n_pairs']:.0f} -> {steps[-1]['n_pairs']:.0f}, "
        f"eval {ev}")
    return {"launches": launches, "wall_s": wall, "loss_first": losses[0],
            "loss_last": losses[-1], "alive_first": alive[1],
            "alive_last": alive[TRAIN_ITERS], "eval": ev}


# --------------------------------------------------------------------------
# 9. a full-width train step
# --------------------------------------------------------------------------


def train_state(params, alive, dev, seed: int) -> TrainState:
    app = init_appearance(torch.Generator().manual_seed(seed), dev)
    return TrainState(params, app, optim.init_adam(params),
                      optim.init_adam(app_groups(app)), alive,
                      G.init_densify_stats(alive.shape[0], dev))


# The profiler ranges that rasterize, Blend and train_step_impl mark, in the
# order a step runs them; the rest of the device time is autograd's backward
# of preprocess, the appearance net and the loss, and the few operations
# outside any range (the GT's conversion, the probe, the gradient list).
STAGES = ("preprocess", "binning", "composite_fwd", "appearance + loss",
          "composite_bwd", "segment_sum", "densify stats + adam")
REST = "the rest: preprocess, appearance and loss backward (autograd)"
OWN_KERNELS = {"composite_fwd": "composite_fwd_kernel",
               "composite_bwd": "composite_bwd_kernel",
               "segment_sum": "segsum_kernel"}


def device_kernels(prof, per: int) -> list:
    """(name, device ms per ``per``) of every kernel, copy and fill the
    profiler saw on the card; range annotations are not device work."""
    return [(e.key, e.self_device_time_total / 1e3 / per)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def capture_backward(run) -> dict:
    """Calls ``run()`` with the backward's two kernel wrappers, as
    ``ops.rasterize`` calls them, recording the arguments each got."""
    seen, real = {}, {"composite_bwd": rasterize_mod.composite_bwd,
                      "sorted_segment_sum": rasterize_mod.sorted_segment_sum}

    def spy(name):
        def call(*args):
            seen[name] = tuple(a.detach() if torch.is_tensor(a) else a
                               for a in args)
            return real[name](*args)
        return call

    try:
        for name in real:
            setattr(rasterize_mod, name, spy(name))
        run()
    finally:
        for name, fn in real.items():
            setattr(rasterize_mod, name, fn)
    return seen


def train_times(state: TrainState, cam, gt, ocfg, extent: float) -> dict:
    """Warm train-step time (median of STEP_REPS, synchronised), peak
    memory, and from the profiler the device time of each stage, by kernel,
    and the idle share of the warm step. Also returns the arguments the
    backward's two kernels got in one more step."""
    dev = state.alive.device
    viewmat, intrin = cam_mod.camera_tensors(cam, dev)
    bg = torch.zeros(3, device=dev)

    def step():
        return train_step_impl(
            state, viewmat, intrin, gt, cam.uid, bg, extent, ocfg=ocfg,
            image_size=(cam.width, cam.height), sh_degree=SH_DEGREE,
            use_appearance=True)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(STEP_REPS):
        t0 = time.perf_counter()
        _, m = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = statistics.median(times)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    rows = device_kernels(prof, 3)
    busy = sum(ms for _, ms in rows)
    stages = dict.fromkeys(STAGES, 0.0)
    held = {k: set() for k in STAGES}     # kernels each range's time counts

    def kernels_under(e):
        return {k.name for k in e.kernels}.union(
            *(kernels_under(c) for c in e.cpu_children))

    for e in prof.events():
        if e.key in stages and e.device_type == DeviceType.CPU:
            stages[e.key] += e.device_time_total / 1e3 / 3
            held[e.key] |= kernels_under(e)
    # The profiler ties a ctypes launch to its runtime call, not to the
    # range around it: the port's own kernels join their stage by name.
    for stage, symbol in OWN_KERNELS.items():
        if not any(symbol in name for name in held[stage]):
            stages[stage] += sum(ms for key, ms in rows if symbol in key)
    stages[REST] = busy - sum(stages.values())
    top = sorted(rows, key=lambda r: -r[1])[:10]
    log(f"train step (SH {SH_DEGREE}, {cam.width}x{cam.height}, "
        f"{int(state.alive.sum())} alive in {state.alive.shape[0]} slots): "
        f"warm {step_ms:.3f} ms median of {[round(x, 3) for x in times]}, "
        f"n_pairs {m['n_pairs']}, peak memory {peak / 2**30:.2f} GiB")
    log("  device ms/step by stage (profiler ranges) "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; device busy {busy:.3f} ms/step")
    for key, ms in top:
        log(f"  {ms:8.3f} ms/step  {key[:90]}")
    measured = busy > 0
    inputs = capture_backward(step)
    return {"step_ms": step_ms, "step_ms_all": times,
            "stage_device_ms": stages, "n_pairs": m["n_pairs"],
            "peak_memory_bytes": peak,
            "device_busy_ms_per_step": busy if measured else None,
            "device_idle_share": 1 - busy / step_ms if measured else None,
            "top_device_ms_per_step": [[k[:90], ms] for k, ms in top],
            "inputs": inputs}


# --------------------------------------------------------------------------
# 10. the backward kernels vs their plain versions
# --------------------------------------------------------------------------


def plane_rel(a, b) -> float:
    """max |a - b| per column over that column's largest |b|."""
    return float(((a - b).abs().amax(0)
                  / b.abs().amax(0).clamp_min(1e-30)).max())


def bwd_work(pack, gids, tile_start, tile_count, tiles_x, n_contrib):
    """What the backward must do for these inputs: samples re-evaluated
    (slot < the pixel's n_contrib), of those with power <= 0 (an expf),
    applied (alpha >= 1/255) and unclamped (alpha < 0.99)."""
    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x,
                                     pack.device)
    start, count = tile_start.long(), tile_count.long()
    nc = n_contrib.long()
    nmax = torch.minimum(nc.max(dim=1).values, count)
    work = torch.zeros(4, dtype=torch.int64, device=pack.device)
    for k in range(int(nmax.max())):
        live = k < nmax
        att = pack[gids[torch.where(live, start + k, 0)].long()]
        dx, dy = px - att[:, 0:1], py - att[:, 1:2]
        power = (-0.5 * (att[:, 2:3] * dx * dx + att[:, 4:5] * dy * dy)
                 - att[:, 3:4] * dx * dy)
        alpha = torch.clamp_max(att[:, 8:9] * torch.exp(power),
                                composite.ALPHA_MAX)
        ev = live[:, None] & (k < nc)
        ex = ev & (power <= 0)
        app = ex & (alpha >= composite.ALPHA_MIN)
        unc = app & (alpha < composite.ALPHA_MAX)
        work += torch.stack([ev.sum(), ex.sum(), app.sum(), unc.sum()])
    return [int(v) for v in work]


def composite_bwd_checks(args) -> dict:
    pack, gids, start, count, tiles_x, t_fin, n_contrib, gc, gt = args
    k_rows = composite.composite_bwd(*args)
    p_rows = composite.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    err = float((k_rows - p_rows).abs().max())
    rel = plane_rel(k_rows, p_rows)
    again = composite.composite_bwd(*args)
    torch.cuda.synchronize()
    log(f"composite_bwd vs plain: max_abs_err {err:.3e}, per-plane relative "
        f"{rel:.3e} (tol {KERNEL_RSUM}), deterministic "
        f"{bool(torch.equal(k_rows, again))}")
    check(rel <= KERNEL_RSUM, "composite_bwd vs plain")
    check(torch.equal(k_rows, again), "composite_bwd is deterministic")

    ms = cuda_ms(lambda: composite.composite_bwd(*args), reps=20)
    plain_ms = cuda_ms(lambda: composite.composite_bwd_plain(*args), reps=1,
                       warm=1)
    ev, ex, app, unc = bwd_work(pack, gids, start, count, tiles_x, n_contrib)
    nt = start.shape[0]
    n_pix = nt * TILE * TILE
    n_used = int(torch.unique(gids).numel())
    # bytes: referenced attribute rows, the pair list and ranges, per pixel
    # t_fin, n_contrib, 3 colour and 1 t_fin cotangents read once; one
    # 36-byte row per pair written once
    nbytes = (36 * n_used + 4 * gids.numel() + 8 * nt + 24 * n_pix
              + 36 * gids.numel())
    # fp32 operations (kernel source, one per add/mul/compare/div, expf as
    # 1): 12 per re-evaluated sample, 4 more with an expf, 18 more applied,
    # 21 more unclamped; and one add per nonzero term into its pair's row:
    # r, g, b for every applied sample, the 6 alpha terms only unclamped
    ops = 12 * ev + 4 * ex + (18 + 3) * app + (21 + 6) * unc
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    log(f"backward work: samples re-evaluated / expf / applied / unclamped "
        f"{[ev, ex, app, unc]}, bytes {nbytes} "
        f"({t_bytes:.4f} ms), fp32 ops {ops} ({t_ops:.4f} ms)")
    log(f"composite_bwd {ms:.4f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "plane_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "ops": ops,
            "samples": [ev, ex, app, unc]}


def segsum_checks(args) -> dict:
    rows, gid, n, offsets = args
    k_out = segsum.sorted_segment_sum(*args)
    p_out = segsum.sorted_segment_sum_plain(rows, gid, n)
    scale = segsum.sorted_segment_sum_plain(rows.abs(), gid, n)
    torch.cuda.synchronize()
    err = float((k_out - p_out).abs().max())
    rel = float(((k_out - p_out).abs() / scale.clamp_min(1e-30)).max())
    log(f"sorted_segment_sum vs plain: max_abs_err {err:.3e}, relative to "
        f"each segment's sum of |terms| {rel:.3e} (tol {KERNEL_RSEG})")
    check(rel <= KERNEL_RSEG, "sorted_segment_sum vs plain")
    ms = cuda_ms(lambda: segsum.sorted_segment_sum(*args), reps=50)
    plain_ms = cuda_ms(lambda: segsum.sorted_segment_sum_plain(rows, gid, n),
                       reps=20)
    lib_ms = cuda_ms(lambda: torch.zeros((n, 9), device=rows.device)
                     .index_add_(0, gid, rows), reps=50)
    m = rows.shape[0]
    nbytes = 36 * m + 4 * (n + 1) + 36 * n   # rows, offsets; sums written
    ops = 9 * m                       # one add per input value
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    log(f"segment sum: {m} rows into {n} Gaussians, bytes {nbytes} "
        f"({t_bytes:.4f} ms), fp32 ops {ops} ({t_ops:.4f} ms); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms")
    return {"max_abs_err": err, "segment_rel_err": rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": lib_ms, "bytes": nbytes, "ops": ops, "rows": m,
            "n": n}


# --------------------------------------------------------------------------
# 11. a train step of a small scene on the CPU and on the card
# --------------------------------------------------------------------------


def cpu_vs_cuda_step(params, alive, cam, gt, n_small: int, seed: int):
    """One train step of the first ``n_small`` Gaussians at a quarter of the
    resolution on both devices, from the same state: the loss to 1e-4 and
    each group's gradient (Adam's first moment after one step) to 1e-3 of
    its largest value. CPU and CUDA libm round exp in the last bits, which
    may flip a sample at alpha = 1/255 or a pixel at the T = 1e-4 stop."""
    small = cam_mod.Camera(uid=cam.uid, viewmat=cam.viewmat, fx=cam.fx / 4,
                           fy=cam.fy / 4, width=cam.width // 4,
                           height=cam.height // 4)
    gt_small = torch.nn.functional.interpolate(
        gt.permute(2, 0, 1)[None].float(), size=(small.height, small.width),
        mode="area")[0].permute(1, 2, 0).round().to(torch.uint8).cpu()
    out = {}
    for dev in ("cpu", "cuda"):
        d = torch.device(dev)
        p = {k: v[:n_small].to(d).clone() for k, v in params.items()}
        state = train_state(p, alive[:n_small].to(d).clone(), d, seed)
        viewmat, intrin = cam_mod.camera_tensors(small, d)
        state, m = train_step_impl(
            state, viewmat, intrin, gt_small.to(d), small.uid,
            torch.zeros(3, device=d), 1.0, ocfg=OptimConfig(),
            image_size=(small.width, small.height), sh_degree=SH_DEGREE,
            use_appearance=True)
        mu = {k: v[0].cpu() for k, v in state.opt_g["mu"].items()}
        mu["embeddings"] = state.opt_a["mu"]["embeddings"][0].cpu()
        out[dev] = (float(m["loss"]), mu, m["n_pairs"])
    (l_cpu, g_cpu, np_cpu), (l_gpu, g_gpu, np_gpu) = out["cpu"], out["cuda"]
    rel = {k: float((g_gpu[k] - g_cpu[k]).abs().max()
                    / g_cpu[k].abs().max().clamp_min(1e-30)) for k in g_cpu}
    log(f"small train step cpu vs cuda: loss {l_cpu:.7f} / {l_gpu:.7f}, "
        f"gradient relative error {rel}, n_pairs {np_cpu} / {np_gpu}")
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), "CPU and CUDA losses")
    check(max(rel.values()) <= 1e-3, "CPU and CUDA gradients")
    return {"loss_cpu": l_cpu, "loss_cuda": l_gpu, "grad_rel": rel}


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one",
              file=sys.stderr)
        return 1
    smi = card()
    build()
    dev = torch.device("cuda")

    SCRATCH.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        t0 = time.perf_counter()
        scene, model = write_scene(Path(tmp), args.seed, N_GAUSSIANS,
                                   LLFFHOLD * TEST_VIEWS)
        log(f"scene: {N_GAUSSIANS} Gaussians, SH {SH_DEGREE}, "
            f"{LLFFHOLD * TEST_VIEWS} cameras at {W}x{H}, written in "
            f"{time.perf_counter() - t0:.1f} s")

        run = main_path(scene, model)

        params, alive = G.load_gaussians_ply(
            str(model / "point_cloud.ply"),
            G.GaussianConfig(sh_degree=SH_DEGREE, capacity=N_GAUSSIANS),
            dev)
        scene_info = load_colmap_scene(str(scene))
        infos = split_train_test(scene_info.cameras, True, LLFFHOLD)
        cams = [cam_mod.from_info(i, -1, load_image=False) for i in infos[1]]
        max_per_tile = OptimConfig().max_per_tile
        prep, bins = view_prep_bins(params, alive, cams[0], dev,
                                    max_per_tile)
        check(bins.n_pairs == run["views"][0]["n_pairs"],
              "the checked view is the CLI's first view")
        inputs = (composite.pack_attributes(prep), bins.gids,
                  bins.tile_start, bins.tile_count,
                  (cams[0].width + TILE - 1) // TILE)
        measured = {"composite_fwd": composite_checks(inputs, bins)}
        del prep, bins, inputs
        render = render_times(params, alive, cams, dev, max_per_tile)
        cpu_vs_cuda(params, alive, cams[0], 40_000)

        train = train_path(scene, Path(tmp) / "train")

        t_params, t_alive = G.load_gaussians_ply(
            str(model / "point_cloud.ply"),
            G.GaussianConfig(sh_degree=SH_DEGREE, capacity=CAPACITY), dev)
        cam = cam_mod.from_info(infos[0][0], -1)
        gt = torch.as_tensor(np.round(cam.gt_image * 255.0).astype(np.uint8),
                             device=dev)
        state = train_state(t_params, t_alive, dev, args.seed)
        step = train_times(state, cam, gt, OptimConfig(), scene_info.extent)
        inputs = step.pop("inputs")
        measured["composite_bwd"] = composite_bwd_checks(
            inputs["composite_bwd"])
        measured["sorted_segment_sum"] = segsum_checks(
            inputs["sorted_segment_sum"])
        del inputs, state
        small = cpu_vs_cuda_step(params, alive, cam, gt, 40_000, args.seed)

    print(json.dumps({"render": dict(render, views=run["views"]),
                      "train": dict(train, step=step, small=small)}))
    print(json.dumps({"kernels": [
        dict(k, launches=train["launches"][k["name"]],
             launches_by_path={"render": run["launches"].get(k["name"], 0),
                               "train": train["launches"][k["name"]]},
             **measured[k["name"]])
        for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
