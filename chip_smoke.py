#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render, training, eval and gather-experiment
paths on one CUDA card and hold every kernel on them against its plain
PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run it from the root of a checkout: it builds the kernels from the sources
there, needs no install step and nothing from the network. Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the TF32 flags;
2. build every kernel of the paths (one ``nvcc`` per source, together);
3. write a synthetic scene from ``--seed``: a COLMAP binary model of
   1280x800 cameras with GT PNGs and ``N_GAUSSIANS`` points, and a Gaussian
   PLY at SH degree 3 whose density statistics are those of the repo's
   reference-scale bench scene (``tools/bench_scene.py`` at 719k Gaussians,
   1280x800); the test views' GT is the PLY's own render on the card under
   a per-view color warp;
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
    bounds; then ``composite_fwd`` and ``composite_bwd`` against their plain
    versions on tile loads shaped like a real block's (p50 960, p99 2100,
    max 2640 pairs a tile) at 1280x800, with their times and bounds;
11. one train step of a small scene on the CPU and on the card;
12. the eval path: ``pcp_tpu_torch.cli.metrics.main`` on ``cuda`` over the
    8 test views that phase 4 rendered, with a synthetic LPIPS bundle drawn
    from ``--seed`` (no pretrained weights are in the repo, so every LPIPS
    value here is synthetic); then the per-view device time of the color
    correction, SSIM and LPIPS at 1280x800;
13. ``evaluate_images`` on 3 small views on the CPU and on the card;
14. ``pcp_tpu_torch.cli.full_eval.main`` on ``cuda``: a small scene, linked
    as Tanks&Temples' ``truck`` and ``train``, through train -> render ->
    metrics for ``FULL_EVAL_ITERS`` iterations;
15. the gather experiment (``pcp_tpu_torch.tools.exp_r2 gather``) at its
    default shapes and at N = 2^20, each of its three forms held bit for
    bit to the plain version; ``sort`` and ``xlagather`` once;
16. one ``{"kernels": [...]}`` line, the card's name and power limit, and
    the ``{"ok": true, ...}`` line last.

Paths 4, 8, 12, 14 and 15 each run with every launch count set to 0 just
before and read just after.

Any failed check raises: the script then exits non-zero and prints no
result line. Without a CUDA card it exits 1 before doing anything.

    python3 chip_smoke.py --full-eval-runs 20 [--cudnn-deterministic]

runs phases 1, 2 and then only phase 14, that many times on the same
scene, and prints each run's PSNR and SSIM per scene as one JSON line:
the spread of ``full_eval``'s metrics from run to run.
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

from pcp_tpu_torch.cli import full_eval as full_eval_cli
from pcp_tpu_torch.cli import metrics as metrics_cli
from pcp_tpu_torch.cli import render as render_cli
from pcp_tpu_torch.cli import train as train_cli
from pcp_tpu_torch.device import resolve_device
from pcp_tpu_torch.eval.lpips import make_lpips, synthetic_weights
from pcp_tpu_torch.eval.metrics import _load_image, evaluate_images
from pcp_tpu_torch.eval.render_batch import render_view
from pcp_tpu_torch.io import colmap
from pcp_tpu_torch.io.ply import save_gaussian_ply
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.models.appearance import init_appearance
from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops import composite, segsum
from pcp_tpu_torch.ops.gather import LAYOUTS, gather_pack, gather_pack_plain
from pcp_tpu_torch.ops import rasterize as rasterize_mod
from pcp_tpu_torch.ops.binning import bin_gaussians
from pcp_tpu_torch.ops.projection import TILE, preprocess
from pcp_tpu_torch.ops.rasterize import rasterize, untile
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.scene import load_colmap_scene, split_train_test
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.tools import exp_r2
from pcp_tpu_torch.tools.blend_inputs import blend_inputs, real_block_counts
from pcp_tpu_torch.train.step import TrainState, app_groups, train_step_impl
from pcp_tpu_torch.utils.graphics import rotmat_to_qvec
from pcp_tpu_torch.utils.image import color_correct
from pcp_tpu_torch.utils.loss import ssim
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
# full_eval: a small scene (4 cameras, the first a test view at llffhold
# 83) trained for a few steps, in seconds
FULL_EVAL_GAUSSIANS, FULL_EVAL_ITERS = 20_000, 10
GATHER_N = (exp_r2.N, 1 << 20)     # the JAX tool's pack; the port's slots

# Every kernel of the paths. ``replaces`` is the TPU kernel's pallas_call.
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
    {"name": "gather_pack", "route": "cuda",
     "source": "pcp_tpu_torch/csrc/gather_pack.cu",
     "replaces": "tools/exp_r2.py:80"},
]

# Forward kernel vs plain version on the card: every decision (power, the
# 1/255 test, the T < 1e-4 stop) and T take the plain version's fp32
# operations in its order (built with --fmad=false), and a warp passes over
# a row only where the row's box, which holds every applied pixel, misses
# it; so t_fin and n_contrib agree but where expf rounds otherwise and flips
# a threshold. The colour sums are FMAs, a few ulp from the plain version's
# mul-then-add.
KERNEL_ATOL = 1e-5
NCONTRIB_AGREE = 0.9999
# The backward and the segment sum take their sums in another order than
# the plain version: the backward's 256-pixel reduction (a transposed warp
# butterfly, then the warps in order), its FMAs and one reciprocal of
# 1 - alpha for two divisions, each plane to 1e-5 of its largest value; the
# segment sum against index_add_'s atomics, to 1e-6 of the sum of |terms| of
# each segment (fp32 rounding grows with a segment's length).
KERNEL_RSUM = 1e-5
KERNEL_RSEG = 1e-6
# The eval path on the card against the CPU, as tests/test_torch_eval.py
# holds the port against the JAX package: PSNR in dB, SSIM absolute, LPIPS
# relative.
EVAL_TOL = {"PSNR": 1e-3, "SSIM": 1e-5, "LPIPS": 1e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def counts() -> dict:
    """Launches of each kernel of KERNELS since LAUNCHES was cleared; the
    gather counts its three layouts' entry points together."""
    out = {k["name"]: composite.LAUNCHES[k["name"]] for k in KERNELS}
    out["gather_pack"] = sum(composite.LAUNCHES[f"gather_pack_{lay}"]
                             for lay in LAYOUTS)
    return out


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


def write_scene(root: Path, seed: int, n: int, n_cams: int, dev) -> tuple:
    """COLMAP model + GT PNGs under ``root/scene`` and a Gaussian PLY at
    ``root/model/point_cloud.ply``.

    The Gaussians follow tools/bench_scene.py: depths 8..60 filling a
    1280x800 frustum with ~20% spill, splat sigma lognormal in pixels
    (median 4 px x sqrt(100k / n), log-std 0.6) with mild anisotropy,
    opacity uniform in [0.1, 0.8]; here also random rotations and SH rest
    coefficients so SH degree 3 does work. The COLMAP points are the same
    ``n`` positions, so training starts at full width. Cameras jitter
    around the bench camera by a few degrees and a little translation.

    GT images: the training views' are colour ramps. The test views' (every
    LLFFHOLD-th camera from the first) are the PLY rendered on ``dev`` under
    a per-view exposure, white balance and gamma, plus noise: what a scored
    model's photographs look like, with a real colour warp for the eval's
    correction to undo (a grey GT would leave it a singular system)."""
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
        if i % LLFFHOLD:
            gt = np.broadcast_to((ramp + 9 * i) % 256, (H, W, 3))
            PILImage.fromarray(gt.astype(np.uint8)).save(
                scene / "images" / name)
        images[i + 1] = colmap.Image(i + 1, rotmat_to_qvec(R), t, 1, name)
    pts = colmap.Points3D.from_arrays(
        xyz, rng.integers(0, 256, (n, 3)).astype(np.uint8))
    colmap.write_model(cams, images, pts, str(scene / "sparse" / "0"),
                       ext=".bin")

    params, alive = G.load_gaussians_ply(
        str(model / "point_cloud.ply"),
        G.GaussianConfig(sh_degree=SH_DEGREE, capacity=n), dev)
    bg = torch.zeros(3, device=dev)
    for info in load_colmap_scene(str(scene)).cameras[::LLFFHOLD]:
        img, _ = render_view(params, alive,
                             cam_mod.from_info(info, -1, load_image=False),
                             SH_DEGREE, bg, device=dev)
        gain = np.exp(rng.uniform(-0.2, 0.2) + rng.uniform(-0.1, 0.1, 3))
        photo = img ** rng.uniform(0.9, 1.1) * gain + rng.normal(
            0.0, 0.02, img.shape)
        PILImage.fromarray((np.clip(photo, 0, 1) * 255).astype(np.uint8)
                           ).save(info.image_path)
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
    launches = counts()
    views = stats["test"]
    out = model / "test" / "ours_merged"
    for sub in ("renders", "gt"):
        pngs = sorted(os.listdir(out / sub))
        check(pngs == [f"{i:05d}.png" for i in range(len(views))],
              f"{sub}/ holds one PNG per view")
    check(launches == {"composite_fwd": len(views), "composite_bwd": 0,
                       "sorted_segment_sum": 0, "gather_pack": 0},
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


def _slot_samples(pack, gids, start, live, px, py, block_h):
    """power and alpha of slot k of every tile (``start`` = tile_start + k)
    at its 256 pixels, and (nt, warps) whether the slot's box of applicable
    pixels (``composite.pixel_box``) meets each warp's pixels: 8-wide blocks
    ``block_h`` rows tall, two across the tile, in warp order."""
    att = pack[gids[torch.where(live, start, 0)].long()]
    dx, dy = px - att[:, 0:1], py - att[:, 1:2]
    power = (-0.5 * (att[:, 2:3] * dx * dx + att[:, 4:5] * dy * dy)
             - att[:, 3:4] * dx * dy)
    alpha = torch.clamp_max(att[:, 8:9] * torch.exp(power),
                            composite.ALPHA_MAX)
    box = composite.pixel_box(att)
    w = torch.arange(2 * TILE // block_h, device=pack.device)
    sx = px[:, :1] + 8 * (w % 2)
    sy = py[:, :1] + block_h * (w // 2)
    meets = ((box[:, 1:2] >= sx) & (box[:, 0:1] <= sx + 7)
             & (box[:, 3:4] >= sy) & (box[:, 2:3] <= sy + block_h - 1))
    return power, alpha, meets


def warp_of_pixel(block_h: int, device) -> torch.Tensor:
    """(256,) the warp that owns each pixel of a tile, for 8 x ``block_h``
    warp blocks as ``_slot_samples`` lays them out."""
    lane = torch.arange(TILE * TILE, device=device)
    return (lane % TILE) // 8 + 2 * ((lane // TILE) // block_h)


def blend_work(pack, gids, tile_start, tile_count, tiles_x):
    """What the blend must do for these inputs, slot by slot as the plain
    version walks them: samples evaluated (pixel not yet done), of those
    with power <= 0 (an expf), with alpha >= 1/255 (tested against the
    stop) and applied; the same four over the samples of the (warp, slot)
    pairs whose box meets the forward kernel's 8x4-pixel warp (the kernel
    walks only these pairs, the box test settles the rest); and the
    (warp, slot) pairs, in all and walked. Checks that every tested sample
    lies in a walked pair."""
    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x,
                                     pack.device)
    owner = warp_of_pixel(4, pack.device)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    start, count = tile_start.long(), tile_count.long()
    work = torch.zeros(10, dtype=torch.int64, device=pack.device)
    for k in range(int(count.max()) if count.numel() else 0):
        live = k < count
        power, alpha, meets = _slot_samples(pack, gids, start + k, live, px,
                                            py, 4)
        walked = live[:, None] & meets
        ev = live[:, None] & ~done
        ex = ev & (power <= 0)
        ok = ex & (alpha >= composite.ALPHA_MIN)
        test_t = T * (1 - alpha)
        stop = ok & (test_t < composite.T_EPS)
        app = ok & ~stop
        done |= stop
        T = torch.where(app, test_t, T)
        each = (ev, ex, ok, app)
        work += torch.stack([m.sum() for m in each]
                            + [(m & walked[:, owner]).sum() for m in each]
                            + [live.sum() * meets.shape[1], walked.sum()])
    work = [int(v) for v in work]
    check(work[6:8] == work[2:4], f"the box holds every tested sample: {work}")
    return work


def bwd_work(pack, gids, tile_start, tile_count, tiles_x, n_contrib):
    """What the backward must do for these inputs: samples re-evaluated
    (slot < the pixel's n_contrib), of those with power <= 0 (an expf),
    applied (alpha >= 1/255) and unclamped (alpha < 0.99); the same four
    over the samples of the (warp, slot) pairs whose box meets the backward
    kernel's 8x8-pixel warp (the kernel walks only these pairs); and the
    (warp, slot) pairs below the warp's largest n_contrib, which the kernel
    tests, in all and walked. Checks that every applied sample lies in a
    walked pair."""
    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x,
                                     pack.device)
    start, count = tile_start.long(), tile_count.long()
    nc = n_contrib.long()
    nmax = torch.minimum(nc.max(dim=1).values, count)
    owner = warp_of_pixel(8, pack.device)
    warp_nc = torch.stack([nc[:, owner == w].max(dim=1).values
                           for w in range(4)], dim=1)
    warp_nc = torch.minimum(warp_nc, nmax[:, None])
    work = torch.zeros(10, dtype=torch.int64, device=pack.device)
    for k in range(int(nmax.max()) if nmax.numel() else 0):
        live = k < nmax
        power, alpha, meets = _slot_samples(pack, gids, start + k, live, px,
                                            py, 8)
        tested = k < warp_nc
        walked = tested & meets
        ev = live[:, None] & (k < nc)
        ex = ev & (power <= 0)
        app = ex & (alpha >= composite.ALPHA_MIN)
        unc = app & (alpha < composite.ALPHA_MAX)
        each = (ev, ex, app, unc)
        work += torch.stack([m.sum() for m in each]
                            + [(m & walked[:, owner]).sum() for m in each]
                            + [tested.sum(), walked.sum()])
    work = [int(v) for v in work]
    check(work[6:8] == work[2:4],
          f"the box holds every applied sample: {work}")
    return work


# fp32 operations, counted on the plain per-pixel loop (one per add, mul,
# compare or division, an expf as 1), over the samples of the walked
# (warp, slot) pairs; the samples the box test passes over need none of
# them, and the test itself is 4 compares per (warp, slot) pair. The dense
# count charges every sample the plain loop evaluates (PR 4's bound).
BOX_TEST_OPS = 4


def fwd_bound(pack, gids, tile_start, work) -> dict:
    """The forward's bound on these inputs (``blend_work``'s counts)."""
    ev, ex, ok, app, wev, wex, _, _, slots, _ = work
    nt = tile_start.shape[0]
    # bytes: each referenced attribute row, the pair list and the ranges
    # read once; color, t_fin and n_contrib written once
    n_rows = int(torch.unique(gids).numel())
    nbytes = 36 * n_rows + 4 * gids.numel() + 8 * nt + 20 * nt * TILE * TILE
    # 12 per evaluated sample, 4 more with an expf, 3 more tested, 7 more
    # applied
    ops = (12 * wev + 4 * wex + 3 * ok + 7 * app + BOX_TEST_OPS * slots)
    dense = 12 * ev + 4 * ex + 3 * ok + 7 * app
    return dict(bound(nbytes, ops),
                dense_bound_ms=bound(nbytes, dense)["bound_ms"])


def bwd_bound(gids, tile_start, work) -> dict:
    """The backward's bound on these inputs (``bwd_work``'s counts)."""
    ev, ex, app, unc, wev, wex, _, _, slots, _ = work
    nt = tile_start.shape[0]
    n_pix = nt * TILE * TILE
    n_used = int(torch.unique(gids).numel())
    # bytes: referenced attribute rows, the pair list and ranges, per pixel
    # t_fin, n_contrib, 3 colour and 1 t_fin cotangents read once; one
    # 36-byte row per pair written once
    nbytes = (36 * n_used + 4 * gids.numel() + 8 * nt + 24 * n_pix
              + 36 * gids.numel())
    # 12 per re-evaluated sample, 4 more with an expf, 18 more applied, 21
    # more unclamped; and one add per nonzero term into its pair's row: r,
    # g, b for every applied sample, the 6 alpha terms only unclamped
    applied = (18 + 3) * app + (21 + 6) * unc
    ops = 12 * wev + 4 * wex + applied + BOX_TEST_OPS * slots
    dense = 12 * ev + 4 * ex + applied
    return dict(bound(nbytes, ops),
                dense_bound_ms=bound(nbytes, dense)["bound_ms"])


def bound(nbytes: int, ops: int) -> dict:
    """The least time for the work on one H100, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops}


def _bound_text(b: dict) -> str:
    return (f"bytes {b['bytes']} ({b['bytes_ms']:.4f} ms), fp32 ops "
            f"{b['ops']} ({b['ops_ms']:.4f} ms), dense bound "
            f"{b['dense_bound_ms']:.4f} ms")


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
    work = blend_work(*args)
    b = fwd_bound(pack, gids, start, work)
    log(f"blend work: n_pairs {bins.n_pairs}, max_tile_load "
        f"{int(bins.max_tile_load)}, samples evaluated / expf / tested / "
        f"applied, the same in walked (warp, slot) pairs, warp-slots / "
        f"walked {work}; passed over by the box {work[0] - work[4]}; "
        f"{_bound_text(b)}")
    log(f"composite_fwd {ms:.4f} ms ({b['bound_ms'] / ms:.1%} of its bound, "
        f"{b['dense_bound_ms'] / ms:.1%} of the dense one), plain "
        f"{plain_ms:.3f} ms")
    return dict(b, max_abs_err=err, n_contrib_agree=agree, ms=ms,
                kernel_ms=ms, plain_ms=plain_ms, library_ms=None,
                samples=work, n_pairs=bins.n_pairs,
                max_tile_load=int(bins.max_tile_load))


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
    launches = counts()
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
    work = bwd_work(pack, gids, start, count, tiles_x, n_contrib)
    b = bwd_bound(gids, start, work)
    log(f"backward work: samples re-evaluated / expf / applied / unclamped, "
        f"the same in walked (warp, slot) pairs, warp-slots / walked "
        f"{work}; passed over by the box {work[0] - work[4]}; "
        f"{_bound_text(b)}")
    log(f"composite_bwd {ms:.4f} ms ({b['bound_ms'] / ms:.1%} of its bound, "
        f"{b['dense_bound_ms'] / ms:.1%} of the dense one), plain "
        f"{plain_ms:.3f} ms")
    return dict(b, max_abs_err=err, plane_rel_err=rel, ms=ms,
                plain_ms=plain_ms, library_ms=None, samples=work)


def real_block_checks(seed: int, dev) -> dict:
    """``composite_fwd`` and ``composite_bwd`` at 1280x800 on tile loads
    shaped like a real block's (``real_block_counts``: p50 960, p99 2100,
    max 2640 pairs a tile; one seeded Gaussian per pair), held against
    their plain versions as on the phase inputs, with their times, sample
    counts and bounds; the backward's cotangents are seeded normals."""
    tiles_x, tiles_y = W // TILE, H // TILE
    rng = np.random.default_rng(seed)
    args = blend_inputs(rng, tiles_x, real_block_counts(
        rng, tiles_x * tiles_y), dev)
    pack, gids, start, count, _ = args
    color, t_fin, n_contrib = composite.composite_fwd(*args)
    p_color, p_tfin, p_nc = composite.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    err = max(float((color - p_color).abs().max()),
              float((t_fin - p_tfin).abs().max()))
    agree = float((n_contrib == p_nc).float().mean())
    check(err <= KERNEL_ATOL and agree >= NCONTRIB_AGREE,
          f"composite_fwd vs plain on real-block loads: {err}, {agree}")
    fwd_ms = cuda_ms(lambda: composite.composite_fwd(*args), reps=20)
    work = blend_work(*args)
    fwd = dict(fwd_bound(pack, gids, start, work), ms=fwd_ms,
               max_abs_err=err, n_contrib_agree=agree, samples=work)

    g = torch.Generator(device=dev).manual_seed(seed)
    bargs = (*args, t_fin, n_contrib,
             torch.randn(color.shape, generator=g, device=dev),
             torch.randn(t_fin.shape, generator=g, device=dev))
    rows = composite.composite_bwd(*bargs)
    plain = composite.composite_bwd_plain(*bargs)
    again = composite.composite_bwd(*bargs)
    torch.cuda.synchronize()
    rel = plane_rel(rows, plain)
    check(rel <= KERNEL_RSUM and torch.equal(rows, again),
          f"composite_bwd vs plain on real-block loads: {rel}, deterministic "
          f"{bool(torch.equal(rows, again))}")
    bwd_ms = cuda_ms(lambda: composite.composite_bwd(*bargs), reps=20)
    work = bwd_work(pack, gids, start, count, args[4], n_contrib)
    bwd = dict(bwd_bound(gids, start, work), ms=bwd_ms,
               max_abs_err=float((rows - plain).abs().max()),
               plane_rel_err=rel, samples=work)
    loads = count.float()
    shape = {"n_pairs": int(gids.numel()), "tiles": int(count.numel()),
             "p50": float(loads.quantile(0.5)),
             "p99": float(loads.quantile(0.99)), "max": int(count.max())}
    for name, r in (("composite_fwd", fwd), ("composite_bwd", bwd)):
        log(f"{name} on real-block loads {shape}: {r['ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of its {r['bound_ms']:.4f} ms "
            f"{r['bound_by']} bound, {r['dense_bound_ms'] / r['ms']:.1%} of "
            f"the dense one), samples {r['samples']}, "
            f"err {r['max_abs_err']:.3e}")
    return {"composite_fwd": dict(fwd, loads=shape),
            "composite_bwd": dict(bwd, loads=shape)}


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
# 12. the eval path
# --------------------------------------------------------------------------


def write_lpips_bundle(path: Path, seed: int) -> str:
    """``synthetic_weights(seed)`` as an ``.npz``: random AlexNet-LPIPS
    weights, a stand-in until the pretrained weights are in the repo, so
    every LPIPS value they give is synthetic."""
    np.savez(path, **synthetic_weights(seed))
    return str(path)


def eval_path(model: Path, weights: str) -> dict:
    """``cli.metrics`` on the card over the test views the render path
    wrote; checks the files, the values and that no kernel launched."""
    mdir = model / "test" / "ours_merged"
    names = [f"{i:05d}.png" for i in range(TEST_VIEWS)]
    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = metrics_cli.main(["-m", str(model), "--lpips_weights", weights,
                            "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    check(list(res) == [str(mdir)], f"one method dir scored: {list(res)}")
    per_view = json.loads((mdir / "per_view.json").read_text())
    mean = json.loads((mdir / "results.json").read_text())
    check(sorted(per_view) == names, "per_view.json holds every test view")
    check(sorted(os.listdir(mdir / "renders_cc")) == names,
          "renders_cc/ holds every test view")
    check(mean == res[str(mdir)]["mean"], "results.json is the mean")
    for name, row in per_view.items():
        check(all(math.isfinite(row[k]) for k in ("PSNR", "SSIM", "LPIPS")),
              f"finite PSNR, SSIM and LPIPS for {name}: {row}")
        check(-1.0 <= row["SSIM"] <= 1.0, f"SSIM in [-1, 1] for {name}")
    check(not any(launches.values()),
          f"the eval path launches none of the port's kernels: {launches}")
    log(f"cli metrics: {len(per_view)} views in {wall:.2f} s "
        f"({wall * 1e3 / len(per_view):.1f} ms/view with PNG I/O), mean "
        f"{mean} (LPIPS synthetic)")
    return {"launches": launches, "wall_s": wall,
            "wall_ms_per_view": wall * 1e3 / len(per_view), "mean": mean,
            "per_view": per_view, "lpips_synthetic": True}


def eval_times(mdir: Path, weights: str, dev) -> dict:
    """Per-view times of the eval path's three stages on view 0 at full
    size: CUDA-event ms (host waits included: every ``linalg.solve``
    checks its result on the host) and device busy ms from the profiler.
    Also LPIPS(x, x)."""
    r = torch.as_tensor(_load_image(str(mdir / "renders" / "00000.png")),
                        device=dev)
    g = torch.as_tensor(_load_image(str(mdir / "gt" / "00000.png")),
                        device=dev)
    lpips_fn = make_lpips(weights, dev)
    rc = torch.clamp(color_correct(r, g), 0.0, 1.0)
    stages = {
        "color_correct": lambda: color_correct(r, g),
        "ssim": lambda: ssim(rc.permute(2, 0, 1), g.permute(2, 0, 1)),
        "lpips": lambda: lpips_fn(rc, g),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    out = {}
    with torch.no_grad():
        same = float(lpips_fn(rc, rc))
        for name, fn in stages.items():
            ms = cuda_ms(fn, reps=5)
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            busy = sum(v for _, v in device_kernels(prof, 3))
            out[name] = {"ms": ms, "device_busy_ms": busy}
    check(abs(same) <= 1e-6, f"LPIPS(x, x) = 0: {same}")
    log(f"eval per view at {r.shape[1]}x{r.shape[0]} (ms by CUDA events / "
        f"device busy): " + ", ".join(
            f"{k} {v['ms']:.3f} / {v['device_busy_ms']:.3f}"
            for k, v in out.items()) + f"; LPIPS(x, x) {same}")
    return dict(out, lpips_same=same)


# --------------------------------------------------------------------------
# 13. evaluate_images on the CPU and on the card
# --------------------------------------------------------------------------


def eval_cpu_vs_cuda(weights: str, seed: int) -> dict:
    """3 views at 120x160: GT noise, renders a color warp of it."""
    rng = np.random.default_rng(seed)
    gts = [rng.uniform(0, 1, (120, 160, 3)).astype(np.float32)
           for _ in range(3)]
    renders = [np.clip(0.8 * x + 0.15 * x * x + 0.05 + rng.normal(
        0, 0.05, x.shape), 0, 1).astype(np.float32) for x in gts]
    out = {dev: evaluate_images(renders, gts, lpips_weights=weights,
                                device=dev)["per_view"]
           for dev in ("cpu", "cuda")}
    worst = dict.fromkeys(EVAL_TOL, 0.0)
    for name, row in out["cpu"].items():
        for k in EVAL_TOL:
            a, b = out["cuda"][name][k], row[k]
            worst[k] = max(worst[k], abs(a - b) / (abs(b) if k == "LPIPS"
                                                   else 1.0))
    log(f"evaluate_images cpu vs cuda, 3 views at 160x120: largest "
        f"difference {worst} (tol {EVAL_TOL}; LPIPS relative)")
    check(all(worst[k] <= EVAL_TOL[k] for k in EVAL_TOL),
          "evaluate_images agrees on the CPU and the card")
    return {"worst": worst, "per_view": out}


# --------------------------------------------------------------------------
# 14. full_eval
# --------------------------------------------------------------------------


def full_eval_path(root: Path, seed: int, dev) -> dict:
    """``cli.full_eval`` on the card over a small scene linked as both
    Tanks&Temples scenes: train, render and score each."""
    scene, _ = write_scene(root, seed, FULL_EVAL_GAUSSIANS, 4, dev)
    tt = root / "tanksandtemples"
    tt.mkdir()
    for name in full_eval_cli.TANKS_AND_TEMPLES:
        (tt / name).symlink_to(scene)
    out = root / "eval"
    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = full_eval_cli.main(["--tanksandtemples", str(tt), "--output_path",
                              str(out), "--iterations", str(FULL_EVAL_ITERS),
                              "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    n = len(full_eval_cli.TANKS_AND_TEMPLES)
    check(sorted(res) == sorted(
        str(out / s / "test" / f"ours_{FULL_EVAL_ITERS}")
        for s in full_eval_cli.TANKS_AND_TEMPLES),
        f"full_eval scored both scenes: {sorted(res)}")
    for mdir, r in res.items():
        check(json.loads((Path(mdir) / "results.json").read_text())
              == r["mean"], f"{mdir}/results.json is written")
        check(math.isfinite(r["mean"]["PSNR"])
              and math.isfinite(r["mean"]["SSIM"]), f"finite metrics: {r}")
    # per scene: a forward and a backward per step, a forward for the one
    # test view at the eval and one more when the render CLI draws it
    check(launches == {"composite_fwd": n * (FULL_EVAL_ITERS + 2),
                       "composite_bwd": n * FULL_EVAL_ITERS,
                       "sorted_segment_sum": n * FULL_EVAL_ITERS,
                       "gather_pack": 0},
          f"full_eval's launches: {launches}")
    log(f"cli full_eval: {n} scenes x {FULL_EVAL_ITERS} iterations, "
        f"render and metrics in {wall:.1f} s, launches {launches}, means "
        f"{ {Path(k).parts[-3]: v['mean'] for k, v in res.items()} }")
    return {"launches": launches, "wall_s": wall,
            "means": {Path(k).parts[-3]: v["mean"] for k, v in res.items()}}


def full_eval_spread(runs: int, seed: int, deterministic: bool, dev) -> dict:
    """Phase 14 ``runs`` times on the scene of ``seed``, with
    ``torch.backends.cudnn.deterministic`` set as asked: each scene's PSNR
    and SSIM in every run."""
    torch.backends.cudnn.deterministic = deterministic
    SCRATCH.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        means = [full_eval_path(Path(tmp) / f"run{i}", seed, dev)["means"]
                 for i in range(runs)]
    return {"full_eval_runs": runs, "cudnn_deterministic": deterministic,
            **{k: {s: [m[s][k] for m in means] for s in means[0]}
               for k in ("PSNR", "SSIM")}}


# --------------------------------------------------------------------------
# 15. the gather experiment
# --------------------------------------------------------------------------


def gather_path() -> dict:
    """``exp_r2 gather`` through the tool's entry point at each N."""
    composite.LAUNCHES.clear()
    runs = {n: exp_r2.main(["gather", "--n", str(n)])["gather"]
            for n in GATHER_N}
    torch.cuda.synchronize()
    launches = counts()
    by_layout = {lay: composite.LAUNCHES[f"gather_pack_{lay}"]
                 for lay in LAYOUTS}
    check(all(f["ok"] for r in runs.values() for f in r["forms"].values()),
          "every gather form passes the tool's spot check")
    check(all(by_layout.values()) and launches["gather_pack"]
          == sum(by_layout.values()) and not any(
              v for k, v in launches.items() if k != "gather_pack"),
          f"the gather path launches each layout's kernel: {by_layout}")
    return {"runs": runs, "launches": launches, "by_layout": by_layout}


def gather_checks(runs: dict, dev) -> dict:
    """Each form bit for bit against the plain version on the tool's
    inputs at each N, and the bound from the bytes the tool counted."""
    by_n = {}
    for n, r in runs.items():
        pack, ids = exp_r2.make_inputs(n, r["na"], r["nt"], r["k"], 0, dev)
        pack_t = pack.T.contiguous()
        errs = {}
        for name, layout in exp_r2.FORMS:
            src = pack_t if layout == "plane" else pack
            out = gather_pack(src, ids, layout)
            plain = gather_pack_plain(src, ids, layout)
            torch.cuda.synchronize()
            check(torch.equal(out, plain),
                  f"{name} at N={n} equals the plain version bit for bit")
            errs[name] = float((out - plain).abs().max())
        bound = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_n[n] = {"bytes": r["bytes"], "bound_ms": bound,
                   "plain_ms": r["plain_ms"], "max_abs_err": errs,
                   "ms": {f: v["ms"] for f, v in r["forms"].items()}}
        log(f"gather N={n}: forms (ms) {by_n[n]['ms']}, plain = index_select "
            f"{r['plain_ms']:.4f} ms, bytes {r['bytes']} (bound "
            f"{bound:.4f} ms), bit-equal to plain")
    first = by_n[GATHER_N[0]]
    # the headline is the row form, the layout the composite kernels use,
    # at the tool's default shapes; the plain version is the library call
    return {"max_abs_err": max(max(b["max_abs_err"].values())
                               for b in by_n.values()),
            "ms": first["ms"]["form2_row_take"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": first["plain_ms"], "by_n": by_n}


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-eval-runs", type=int, default=0,
                    help="run only phase 14, this many times")
    ap.add_argument("--cudnn-deterministic", action="store_true",
                    help="with --full-eval-runs: cuDNN's deterministic "
                    "algorithms only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on one",
              file=sys.stderr)
        return 1
    smi = card()
    build()
    dev = torch.device("cuda")
    if args.full_eval_runs:
        print(json.dumps(full_eval_spread(args.full_eval_runs, args.seed + 1,
                                          args.cudnn_deterministic, dev)))
        return 0

    SCRATCH.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        t0 = time.perf_counter()
        scene, model = write_scene(Path(tmp), args.seed, N_GAUSSIANS,
                                   LLFFHOLD * TEST_VIEWS, dev)
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
        for name, r in real_block_checks(args.seed, dev).items():
            measured[name]["real_block"] = r
        small = cpu_vs_cuda_step(params, alive, cam, gt, 40_000, args.seed)

        weights = write_lpips_bundle(Path(tmp) / "lpips.npz", args.seed)
        ev = eval_path(model, weights)
        ev["times"] = eval_times(model / "test" / "ours_merged", weights, dev)
        ev["cpu_vs_cuda"] = eval_cpu_vs_cuda(weights, args.seed)
        fe = full_eval_path(Path(tmp) / "full_eval", args.seed + 1, dev)

        gather = gather_path()
        measured["gather_pack"] = gather_checks(gather["runs"], dev)
        other = exp_r2.main(["sort"])
        other.update(exp_r2.main(["xlagather"]))

    paths = {"render": run["launches"], "train": train["launches"],
             "metrics": ev["launches"], "full_eval": fe["launches"],
             "exp_r2": gather["launches"]}
    main_path_of = {"composite_fwd": "train", "composite_bwd": "train",
                    "sorted_segment_sum": "train", "gather_pack": "exp_r2"}
    print(json.dumps({"render": dict(render, views=run["views"]),
                      "train": dict(train, step=step, small=small),
                      "eval": ev, "full_eval": fe,
                      "exp_r2": dict(other, gather_by_layout=gather[
                          "by_layout"])}))
    print(json.dumps({"kernels": [
        dict(k, launches=paths[main_path_of[k["name"]]][k["name"]],
             launches_by_path={p: c[k["name"]] for p, c in paths.items()},
             **measured[k["name"]])
        for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
