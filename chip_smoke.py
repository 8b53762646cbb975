#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render, training, eval, pipeline,
multi-card, viewer, gather-experiment and quality paths on one CUDA card
and hold every kernel on them against its plain PyTorch version.

    python3 chip_smoke.py [--seed 0]

Run it from the root of a checkout: it builds the kernels from the sources
there, needs no install step and nothing from the network. Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the TF32 and cuDNN flags ``resolve_device`` sets;
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
   marks, device busy time and idle share; then the warm step and device
   busy time again with ``cudnn.deterministic`` forced off after each
   ``resolve_device``: what determinism costs;
10. ``composite_bwd`` and the segment-sum stage (``pack_gradient``:
    ``gathered_segment_sum``, which inverts the sort's permutation and sums
    each Gaussian's rows through it) against their plain versions on the
    inputs they got in that step (the segment sum and its plain twin each
    also against the float64 sum of the same rows), with their times and
    bounds; then
    ``composite_fwd`` and ``composite_bwd`` against their plain versions on
    tile loads shaped like a real block's (p50 960, p99 2100, max 2640
    pairs a tile) at 1280x800, with their times and bounds;
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
15. the pipeline: an aerial COLMAP scene from ``--seed`` (``PIPE_POINTS``
    points over a few hundred metres of terrain, ``PIPE_CAMS`` cameras at
    1280x800 looking down, GT rendered on the card), then
    ``cli.partition`` (outlier removal on, threshold 500000),
    ``cli.auto_train --sequential`` (every block at full width for
    ``PIPE_ITERS`` steps with a densify and a checkpoint), two
    ``cli.train --start_checkpoint`` resumes of one block (the same bits),
    ``cli.merge``, ``cli.render`` of the held-out views and
    ``cli.metrics``; with the native libraries loaded and the card's
    outlier screen held to the native filter;
16. the multi-card slice on the one card, on phase 15's 4 blocks through
    ``cli.auto_train``: (a) the fleet (the default mode) with the cameras
    and uint8 GT on the card and a rolling checkpoint at PIPE_CKPT, every
    block marked done, block 0's PLY equal to phase 15's sequential block
    0 byte for byte, and B1, B2 and B3 launched once per block step (B1
    also per eval view); (b) ``--share_appearance`` host-fed, every
    block's checkpoint holding the same finite appearance; (c) (b) again as
    one NCCL rank under ``python -m torch.distributed.run --nproc_per_node
    1 ... --distributed``, (b)'s bytes; (d) two ``--retry_failed`` resumes
    from (a)'s PIPE_CKPT checkpoints, equal bytes; (e) ``--intra_block 1``
    (one NCCL rank) on block 0, the sequential block 0's bytes, its
    attribute and band gathers and the attribute gradient's all-to-all
    issued over NCCL every step; (f) a
    mixed-resolution shared fleet on the CPU and on the card, losses within
    MIXED_TOL; then the warm fleet iteration beside 4 of phase 15's warm
    steps, and the intra-block step at D = 1 beside the single-card step,
    each with its device busy time;
17. the viewer, on phase 8's scene at full width: (a) phase 8's
    ``cli.train`` again with ``--ip 127.0.0.1 --port <free>`` and a viewer
    client (connected before the loop) that asks for VIEWER_FRAMES frames
    of the test views, at 1280x800 and at 1920x1080 with scaling_modifier
    0.5, with VIEWER_PAUSED paused frames half way: every reply holds
    w*h*3 bytes and the verify string, no step is taken across the pause,
    B1 launches once per step, eval view and frame, and the PLY is phase
    8's byte for byte; (b) ``poll_viewer`` on the 720k PLY at both sizes:
    B1's image against the plain version, the bytes sent against its
    uint8 cast, and the 1280x800 frame against ``render_view``; (c) the
    median frame time at both sizes split into render, cast, copy to the
    host and send, with B1's share;
18. the gather experiment (``pcp_tpu_torch.tools.exp_r2 gather``) at its
    default shapes and at N = 2^20, each of its three forms held bit for
    bit to the plain version, with the byte bound and the plane form's
    sector floor; ``sort`` and ``xlagather`` once;
19. the quality tools: (a) ``pcp_tpu_torch.tools.train_check`` (its
    scene's 10 GT views, 400 steps, PSNR on 2 views before and after):
    the JAX tool's bar holds, B2 and B3 launched once a step and B1 once
    a step, GT view and eval view, and on the arguments of its step with
    the most pairs B1, B2 and B3 agree with their plain versions as in
    phases 5 and 10; the dense oracle (``tools.oracle``) on a small cloud
    on the CPU and on the card within ORACLE_TOL; (b)
    ``tools.quality_scale_run --smoke`` at the ref100k preset's full width
    (1.6M SfM points, 400k true Gaussians, 160 cameras at 800x512, 16
    blocks of 100k, 2^20 slots; the detail block 1500 steps with densify
    from 500, the control 1500 steps in 2^18 slots, one oracle view): 16
    blocks, every logged loss finite, the densify variant's population
    growing within its slots, both variants' PSNR at 1500 above their
    1000-step snapshot, the production GT PNGs at ORACLE_GT_DB or more
    against the oracle's GT, B1's float image of that view against the
    oracle's with no colour correction, at ORACLE_GT_DB in the exact
    depth order and at ORACLE_RAW_* in the pair key's, B1, B2 and B3
    launched once a step (B1 also once a GT and snapshot view), and on
    the arguments of its step with the most pairs held to their plain
    versions as in (a); (c) the default tier, ``tools.quality_scale_run``
    at the ref500k preset's full width (8M SfM points, 2M true Gaussians,
    160 cameras at 1280x800, 16 blocks of 500k, 2^21 slots, appearance
    on), phase by phase as a run across machines takes them: scene,
    partition, the detail block's densify variant for DEFAULT_TIER_ITERS
    steps (the depth cut to where densify has outgrown its prunes; no
    control) and the eval: 16 blocks, every logged loss finite, alive
    within 2^21 and growing, the launches as in (b), the kernels on its
    heaviest step as in (a), and B1's float image of a held-out view
    against the oracle's in the key's order at ORACLE_RAW_* (the exact
    order, at the key's 20 depth bits, is logged: ROADMAP C1). In (a),
    (b) and (c) the segment
    sum and its plain twin (``index_add_``, atomics on the card) are each
    also held to the float64 sum of the same rows, to KERNEL_RSEG of each
    segment's sum of |terms|, as in phase 10;
20. one ``{"kernels": [...]}`` line, the card's name and power limit, and
    the ``{"ok": true, ...}`` line last.

Paths 4, 8, 12, 14, 15, 16a, 16e, 17a, 18, 19a, 19b and 19c each run with
every launch count set to 0 just before and read just after.

Any failed check raises: the script then exits non-zero and prints no
result line. Without a CUDA card it exits 1 before doing anything.

    python3 chip_smoke.py --full-eval-runs 20

runs phases 1, 2 and then only phase 14, that many times on the same
scene, prints each run's PSNR and SSIM per scene as one JSON line, and
fails unless every run of a scene gives the same bits: the witness that
training repeats on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import math
import os
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

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
from pcp_tpu_torch.ops.binning import (
    bin_gaussians,
    gaussian_major,
    key_depth_bits,
)
from pcp_tpu_torch.ops.projection import TILE, preprocess
from pcp_tpu_torch.ops.rasterize import rasterize, untile
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.scene import load_colmap_scene, split_train_test
from pcp_tpu_torch.train import loop as loop_mod
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.train.logging import loss_rows, read_log
from pcp_tpu_torch.tools import exp_r2
from pcp_tpu_torch.tools.blend_inputs import blend_inputs, real_block_counts
from pcp_tpu_torch.train.step import TrainState, app_groups, train_step_impl
from pcp_tpu_torch.utils.graphics import rotmat_to_qvec, world_to_view
from pcp_tpu_torch.utils.image import color_correct
from pcp_tpu_torch.utils.loss import ssim
from pcp_tpu_torch.utils.sh import rgb_to_sh
from pcp_tpu_torch.viewer import NetworkGUI

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
# The pipeline: an aerial capture of PIPE_POINTS points over a PIPE_SIDE m
# square (PIPE_SIDE / 0.25 m cells across and ~35 m of height keep the
# outlier screen's grid under its 2^28-cell cap), partitioned at the 24 GB
# tier's threshold (README.md) into blocks of ~500k points, each trained
# PIPE_ITERS steps with a densify at 10 and 20 and a checkpoint at PIPE_CKPT
PIPE_POINTS, PIPE_AIR, PIPE_SIDE = 2_000_000, 20_000, 300.0
PIPE_CAMS, PIPE_HEIGHT, PIPE_FX = 32, 120.0, 1000.0
PIPE_THRESHOLD = 500_000
PIPE_ITERS, PIPE_CKPT = 20, 10
# The multi-card slice's mixed-resolution check: a 4,000-Gaussian scene
# at 1280x800 / MIXED_RES (320x200), every other camera at half that, two
# blocks in 2^13 slots, MIXED_STEPS shared-appearance fleet steps on the CPU
# and on the card; their losses agree to MIXED_TOL relative
MIXED_GAUSSIANS, MIXED_RES, MIXED_CAPACITY = 4_000, 4, 1 << 13
MIXED_STEPS, MIXED_TOL = 3, 1e-4
# The viewer: phase 8's training with a viewer that asks for VIEWER_FRAMES
# frames of the test views, every other one at the cameras' 1280x800 and
# the rest at VIEWER_WIDE (a common window; 1080 rows are 67.5 tile rows,
# so B1 gets a partial tile row) with scaling_modifier VIEWER_SCALE, and
# VIEWER_PAUSED paused frames half way; then VIEWER_REPS timed frames at
# each size. Every client socket operation times out after VIEWER_WAIT_S.
VIEWER_WIDE, VIEWER_SCALE = (1920, 1080), 0.5
VIEWER_FRAMES, VIEWER_PAUSED, VIEWER_REPS = 16, 3, 10
VIEWER_WAIT_S = 300.0
# The quality tools: on each of their two paths B1, B2 and B3 are held to
# their plain versions on the arguments of the path's step with the most
# pairs, at KERNEL_ATOL, KERNEL_RSUM and KERNEL_RSEG below; the dense oracle
# on ORACLE_SMALL's (Gaussians, (W, H)) on the CPU and on the card agrees to
# ORACLE_TOL; the production GT PNGs of the ref100k smoke run reach
# ORACLE_GT_DB against the oracle's GT (the JAX package's record: 49.56 dB,
# QUALITY_r05.json; the PNGs truncate to 8 bits and the score is colour
# corrected), and so does B1's float image of that view against the
# oracle's float image with no colour correction. The two order a tile's
# Gaussians differently: the pair key keeps only the top
# ``binning.key_depth_bits`` bits of each depth (21 at 800x512), equal keys
# in index order, the oracle the exact depth. In the key's order
# (``rasterize_dense(depth_bits=...)``) the oracle must give B1's image:
# ORACLE_RAW_DB or more, each channel's mean offset within ORACLE_RAW_BIAS
# and every value within ORACLE_RAW_ATOL. Every pixel there blends to
# T < 1e-4; the oracle takes T as exp of a cumulative log sum, B1 as a
# running product, so the two part by about 1e-6 relative and a stop can
# fall one Gaussian apart, which moves a pixel by at most
# alpha T < 0.99 * 1e-4 / (1 - 0.99) ~ 1e-2.
ORACLE_SMALL, ORACLE_TOL = (2000, (200, 128)), 1e-5
ORACLE_GT_DB = 45.0
ORACLE_RAW_DB, ORACLE_RAW_BIAS, ORACLE_RAW_ATOL = 80.0, 2e-5, 1e-2
# Phase 19(c)'s depth: the ref500k block's schedule cut to 2000 steps. It
# densifies from 500, every 100, but prunes more than it adds until ~1600
# (722,053 -> 713,678 at 1000 on an H100); by 1900 the population has
# grown past its start (PERF.md)
DEFAULT_TIER_ITERS = 2000

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
# each segment (both sum in fp64 and round once to fp32; an fp32
# accumulator's rounding grows with a segment's length and crossed this at
# the default tier).
KERNEL_RSUM = 1e-5
KERNEL_RSEG = 1e-6
# The eval path on the card against the CPU, as tests/test_torch_eval.py
# holds the port against the JAX package: PSNR in dB, SSIM absolute, LPIPS
# relative.
EVAL_TOL = {"PSNR": 1e-3, "SSIM": 1e-5, "LPIPS": 1e-5}
PROFILER_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                       torch.profiler.ProfilerActivity.CUDA]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on just now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
        f"cudnn {torch.backends.cudnn.allow_tf32}; cudnn deterministic "
        f"{torch.backends.cudnn.deterministic}, benchmark "
        f"{torch.backends.cudnn.benchmark}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")
    check(torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "cuDNN is held to deterministic algorithms")
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
    """Mean device ms of ``fn()`` over ``reps`` calls after ``warm``. The
    timed calls queue behind a spin kernel (``exp_r2``'s), so the host's
    per-call work is hidden and the events time the launches back to
    back."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(exp_r2.SPIN_CYCLES)
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

    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
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


def train_argv(scene: Path, out: Path) -> list:
    """Phase 8's ``cli.train`` flags (phase 17 adds the viewer's)."""
    return ["-s", str(scene), "-m", str(out), "--device", "cuda",
            "--eval", "--llffhold", str(LLFFHOLD),
            "--iterations", str(TRAIN_ITERS),
            "--densify_from_iter", str(DENSIFY_FROM),
            "--densification_interval", str(DENSIFY_EVERY),
            "--opacity_reset_interval", str(RESET_EVERY),
            "--save_iterations", str(TRAIN_ITERS),
            "--test_iterations", str(TRAIN_ITERS),
            "--log_interval", "1", "--quiet"]


def train_path(scene: Path, out: Path) -> dict:
    """``cli.train`` on the card for TRAIN_ITERS steps, metrics logged at
    every step; checks the losses, the densify, the opacity reset, the PLY
    and the launch counts."""
    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    state = train_cli.main(train_argv(scene, out))
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
               "segment_sum": "segsum_"}   # the inverse and the sum


def device_kernels(prof, per: int) -> list:
    """(name, device ms per ``per``) of every kernel, copy and fill the
    profiler saw on the card; range annotations are not device work."""
    return [(e.key, e.self_device_time_total / 1e3 / per)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def capture_backward(run) -> tuple:
    """(arguments, ``run()``'s result): calls ``run()`` with the backward's
    two stages, ``composite_bwd`` and the segment-sum stage
    ``pack_gradient``, as ``ops.rasterize`` calls them, recording the
    arguments each got in the step with the most pairs (the last of
    equals)."""
    seen, real = {}, {"composite_bwd": rasterize_mod.composite_bwd,
                      "pack_gradient": rasterize_mod.pack_gradient}

    def detached(args):
        return tuple(a.detach() if torch.is_tensor(a) else a for a in args)

    def bwd(*args):
        if args[1].numel() >= seen.get("n_pairs", -1):
            seen.update(n_pairs=args[1].numel(), take=True,
                        composite_bwd=detached(args))
        return real["composite_bwd"](*args)

    def pack(*args):
        if seen.pop("take", False):
            seen["pack_gradient"] = detached(args)
        return real["pack_gradient"](*args)

    try:
        rasterize_mod.composite_bwd = bwd
        rasterize_mod.pack_gradient = pack
        out = run()
    finally:
        for name, fn in real.items():
            setattr(rasterize_mod, name, fn)
    return {k: seen[k] for k in real}, out


def timed_steps(step) -> tuple:
    """(ms of STEP_REPS synchronised warm steps, the last step's metrics),
    after 3 steps of warm-up."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEP_REPS):
        t0 = time.perf_counter()
        _, m = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, m


def profiled_steps(step):
    """A profiler run over 3 steps."""
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    return prof


def cudnn_free_cost(step, on_ms: float, on_busy: float) -> dict:
    """The warm step and device busy with cuDNN free to pick
    nondeterministic algorithms. Every ``rasterize`` call sets
    ``cudnn.deterministic`` through ``resolve_device``, so it is forced off
    right after each; the port's setting is restored after."""
    real = rasterize_mod.resolve_device

    def resolve(device=None):
        dev = real(device)
        torch.backends.cudnn.deterministic = False
        return dev

    try:
        rasterize_mod.resolve_device = resolve
        times, _ = timed_steps(step)
        rows = device_kernels(profiled_steps(step), 3)
    finally:
        rasterize_mod.resolve_device = real
        resolve_device("cuda")
    check(torch.backends.cudnn.deterministic, "cuDNN deterministic again")
    step_ms = statistics.median(times)
    busy = sum(ms for _, ms in rows)
    top = sorted(rows, key=lambda r: -r[1])[:5]
    log(f"  cudnn.deterministic off: warm {step_ms:.3f} ms median of "
        f"{[round(x, 3) for x in times]}, device busy {busy:.3f} ms/step; "
        f"on (above): {on_ms:.3f} ms, busy {on_busy:.3f}: determinism costs "
        f"{on_ms - step_ms:+.3f} ms a step, {on_busy - busy:+.3f} ms of "
        f"device time")
    for key, ms in top:
        log(f"    {ms:8.3f} ms/step  {key[:90]}")
    return {"step_ms": step_ms, "step_ms_all": times,
            "device_busy_ms_per_step": busy,
            "top_device_ms_per_step": [[k[:90], ms] for k, ms in top]}


def train_times(state: TrainState, cam, gt, ocfg, extent: float) -> dict:
    """Warm train-step time (median of STEP_REPS, synchronised), peak
    memory, and from the profiler the device time of each stage, by kernel,
    and the idle share of the warm step; the same two times with cuDNN's
    nondeterministic algorithms allowed. Also returns the arguments the
    backward's two stages got in one more step."""
    dev = state.alive.device
    viewmat, intrin = cam_mod.camera_tensors(cam, dev)
    bg = torch.zeros(3, device=dev)

    def step():
        return train_step_impl(
            state, viewmat, intrin, gt, cam.uid, bg, extent, ocfg=ocfg,
            image_size=(cam.width, cam.height), sh_degree=SH_DEGREE,
            use_appearance=True)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, m = timed_steps(step)
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = statistics.median(times)

    prof = profiled_steps(step)
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
    free = cudnn_free_cost(step, step_ms, busy)
    inputs, _ = capture_backward(step)
    return {"step_ms": step_ms, "step_ms_all": times,
            "stage_device_ms": stages, "n_pairs": m["n_pairs"],
            "peak_memory_bytes": peak,
            "device_busy_ms_per_step": busy if measured else None,
            "device_idle_share": 1 - busy / step_ms if measured else None,
            "top_device_ms_per_step": [[k[:90], ms] for k, ms in top],
            "cudnn_nondeterministic": free, "inputs": inputs}


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


def fp64_witness(k_sums, p_sums, ordered, s_gid, n: int, what: str) -> dict:
    """B3's sums (``k_sums``) and the plain twin's (``p_sums``, index_add_
    with atomics on the card, so in no fixed order) against the float64 sum
    of the same Gaussian-major rows, each relative to the segment's sum of
    |terms|; each of the three distances is held to KERNEL_RSEG, so a
    crossing of the kernel-vs-plain bound says which side is off."""
    w = segsum.sorted_segment_sum_plain(ordered, s_gid, n, fp64=True)
    scale = segsum.sorted_segment_sum_plain(ordered.abs(), s_gid, n,
                                            fp64=True).clamp_min(1e-30)

    def rel(a, b):
        return float(((a.double() - b.double()).abs() / scale).max())

    out = {"kernel_vs_plain": rel(k_sums, p_sums),
           "kernel_vs_fp64": rel(k_sums, w), "plain_vs_fp64": rel(p_sums, w)}
    del w, scale
    log(f"{what}, relative to each segment's sum of |terms| (tol "
        f"{KERNEL_RSEG}): kernel vs plain {out['kernel_vs_plain']:.3e}, "
        f"kernel vs fp64 {out['kernel_vs_fp64']:.3e}, plain vs fp64 "
        f"{out['plain_vs_fp64']:.3e}")
    for k, v in out.items():
        check(v <= KERNEL_RSEG, f"{what}: {k} {v:.3e} <= {KERNEL_RSEG}")
    return out


def segsum_checks(args, launches: int) -> dict:
    """The segment-sum stage on the arguments ``pack_gradient`` got in a
    real step: its kernel (``gathered_segment_sum`` on the pair-order rows
    and the sort's permutation) against the plain twin (``gaussian_major``,
    then ``sorted_segment_sum_plain``) and against itself; times of the
    kernel (and, from the profiler, of its two CUDA kernels: the inverse
    scatter and the sum), the whole stage, the plain twin, the unfolded
    stage (the Gaussian-major scatter, then the gid-sorted entry of the
    same sum kernel) and the library call (``index_add_`` of the pair-order
    rows by their gids); and the bound beside that of the gid-sorted
    kernel."""
    rows, bins, n = args
    k_args = (rows, bins.order, bins.offsets, n)
    k_out = segsum.gathered_segment_sum(*k_args)
    again = segsum.gathered_segment_sum(*k_args)
    stage = rasterize_mod.pack_gradient(rows, bins, n)
    ordered = gaussian_major(rows, bins.order)
    p_out = segsum.sorted_segment_sum_plain(ordered, bins.pair_gid, n)
    wit = fp64_witness(k_out, p_out, ordered, bins.pair_gid, n,
                       "gathered_segment_sum")
    err = float((k_out - p_out).abs().max())
    rel = wit["kernel_vs_plain"]
    log(f"gathered_segment_sum vs plain: max_abs_err {err:.3e}, "
        f"deterministic {bool(torch.equal(k_out, again))}")
    check(torch.equal(k_out, again), "gathered_segment_sum is deterministic")
    check(torch.equal(stage, k_out), "pack_gradient is the kernel's sums")
    # what the sum kernel costs when the rows already lie Gaussian-major
    sorted_ms = cuda_ms(lambda: segsum.sorted_segment_sum(
        ordered, bins.pair_gid, n, bins.offsets), reps=50)
    del stage, ordered

    ms = cuda_ms(lambda: segsum.gathered_segment_sum(*k_args), reps=50)
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        for _ in range(20):
            segsum.gathered_segment_sum(*k_args)
        torch.cuda.synchronize()
    split = {re.search(r"segsum_\w+", key).group(): t
             for key, t in device_kernels(prof, 20) if "segsum_" in key}
    stage_ms = cuda_ms(lambda: rasterize_mod.pack_gradient(rows, bins, n),
                       reps=50)
    unfolded_ms = cuda_ms(lambda: segsum.sorted_segment_sum(
        gaussian_major(rows, bins.order), bins.pair_gid, n, bins.offsets), reps=50)
    plain_ms = cuda_ms(lambda: segsum.sorted_segment_sum_plain(
        gaussian_major(rows, bins.order), bins.pair_gid, n), reps=20)
    lib_ms = cuda_ms(lambda: torch.zeros((n, 9), device=rows.device)
                     .index_add_(0, bins.gids, rows), reps=50)
    m = int(bins.offsets[n] - bins.offsets[0])   # the rows the sums read
    # each pair row and its permutation entry (int64) read once, the offsets
    # once, the sums written once; one add per input value
    b = bound(36 * m + 8 * bins.n_pairs + 4 * (n + 1) + 36 * n, 9 * m)
    with_inv = bound(36 * m + 4 * m + 4 * (n + 1) + 36 * n, 9 * m)
    old = bound(36 * m + 4 * (n + 1) + 36 * n, 9 * m)
    log(f"segment sum: {launches} launches on the training path; {m} pair "
        f"rows into {n} Gaussians, bytes {b['bytes']} "
        f"({b['bytes_ms']:.4f} ms; with an int32 inverse index given "
        f"{with_inv['bytes_ms']:.4f} ms; the gid-sorted kernel's "
        f"{old['bytes_ms']:.4f} ms), fp32 ops {b['ops']} ({b['ops_ms']:.4f} "
        f"ms); gathered rows touch {64 * m} bytes of 32-B sectors; kernel "
        f"{ms:.4f} ms ({b['bound_ms'] / ms:.1%} of its bound; by the "
        f"profiler {split}), stage {stage_ms:.4f} ms, unfolded stage "
        f"{unfolded_ms:.4f} ms, the gid-sorted entry on Gaussian-major rows "
        f"{sorted_ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms")
    return dict(b, max_abs_err=err, segment_rel_err=rel, fp64_witness=wit,
                ms=ms, kernel_split_ms=split, stage_ms=stage_ms,
                unfolded_stage_ms=unfolded_ms, gid_sorted_ms=sorted_ms,
                plain_ms=plain_ms,
                library_ms=lib_ms, inverse_given_bound_ms=with_inv["bound_ms"],
                gid_sorted_bound_ms=old["bound_ms"], rows=m, n=n)


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
    out = {}
    with torch.no_grad():
        same = float(lpips_fn(rc, rc))
        for name, fn in stages.items():
            ms = cuda_ms(fn, reps=5)
            with torch.profiler.profile(
                    activities=PROFILER_ACTIVITIES) as prof:
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


def full_eval_spread(runs: int, seed: int, dev) -> dict:
    """Phase 14 ``runs`` times on the scene of ``seed``: each scene's PSNR
    and SSIM in every run. Fails unless every run of a scene gives the same
    bits."""
    SCRATCH.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        means = [full_eval_path(Path(tmp) / f"run{i}", seed, dev)["means"]
                 for i in range(runs)]
    out = {k: {s: [m[s][k] for m in means] for s in means[0]}
           for k in ("PSNR", "SSIM")}
    for k, by_scene in out.items():
        for scene, values in by_scene.items():
            check(len(set(values)) == 1,
                  f"every full_eval run gives the same {k} on {scene}: "
                  f"{values}")
    return {"full_eval_runs": runs, **out}


# --------------------------------------------------------------------------
# 15. the pipeline
# --------------------------------------------------------------------------


def write_aerial_scene(root: Path, seed: int, dev) -> Path:
    """A COLMAP model of an aerial capture under ``root``: PIPE_POINTS
    points over a PIPE_SIDE-metre square of terrain with a few metres of
    relief (plus PIPE_AIR sparse points in the air for the outlier filter),
    PIPE_CAMS cameras at 1280x800 looking straight down from PIPE_HEIGHT
    metres on an 8 x 4 raster, and GT PNGs rendered on ``dev`` from a
    Gaussian set at the same points (SH degree 0, ~0.15 m splats, opacity
    0.7, a smooth colour field), so training has a real target."""
    from PIL import Image as PILImage

    rng = np.random.default_rng(seed)
    half = PIPE_SIDE / 2
    n = PIPE_POINTS - PIPE_AIR

    def relief(x, y):
        return 6.0 * np.sin(x / 40.0) + 5.0 * np.cos(y / 33.0)

    x, y = rng.uniform(-half, half, (2, n))
    z = relief(x, y) + rng.normal(0.0, 0.1, n)
    ax, ay = rng.uniform(-half, half, (2, PIPE_AIR))
    az = relief(ax, ay) + rng.uniform(3.0, 12.0, PIPE_AIR)
    xyz = np.stack([np.r_[x, ax], np.r_[y, ay], np.r_[z, az]], -1)
    rgb = np.clip(np.stack([
        0.5 + 0.35 * np.sin(xyz[:, 0] / 13.0) * np.cos(xyz[:, 1] / 17.0),
        0.5 + 0.35 * np.cos(xyz[:, 0] / 23.0 + 1.0),
        0.5 + 0.35 * np.sin(xyz[:, 1] / 11.0 + 2.0)], -1)
        + rng.normal(0.0, 0.05, xyz.shape), 0.0, 1.0)

    scene = root / "scene"
    (scene / "images").mkdir(parents=True)
    cams = {1: colmap.Camera(1, "PINHOLE", W, H,
                             np.array([PIPE_FX, PIPE_FX, W / 2, H / 2]))}
    images = {}
    down = np.diag([1.0, -1.0, -1.0])        # camera +z is world -z
    for i in range(PIPE_CAMS):
        c = np.array([-half + PIPE_SIDE * (i % 8 + 0.5) / 8,
                      -half + PIPE_SIDE * (i // 8 + 0.5) / 4, PIPE_HEIGHT])
        yaw = rng.uniform(-0.05, 0.05)
        R = np.array([[math.cos(yaw), -math.sin(yaw), 0],
                      [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]]) @ down
        images[i + 1] = colmap.Image(i + 1, rotmat_to_qvec(R), -R @ c, 1,
                                     f"im{i:03d}.png")
    colmap.write_model(cams, images, colmap.Points3D.from_arrays(
        xyz, (rgb * 255).astype(np.uint8)), str(scene / "sparse" / "0"),
        ext=".bin")

    logit = math.log(0.7 / 0.3)
    params, alive = G.params_from_numpy({
        "xyz": xyz.astype(np.float32),
        "f_dc": rgb_to_sh(rgb).astype(np.float32),
        "f_rest": np.zeros((len(xyz), 0, 3), np.float32),
        "opacity": np.full((len(xyz), 1), logit, np.float32),
        "scaling": np.log(0.15) + rng.uniform(-0.3, 0.3, (len(xyz), 3))
        .astype(np.float32),
        "rotation": rng.normal(size=(len(xyz), 4)).astype(np.float32),
    }, np.ones(len(xyz), bool), dev)
    bg = torch.zeros(3, device=dev)
    for info in load_colmap_scene(str(scene)).cameras:
        img, st = render_view(params, alive,
                              cam_mod.from_info(info, -1, load_image=False),
                              0, bg, device=dev)
        check(st["n_dropped"] == 0, "the GT render drops no pair")
        PILImage.fromarray((img * 255).astype(np.uint8)).save(
            info.image_path)
    return scene


def pipeline_path(root: Path, seed: int, dev, weights: str,
                  smi: str) -> dict:
    """The reference workflow through the port's CLIs on the card, at full
    width: ``cli.partition`` (outlier removal on, the 24 GB tier's
    threshold), ``cli.auto_train --sequential`` (every block at 1280x800,
    SH 3, appearance on, 2^20 slots, PIPE_ITERS steps with a densify and a
    checkpoint at PIPE_CKPT), two ``cli.train --start_checkpoint`` resumes
    of one block, ``cli.merge``, ``cli.render`` of the held-out views and
    ``cli.metrics``, with every launch count set to 0 just before and read
    just after. Checks the native libraries, the card's outlier screen
    against the native filter, the blocks, the resumes' bits, the merged
    model and the scores."""
    from pcp_tpu_torch.cli import auto_train as auto_train_cli
    from pcp_tpu_torch.cli import merge as merge_cli
    from pcp_tpu_torch.cli import partition as partition_cli
    from pcp_tpu_torch.native import load_library, load_points_library
    from pcp_tpu_torch.partition.points import (
        _grid_screen,
        _radius_outlier_native,
    )
    from pcp_tpu_torch.train import loop

    t_phase = t0 = time.perf_counter()
    scene = write_aerial_scene(root, seed, dev)
    log(f"pipeline scene: {PIPE_POINTS} points, {PIPE_CAMS} cameras at "
        f"{W}x{H}, written in {time.perf_counter() - t0:.1f} s")
    model = scene / "model"
    visible = model / "split_result" / "visible"
    train_flags = ["--iterations", str(PIPE_ITERS), "--densify_from_iter",
                   str(DENSIFY_FROM), "--densification_interval",
                   str(DENSIFY_EVERY), "--device", "cuda"]

    # per-step wall times (the step synchronised) and per-block seconds
    steps, blocks_s = [], {}
    real_step, real_train = loop.train_step_impl, loop.train_scene

    def timed_step(*a, **kw):
        t = time.perf_counter()
        out = real_step(*a, **kw)
        torch.cuda.synchronize()
        steps[-1].append(time.perf_counter() - t)
        return out

    def timed_train(scene_info, cfg, **kw):
        steps.append([])
        t = time.perf_counter()
        state = real_train(scene_info, cfg, **kw)
        torch.cuda.synchronize()
        blocks_s[kw.get("save_name", "point_cloud")] = \
            time.perf_counter() - t
        return state

    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    records = partition_cli.main([str(scene), "--threshold",
                                  str(PIPE_THRESHOLD), "--no_plots",
                                  "--llffhold", str(LLFFHOLD), "--device",
                                  "cuda"])
    partition_s = time.perf_counter() - t0
    check(load_library() is not None and load_points_library() is not None,
          "the native codec and points filter loaded")
    points = {r.partition_id: r.point_num for r in records}
    check(len(records) >= 2, f"at least 2 blocks: {points}")
    check(all(r.camera_uids for r in records), "every block has cameras")

    cloud = load_colmap_scene(str(scene)).points
    t1 = time.perf_counter()
    certain_in, certain_out = _grid_screen(cloud, 5, 1.0, dev)
    torch.cuda.synchronize()
    screen_s = time.perf_counter() - t1
    keep = _radius_outlier_native(cloud, 5, 1.0)
    check(bool(keep[certain_in].all()),
          "every point the card's screen certainly keeps, the filter keeps")
    check(not keep[certain_out].any(),
          "every point the card's screen certainly removes, the filter "
          "removes")
    screen = {"points": len(cloud), "kept": int(keep.sum()),
              "certain_in": int(certain_in.sum()),
              "certain_out": int(certain_out.sum()), "s": screen_s}
    log(f"outlier screen on the card: {screen}")
    del cloud, certain_in, certain_out, keep

    loop.train_step_impl, loop.train_scene = timed_step, timed_train
    try:
        t0 = time.perf_counter()
        auto_train_cli.main(["--base_path", str(visible), "--sequential",
                             "--checkpoint_iterations", str(PIPE_CKPT),
                             *train_flags])
        auto_train_s = time.perf_counter() - t0
    finally:
        loop.train_step_impl, loop.train_scene = real_step, real_train
    manifest = json.loads((visible / "train_status.json").read_text())
    check(sorted(manifest) == sorted(points)
          and all(v["status"] == "done" for v in manifest.values()),
          f"every block trained: {manifest}")
    warm_ms = {bid: statistics.median(t[1:]) * 1e3
               for bid, t in zip(sorted(points), steps)}
    train_s = {bid: blocks_s[f"{bid}_point_cloud"] for bid in sorted(points)}

    # two resumes of the first block from its checkpoint: the same bits
    bid = sorted(points)[0]
    block_dir = visible / bid / f"partition_{bid}"
    resumed, resume_s = [], []
    for name in ("resume_a", "resume_b"):
        out = root / name
        t0 = time.perf_counter()
        train_cli.main(["-s", str(block_dir), "-m", str(out),
                        "--start_checkpoint", str(
                            block_dir / "output" / f"chkpnt{PIPE_CKPT}.pth"),
                        "--log_interval", "1", "--quiet", *train_flags])
        torch.cuda.synchronize()
        resume_s.append(time.perf_counter() - t0)
        losses = [r["train_loss_patches/total_loss"] for r in map(
            json.loads, (out / "train_log.jsonl").read_text().splitlines())
            if "train_loss_patches/total_loss" in r]
        resumed.append((losses, (out / "point_cloud" / f"iteration_"
                                 f"{PIPE_ITERS}" / "point_cloud.ply")
                        .read_bytes()))
    seq0 = (block_dir / "output" / "point_cloud" / f"iteration_{PIPE_ITERS}"
            / f"{bid}_point_cloud.ply").read_bytes()
    check(len(resumed[0][0]) == PIPE_ITERS - PIPE_CKPT,
          "the resume runs the steps after its checkpoint")
    check(resumed[0] == resumed[1],
          "two resumes from one checkpoint give the same losses and PLY")

    t0 = time.perf_counter()
    merged = merge_cli.main(["-m", str(model), "--device", "cuda"])
    merge_s = time.perf_counter() - t0
    n_merged = len(merged["xyz"])
    check(n_merged > 0 and (model / "point_cloud.ply").exists(),
          "the merged PLY is written")
    del merged

    # the CLI's wall, and the views' alone (render_split: each view's
    # render, its copy to the host and its PNGs), without the loads of the
    # merged PLY and of the scene
    split_s = []
    real_split = render_cli.render_split

    def timed_split(*a, **kw):
        t = time.perf_counter()
        out = real_split(*a, **kw)
        split_s.append(time.perf_counter() - t)
        return out

    render_cli.render_split = timed_split
    try:
        t0 = time.perf_counter()
        stats = render_cli.main(["-s", str(scene), "-m", str(model),
                                 "--llffhold", str(LLFFHOLD), "--device",
                                 "cuda"])
        render_s = time.perf_counter() - t0
    finally:
        render_cli.render_split = real_split
    views = stats["test"]
    n_views = PIPE_CAMS // LLFFHOLD
    check(len(views) == n_views and all(v["n_dropped"] == 0 for v in views),
          f"{n_views} held-out views rendered, none dropping a pair")
    res = metrics_cli.main(["-m", str(model), "--lpips_weights", weights,
                            "--device", "cuda"])
    (mean,) = [r["mean"] for r in res.values()]
    check(all(math.isfinite(mean[k]) for k in ("PSNR", "SSIM", "LPIPS")),
          f"finite scores: {mean}")
    launches = counts()
    n_steps = len(points) * PIPE_ITERS + 2 * (PIPE_ITERS - PIPE_CKPT)
    check(launches == {"composite_fwd": n_steps + n_views,
                       "composite_bwd": n_steps,
                       "sorted_segment_sum": n_steps, "gather_pack": 0},
          f"the pipeline launches B1, B2 and B3: {launches}")
    out = {"launches": launches, "partition_s": partition_s,
           "blocks": len(points), "points_per_block": points,
           "auto_train_s": auto_train_s, "train_s": train_s,
           "warm_step_ms": warm_ms, "merge_s": merge_s,
           "merged_gaussians": n_merged, "render_s": render_s,
           "render_ms_per_view": split_s[0] * 1e3 / n_views,
           "resume_s": resume_s, "phase_s": time.perf_counter() - t_phase,
           "views": views, "scores": mean, "lpips_synthetic": True,
           "screen": screen, "card": smi,
           "visible": visible, "block0_ply": seq0}
    log(f"pipeline [{smi}]: partition {partition_s:.2f} s; {len(points)} "
        f"blocks, points {points}")
    log(f"pipeline [{smi}]: train s {train_s}, median warm step ms "
        f"{warm_ms} (auto_train {auto_train_s:.1f} s, launches {launches})")
    log(f"pipeline [{smi}]: resumes {resume_s} s; merge {merge_s:.2f} s -> "
        f"{n_merged} Gaussians; render {out['render_ms_per_view']:.1f} "
        f"ms/view with PNG I/O ({n_views} views; the CLI {render_s:.1f} s "
        f"with its loads); PSNR {mean['PSNR']:.4f} SSIM {mean['SSIM']:.4f} "
        f"LPIPS {mean['LPIPS']:.4f} (synthetic LPIPS); the phase "
        f"{out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 16. the multi-card slice on one card
# --------------------------------------------------------------------------


def _blocks_copy(visible: Path, dst: Path, only=None) -> Path:
    """The partition's blocks (COLMAP data and images) under ``dst``,
    without their outputs and the manifest; ``only`` keeps those blocks."""
    dst.mkdir(parents=True)
    for b in sorted(p.name for p in visible.iterdir() if p.is_dir()):
        if only is None or b in only:
            shutil.copytree(visible / b, dst / b,
                            ignore=shutil.ignore_patterns("output"))
    return dst


def _block_plys(base: Path) -> dict:
    return {b.name: (b / f"partition_{b.name}" / "output" / "point_cloud"
                     / f"iteration_{PIPE_ITERS}" / f"{b.name}_point_cloud.ply")
            .read_bytes() for b in sorted(base.iterdir()) if b.is_dir()}


def _app_leaves(path: Path) -> list:
    """The appearance leaves of a checkpoint: the embeddings and the net's
    parameters follow the Gaussian params (``train/checkpoint._slots``)."""
    from pcp_tpu_torch.models.appearance import AppearanceNetwork

    leaves = torch.load(path, map_location="cpu", weights_only=True)["leaves"]
    n_net = len(list(AppearanceNetwork().parameters()))
    return leaves[len(G.PARAM_KEYS):len(G.PARAM_KEYS) + 1 + n_net]


def _mixed_fleet_losses(scene_dir: Path, dev) -> list:
    """Losses of MIXED_STEPS shared-appearance fleet steps of two blocks
    whose cameras alternate between full and half resolution (the
    pad-and-mask path), from one start state, on ``dev``."""
    import dataclasses

    from pcp_tpu_torch.parallel.fleet import (build_camera_bank,
                                              make_fleet_step)
    from pcp_tpu_torch.train import checkpoint as ckpt
    from pcp_tpu_torch.train.config import (ModelConfig, PipelineConfig,
                                            TrainRunConfig)
    from pcp_tpu_torch.train.loop import init_state

    info = load_colmap_scene(str(scene_dir))
    for i, c in enumerate(info.cameras):
        if i % 2:
            info.cameras[i] = dataclasses.replace(
                c, width=c.width // 2, height=c.height // 2)
    cams = [cam_mod.from_info(i, MIXED_RES) for i in info.cameras]
    frame = (max(c.width for c in cams), max(c.height for c in cams))
    cfg = TrainRunConfig(model=ModelConfig(sh_degree=SH_DEGREE),
                         optim=OptimConfig(capacity=MIXED_CAPACITY),
                         pipeline=PipelineConfig(use_appearance=True,
                                                 share_appearance=True))
    states = []
    for b in range(2):
        # the start state made on the CPU and copied in: the same bits on
        # both devices
        host = init_state(info, cfg, torch.Generator().manual_seed(b), "cpu")
        path = scene_dir.parent / f"mixed_{b}.pth"
        ckpt.save(str(path), host, 0)
        st, _ = ckpt.load(str(path), init_state(
            info, cfg, torch.Generator().manual_seed(b), dev))
        path.unlink()
        states.append(st)
    shared = TrainState({}, states[0].app, None, states[0].opt_a, None, {})
    states[1].app, states[1].opt_a = shared.app, shared.opt_a
    step = make_fleet_step(cfg.optim, frame, use_appearance=True,
                           share_appearance=True, n_blocks=2)
    (bank,) = build_camera_bank([cams], frame, dev)
    bg = torch.zeros(3, device=dev)
    losses = []
    for i in range(MIXED_STEPS):
        views = [bank.view((i + b) % len(cams)) for b in range(2)]
        m = step(states, [info.extent] * 2, views, bg, SH_DEGREE, [0, 1],
                 shared)
        losses.append([float(x["loss"]) for x in m])
    return losses


def intra_vs_single(block_dir: Path, dev) -> dict:
    """The warm step (median of STEP_REPS, synchronised) and device busy of
    the single-card step and of the intra-block step at D = 1 (inside a
    one-rank NCCL group), on the same full-width block state."""
    from pcp_tpu_torch.parallel import distributed as pdist
    from pcp_tpu_torch.parallel.intra_block import sharded_render
    from pcp_tpu_torch.train.config import TrainRunConfig
    from pcp_tpu_torch.train.loop import init_state

    info = load_colmap_scene(str(block_dir))
    cam = cam_mod.from_info(info.cameras[0], -1)
    gt = torch.as_tensor(np.round(cam.gt_image * 255.0).astype(np.uint8),
                         device=dev)
    ocfg = OptimConfig(capacity=CAPACITY)
    state = init_state(info, TrainRunConfig(optim=ocfg),
                       torch.Generator().manual_seed(0), dev)
    viewmat, intrin = cam_mod.camera_tensors(cam, dev)
    bg = torch.zeros(3, device=dev)
    out = {}
    with pdist.group_of(dev, 1):
        for name, render in (("single", None), ("intra_block_d1",
                                                 sharded_render)):
            def step(render=render):
                return train_step_impl(
                    state, viewmat, intrin, gt, cam.uid, bg, info.extent,
                    ocfg=ocfg, image_size=(cam.width, cam.height),
                    sh_degree=SH_DEGREE, use_appearance=True, render=render)
            times, _ = timed_steps(step)
            busy = sum(ms for _, ms in device_kernels(profiled_steps(step), 3))
            out[name] = {"step_ms": statistics.median(times),
                         "step_ms_all": times, "device_busy_ms": busy}
    return out


def multi_path(root: Path, pipe: dict, dev, smi: str) -> dict:
    """The multi-card slice on the one card, on phase 15's partition (4
    blocks of ~600k points at 1280x800, SH 3, appearance on, 2^20 slots,
    PIPE_ITERS steps, densify at 10 and 20), through ``cli.auto_train``:
    (a) the fleet with device-resident cameras and a rolling checkpoint at
    PIPE_CKPT, every launch count set to 0 just before and read just
    after; (b) the fleet with one shared appearance, host-fed; (c) (b)
    again as one NCCL rank under torchrun; (d) two ``--retry_failed``
    resumes from (a)'s PIPE_CKPT checkpoints; (e) ``--intra_block 1`` on
    block 0; (f) a mixed-resolution shared fleet on the CPU and on the
    card. Then the fleet iteration's time, and the intra-block step's at
    D = 1 beside the single-card step's."""
    from pcp_tpu_torch.cli import auto_train as auto_train_cli
    from pcp_tpu_torch.parallel import fleet

    t_phase = time.perf_counter()
    visible = pipe["visible"]
    blocks = sorted(p.name for p in visible.iterdir() if p.is_dir())
    flags = ["--iterations", str(PIPE_ITERS), "--densify_from_iter",
             str(DENSIFY_FROM), "--densification_interval",
             str(DENSIFY_EVERY), "--device", "cuda"]

    def manifest_of(base):
        m = json.loads((base / "train_status.json").read_text())
        check(sorted(m) == blocks[:len(m)] and all(
            v["status"] == "done" for v in m.values()),
            f"every block marked done: {m}")
        return m

    # (a) the fleet, device-resident cameras, checkpoints at PIPE_CKPT
    a_dir = _blocks_copy(visible, root / "a")
    saved, iter_s = root / "ckpt", []
    real_save, real_step = fleet._save, fleet.make_fleet_step

    def spy_save(path, state, it):
        real_save(path, state, it)
        if it == PIPE_CKPT:
            dst = saved / Path(path).relative_to(a_dir)
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(path, dst)

    def timed_make(*a, **kw):
        inner = real_step(*a, **kw)

        def step(*sa, **skw):
            t = time.perf_counter()
            out = inner(*sa, **skw)
            torch.cuda.synchronize()
            iter_s.append(time.perf_counter() - t)
            return out
        return step

    fleet._save, fleet.make_fleet_step = spy_save, timed_make
    try:
        composite.LAUNCHES.clear()
        t0 = time.perf_counter()
        auto_train_cli.main(["--base_path", str(a_dir), "--device_data",
                             "--fleet_checkpoint_interval", str(PIPE_CKPT),
                             "--test_iterations", str(PIPE_ITERS), *flags])
        torch.cuda.synchronize()
        fleet_s = time.perf_counter() - t0
        launches = counts()
    finally:
        fleet._save, fleet.make_fleet_step = real_save, real_step
    manifest = manifest_of(a_dir)
    check(len(manifest) == len(blocks) and all(
        v.get("eval_iter") == PIPE_ITERS for v in manifest.values()),
        f"every block scored at {PIPE_ITERS}: {manifest}")
    a_plys = _block_plys(a_dir)
    check(a_plys[blocks[0]] == pipe["block0_ply"],
          "fleet block 0 writes the sequential block 0's PLY bytes")
    n_eval = sum(len(range(n)[::max(1, n // 3)][:3]) for n in (
        len(load_colmap_scene(str(visible / b / f"partition_{b}")).cameras)
        for b in blocks))
    n_steps = len(blocks) * PIPE_ITERS
    check(launches == {"composite_fwd": n_steps + n_eval,
                       "composite_bwd": n_steps,
                       "sorted_segment_sum": n_steps, "gather_pack": 0},
          f"the fleet launches B1, B2 and B3 per block step and B1 per "
          f"eval view ({n_eval}): {launches}")
    iter_ms = statistics.median(iter_s[1:]) * 1e3
    seq_ms = sum(pipe["warm_step_ms"].values())
    log(f"fleet (a) [{smi}]: {len(blocks)} blocks x {PIPE_ITERS} steps in "
        f"{fleet_s:.1f} s, warm fleet iteration {iter_ms:.3f} ms (median, "
        f"synchronised) vs 4 sequential warm steps {seq_ms:.3f} ms "
        f"(phase 15's); launches {launches}; block 0 == sequential")

    # (b) one shared appearance, host-fed
    b_dir = _blocks_copy(visible, root / "b")
    t0 = time.perf_counter()
    auto_train_cli.main(["--base_path", str(b_dir), "--share_appearance",
                         *flags])
    shared_s = time.perf_counter() - t0
    manifest_of(b_dir)
    apps = [_app_leaves(b_dir / b / f"partition_{b}" / "output" /
                        fleet.FLEET_CKPT_NAME) for b in blocks]
    check(all(torch.isfinite(t).all() for t in apps[0]),
          "the shared appearance is finite")
    check(all(len(a) == len(apps[0]) and all(torch.equal(x, y) for x, y in
                                             zip(a, apps[0])) for a in apps),
          "every block's checkpoint holds the same appearance")
    b_plys = _block_plys(b_dir)
    check(b_plys != a_plys, "sharing the appearance changes the blocks")

    # (c) (b) as one NCCL rank under torchrun
    c_dir = _blocks_copy(visible, root / "c")
    port = free_port()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_addr", "127.0.0.1", "--master_port", str(port), "-m",
         "pcp_tpu_torch.cli.auto_train", "--distributed", "--base_path",
         str(c_dir), "--share_appearance", "--fleet_checkpoint_interval",
         "0", *flags], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT),
                 OMP_NUM_THREADS=str(torch.get_num_threads())))
    nccl_s = time.perf_counter() - t0
    check(run.returncode == 0, f"torchrun auto_train exits 0: "
          f"{run.stdout[-2000:]} {run.stderr[-3000:]}")
    check("distributed: rank 0 of 1 on" in run.stdout,
          f"one NCCL rank joined: {run.stdout[-2000:]}")
    manifest_of(c_dir)
    check(_block_plys(c_dir) == b_plys,
          "one NCCL rank under torchrun writes (b)'s bytes")

    # (d) two resumes from (a)'s PIPE_CKPT checkpoints
    t0 = time.perf_counter()
    resumed = []
    for name in ("d1", "d2"):
        d_dir = _blocks_copy(visible, root / name)
        shutil.copytree(saved, d_dir, dirs_exist_ok=True)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            auto_train_cli.main(["--base_path", str(d_dir), "--retry_failed",
                                 "--device_data",
                                 "--fleet_checkpoint_interval", "0", *flags])
        check(f"resuming from iteration {PIPE_CKPT}" in out.getvalue(),
              f"the fleet resumed at {PIPE_CKPT}: {out.getvalue()[-1500:]}")
        manifest_of(d_dir)
        resumed.append(_block_plys(d_dir))
    check(resumed[0] == resumed[1], "two fleet resumes give the same bytes")
    resume_s = time.perf_counter() - t0

    # (e) intra-block at D = 1 on block 0, one NCCL rank; the collectives
    # the sharded step issues are counted by backend
    import torch.distributed as dist

    e_dir = _blocks_copy(visible, root / "e", only=blocks[:1])
    collectives: dict = {}

    def counted(name):
        real = getattr(dist, name)

        def call(*a, **kw):
            key = f"{name}/{dist.get_backend()}"
            collectives[key] = collectives.get(key, 0) + 1
            return real(*a, **kw)
        return call

    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name in ("all_gather", "all_to_all_single"):
            stack.enter_context(mock.patch.object(dist, name,
                                                  counted(name)))
        auto_train_cli.main(["--base_path", str(e_dir), "--intra_block",
                             "1", *flags])
    torch.cuda.synchronize()
    intra_s = time.perf_counter() - t0
    intra_launches = counts()
    # a step gathers the attribute rows, depths, rects and the band, and
    # its backward sends the attribute gradient through one all-to-all
    check(collectives.get("all_to_all_single/nccl") == PIPE_ITERS
          and collectives.get("all_gather/nccl", 0) >= 4 * PIPE_ITERS,
          f"intra-block D = 1 gathers over NCCL every step: {collectives}")
    manifest_of(e_dir)
    check(_block_plys(e_dir)[blocks[0]] == pipe["block0_ply"],
          "intra-block D = 1 writes the sequential block 0's PLY bytes")
    check(intra_launches == {"composite_fwd": PIPE_ITERS,
                             "composite_bwd": PIPE_ITERS,
                             "sorted_segment_sum": PIPE_ITERS,
                             "gather_pack": 0},
          f"intra-block launches B1, B2 and B3 once a step: "
          f"{intra_launches}")

    # (f) a mixed-resolution shared fleet, CPU against card
    t0 = time.perf_counter()
    small, _ = write_scene(root / "mixed", 3, MIXED_GAUSSIANS, 4, dev)
    cpu_l = _mixed_fleet_losses(small, torch.device("cpu"))
    gpu_l = _mixed_fleet_losses(small, dev)
    worst = max(abs(g - c) / abs(c) for gs, cs in zip(gpu_l, cpu_l)
                for g, c in zip(gs, cs))
    check(worst <= MIXED_TOL, f"mixed-resolution fleet losses on the card "
          f"within {MIXED_TOL} of the CPU's: {gpu_l} vs {cpu_l}")
    mixed_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    times = intra_vs_single(visible / blocks[0] / f"partition_{blocks[0]}",
                            dev)
    times_s = time.perf_counter() - t0
    out = {"launches": launches, "intra_block_launches": intra_launches,
           "intra_block_collectives": collectives,
           "fleet_s": fleet_s, "shared_s": shared_s, "nccl_torchrun_s":
           nccl_s, "resumes_s": resume_s, "intra_block_s": intra_s,
           "mixed_s": mixed_s, "step_times_s": times_s,
           "fleet_iteration_ms": iter_ms,
           "fleet_iteration_ms_all": [x * 1e3 for x in iter_s],
           "sequential_4_steps_ms": seq_ms, "step_times": times,
           "mixed_losses": {"cpu": cpu_l, "cuda": gpu_l, "max_rel": worst},
           "phase_s": time.perf_counter() - t_phase, "card": smi}
    log(f"fleet [{smi}]: (b) shared {shared_s:.1f} s, (c) torchrun NCCL "
        f"{nccl_s:.1f} s == (b), (d) two resumes {resume_s:.1f} s equal, "
        f"(e) intra-block D=1 {intra_s:.1f} s == sequential block 0, "
        f"launches {intra_launches}, collectives {collectives}; (f) mixed "
        f"losses max rel {worst:.2e} ({mixed_s:.1f} s); step timings "
        f"{times_s:.1f} s")
    log(f"fleet [{smi}]: step ms (median, synchronised) / device busy ms: "
        + "; ".join(f"{k} {v['step_ms']:.3f} / {v['device_busy_ms']:.3f}"
                    for k, v in times.items())
        + f"; the phase {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# 17. the viewer
# --------------------------------------------------------------------------


def viewer_message(info, size, scaling: float = 1.0) -> dict:
    """The SIBR viewer's message for test camera ``info`` at ``size``,
    built so that ``NetworkGUI.receive`` recovers the camera's viewmat (it
    undoes the Y/Z flips) and, at the camera's own size, the fx and fy that
    ``scene.cameras.from_info`` computes; at another size fov_y keeps
    square pixels."""
    w, h = size
    wvt = world_to_view(info.R, info.t).astype(np.float32).T.copy()
    wvt[:, 1:3] = -wvt[:, 1:3]
    fovy = info.fovy if size == (info.width, info.height) else \
        2.0 * math.atan(math.tan(info.fovx * 0.5) * h / w)
    return {"resolution_x": w, "resolution_y": h, "fov_x": info.fovx,
            "fov_y": fovy, "z_near": 0.01, "z_far": 100.0,
            "view_matrix": [float(v) for v in wvt.flatten()],
            "view_projection_matrix": [float(v)
                                       for v in np.eye(4).flatten()],
            "train": True, "keep_alive": True, "scaling_modifier": scaling}


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        b = sock.recv(min(n - len(buf), 1 << 20))
        if not b:
            raise ConnectionError("the viewer socket closed")
        buf += b
    return bytes(buf)


class ViewerClient(threading.Thread):
    """A viewer on 127.0.0.1:``port``: connects (retrying until the
    listener is up), sends each message and reads its reply, then closes.
    Every socket operation times out after VIEWER_WAIT_S. ``replies`` holds
    (frame bytes, verify string) per message; ``join_checked`` raises what
    went wrong."""

    def __init__(self, port: int, msgs: list):
        super().__init__(daemon=True)
        self.port, self.msgs = port, msgs
        self.connected = threading.Event()
        self.replies, self.error = [], None

    def run(self):
        try:
            deadline = time.monotonic() + VIEWER_WAIT_S
            while True:
                try:
                    sock = socket.create_connection(
                        ("127.0.0.1", self.port), timeout=VIEWER_WAIT_S)
                    break
                except ConnectionRefusedError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            with sock:
                self.connected.set()
                for m in self.msgs:
                    blob = json.dumps(m).encode()
                    sock.sendall(struct.pack("<I", len(blob)) + blob)
                    frame = _recv_exact(
                        sock, m["resolution_x"] * m["resolution_y"] * 3)
                    (n,) = struct.unpack("<I", _recv_exact(sock, 4))
                    self.replies.append(
                        (frame, _recv_exact(sock, n).decode("ascii")))
        except Exception as e:  # noqa: BLE001 -- raised by join_checked
            self.error = e
            self.connected.set()

    def wait_connected(self) -> None:
        check(self.connected.wait(VIEWER_WAIT_S) and self.error is None,
              f"the viewer connected ({self.error!r})")

    def join_checked(self) -> None:
        self.join(VIEWER_WAIT_S)
        check(not self.is_alive(), "the viewer client finished")
        if self.error is not None:
            raise RuntimeError(f"viewer client: {self.error!r}") \
                from self.error
        check(len(self.replies) == len(self.msgs), "one reply per message")
        for (frame, verify), m in zip(self.replies, self.msgs):
            check(len(frame) == m["resolution_x"] * m["resolution_y"] * 3
                  and verify == loop_mod.VIEWER_VERIFY,
                  f"a {m['resolution_x']}x{m['resolution_y']} reply holds "
                  f"w*h*3 bytes and {loop_mod.VIEWER_VERIFY!r}")


def _accepted_gui(msgs: list):
    """(NetworkGUI on an ephemeral port, its ViewerClient for ``msgs``),
    the client accepted and the connection's reads bounded by
    VIEWER_WAIT_S."""
    gui = NetworkGUI("127.0.0.1", 0)
    client = ViewerClient(gui.listener.getsockname()[1], msgs)
    client.start()
    client.wait_connected()
    check(gui.try_connect(), "the viewer was accepted")
    gui.conn.settimeout(VIEWER_WAIT_S)
    return gui, client


def viewer_live(scene: Path, out: Path, phase8_ply: Path, test) -> dict:
    """(a) Phase 8's ``cli.train`` with ``--ip 127.0.0.1 --port <free>``
    and a viewer that connects before the loop starts (the first poll
    accepts it), asks for VIEWER_FRAMES frames with VIEWER_PAUSED paused
    ones half way, and closes. Counts set to 0 just before, read just
    after."""
    half = VIEWER_FRAMES // 2
    cams = [test[i % len(test)] for i in range(VIEWER_FRAMES)]
    msgs = [viewer_message(c, (c.width, c.height)) if i % 2 == 0 else
            viewer_message(c, VIEWER_WIDE, VIEWER_SCALE)
            for i, c in enumerate(cams)]
    msgs[half:half] = [dict(m, train=False)
                       for m in msgs[half:half + VIEWER_PAUSED]]
    port = free_port()
    client = ViewerClient(port, msgs)
    steps, polls = [], []
    real_step, real_poll = loop_mod.train_step_impl, loop_mod.poll_viewer
    real_train = loop_mod.train_scene

    def step(*a, **kw):
        steps.append(1)
        return real_step(*a, **kw)

    def poll(*a, **kw):
        ret = real_poll(*a, **kw)
        polls.append((len(steps), ret))
        return ret

    def train(*a, **kw):
        client.start()
        client.wait_connected()
        return real_train(*a, **kw)

    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    with mock.patch.object(loop_mod, "train_step_impl", step), \
            mock.patch.object(loop_mod, "poll_viewer", poll), \
            mock.patch.object(loop_mod, "train_scene", train):
        train_cli.main(train_argv(scene, out)
                       + ["--ip", "127.0.0.1", "--port", str(port)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    client.join_checked()
    check(len(steps) == TRAIN_ITERS, f"{TRAIN_ITERS} steps")
    first = [ret for _, ret in polls].index(True)
    check(polls[first:first + VIEWER_PAUSED + 1]
          == [(half, True)] * VIEWER_PAUSED + [(half, False)]
          and sum(ret for _, ret in polls) == VIEWER_PAUSED,
          f"no step across the paused frames: polls {polls}")
    check(launches == {"composite_fwd": TRAIN_ITERS + TEST_VIEWS + len(msgs),
                       "composite_bwd": TRAIN_ITERS,
                       "sorted_segment_sum": TRAIN_ITERS, "gather_pack": 0},
          f"B1 once per step, eval view and frame: {launches}")
    ply = out / "point_cloud" / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply"
    check(ply.read_bytes() == phase8_ply.read_bytes(),
          "the viewer changed no bit of training: phase 8's PLY bytes")
    return {"launches": launches, "frames": len(msgs), "wall_s": wall,
            "polls": len(polls), "paused_at_step": half}


def viewer_frames(state, info, dev) -> dict:
    """(b) poll_viewer on the 720k PLY state for test camera ``info`` at
    its 1280x800 and at VIEWER_WIDE: B1's float image against the plain
    version, the received bytes against the image's uint8 cast, and the
    1280x800 frame against the CLI's ``render_view`` of the camera."""
    ocfg, bg = OptimConfig(), torch.zeros(3, device=dev)
    msgs = [viewer_message(info, (info.width, info.height)),
            viewer_message(info, VIEWER_WIDE, VIEWER_SCALE)]
    seen = []
    real_image = loop_mod.viewer_image

    def spy(st, cam, *a):
        image = real_image(st, cam, *a)
        seen.append((cam, image))
        return image

    gui, client = _accepted_gui(msgs)
    try:
        with mock.patch.object(loop_mod, "viewer_image", spy):
            for _ in msgs:
                check(loop_mod.poll_viewer(gui, state, SH_DEGREE, bg, ocfg,
                                           False) is False,
                      "a training viewer's poll returns False")
        client.join_checked()
    finally:
        gui.close()
    out = {}
    for (cam, image), (frame, _) in zip(seen, client.replies):
        size = f"{cam.width}x{cam.height}"
        check(frame == loop_mod.to_frame(image).cpu().numpy().tobytes(),
              f"{size}: the bytes sent are the kernel image's uint8 cast")
        with mock.patch.object(rasterize_mod, "composite_fwd",
                               composite.composite_fwd_plain):
            plain = real_image(state, cam, SH_DEGREE, bg, ocfg)
        err = float((image - plain).abs().max())
        check(err <= KERNEL_ATOL, f"{size}: B1's frame vs plain {err:.3e}")
        out[size] = {"max_abs_err": err}
    view, _ = render_view(state.params, state.alive,
                          cam_mod.from_info(info, -1, load_image=False),
                          SH_DEGREE, bg, max_per_tile=ocfg.max_per_tile,
                          device=dev)
    check((view * 255).astype(np.uint8).tobytes() == client.replies[0][0],
          "the 1280x800 frame is render_view's, cast the same way")
    return out


def viewer_times(state, test, dev) -> dict:
    """(c) Median ms per frame over VIEWER_REPS frames at each size, split
    into render, cast, device-to-host copy and send (each synchronised),
    and B1 alone (``cuda_ms``) on the last frame's inputs."""
    ocfg, bg = OptimConfig(), torch.zeros(3, device=dev)
    out = {}
    for size, scaling in (((W, H), 1.0), (VIEWER_WIDE, VIEWER_SCALE)):
        msgs = [viewer_message(test[i % len(test)], size, scaling)
                for i in range(VIEWER_REPS)]
        parts = {k: [] for k in ("render", "cast", "to_host", "send",
                                 "frame")}
        gui, client = _accepted_gui(msgs)
        try:
            for _ in msgs:
                cam = gui.receive()
                check(cam is not None, "a timed viewer message")
                t = [time.perf_counter()]
                image = loop_mod.viewer_image(state, cam, SH_DEGREE, bg,
                                              ocfg)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                frame = loop_mod.to_frame(image)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                host = frame.cpu().numpy()
                t.append(time.perf_counter())
                gui.send(host, loop_mod.VIEWER_VERIFY)
                t.append(time.perf_counter())
                for k, a, b in (("render", 0, 1), ("cast", 1, 2),
                                ("to_host", 2, 3), ("send", 3, 4),
                                ("frame", 0, 4)):
                    parts[k].append((t[b] - t[a]) * 1e3)
            client.join_checked()
        finally:
            gui.close()
        args = []

        def capture(*a):
            args[:] = a
            return composite.composite_fwd(*a)

        with mock.patch.object(rasterize_mod, "composite_fwd", capture):
            loop_mod.viewer_image(state, cam, SH_DEGREE, bg, ocfg)
        b1_ms = cuda_ms(lambda: composite.composite_fwd(*args), reps=20)
        med = {k: statistics.median(v) for k, v in parts.items()}
        out[f"{size[0]}x{size[1]}"] = dict(
            med, b1_ms=b1_ms, b1_share=b1_ms / med["frame"],
            scaling_modifier=scaling, frames=len(msgs))
    return out


def viewer_path(scene: Path, out: Path, phase8_ply: Path, params, alive,
                dev, smi: str) -> dict:
    """The viewer phase: (a) live training with a viewer, (b) frames
    against the plain version, (c) frame times."""
    t_phase = time.perf_counter()
    test = split_train_test(load_colmap_scene(str(scene)).cameras, True,
                            LLFFHOLD)[1]
    live = viewer_live(scene, out, phase8_ply, test)
    state = SimpleNamespace(params=params, alive=alive)
    frames = viewer_frames(state, test[0], dev)
    times = viewer_times(state, test, dev)
    res = dict(live, frames_vs_plain=frames, times=times,
               phase_s=time.perf_counter() - t_phase, card=smi)
    log(f"viewer: cli train with a viewer, {TRAIN_ITERS} steps and "
        f"{live['frames']} frames ({VIEWER_PAUSED} paused at step "
        f"{live['paused_at_step']}) in {live['wall_s']:.1f} s, launches "
        f"{live['launches']}, PLY == phase 8's; frames vs plain "
        + ", ".join(f"{k} {v['max_abs_err']:.3e}" for k, v in frames.items())
        + f"; bytes == the kernel frame; {W}x{H} == render_view")
    log(f"viewer frames [{smi}]: median ms per frame "
        + "; ".join(f"{k} (scaling {v['scaling_modifier']}): frame "
                    f"{v['frame']:.3f} = render {v['render']:.3f} + cast "
                    f"{v['cast']:.3f} + to host {v['to_host']:.3f} + send "
                    f"{v['send']:.3f}; B1 {v['b1_ms']:.4f} "
                    f"({v['b1_share']:.1%} of the frame)"
                    for k, v in times.items())
        + f"; the phase {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------------------
# 18. the gather experiment
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
    inputs at each N, the bound from the bytes the tool counted, and the
    plane form's sector floor: one 32-B sector per (id, plane), timed at
    the HBM rate, which binds only where every sector comes from HBM
    (repeats and a pack that fits the 50 MB L2 come from L2)."""
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
        bound_ms = r["bytes"] / HBM_BYTES_PER_S * 1e3
        sector_ms = r["plane_sector_bytes"] / HBM_BYTES_PER_S * 1e3
        ms = {f: v["ms"] for f, v in r["forms"].items()}
        by_n[n] = {"bytes": r["bytes"], "bound_ms": bound_ms,
                   "plane_sector_bytes": r["plane_sector_bytes"],
                   "plane_sector_floor_ms": sector_ms,
                   "pack_bytes": 4 * n * r["na"],
                   "plain_ms": r["plain_ms"], "max_abs_err": errs, "ms": ms,
                   "share_of_bound": {f: bound_ms / t for f, t in ms.items()}}
        log(f"gather N={n} (pack {4 * n * r['na']} bytes): forms (ms) {ms}, "
            f"share of the bound "
            + ", ".join(f"{f} {v:.1%}" for f, v in
                        by_n[n]["share_of_bound"].items())
            + f"; plain = index_select {r['plain_ms']:.4f} ms, bytes "
            f"{r['bytes']} (bound {bound_ms:.4f} ms); plane sectors "
            f"{r['plane_sector_bytes']} bytes ({sector_ms:.4f} ms if all came "
            f"from HBM: {bound_ms / sector_ms:.1%} of the bound); "
            f"bit-equal to plain")
    first = by_n[GATHER_N[0]]
    # the headline is the row form, the layout the composite kernels use,
    # at the tool's default shapes; the plain version is the library call
    return {"max_abs_err": max(max(b["max_abs_err"].values())
                               for b in by_n.values()),
            "ms": first["ms"]["form2_row_take"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": first["plain_ms"], "by_n": by_n}


# --------------------------------------------------------------------------
# 19. the quality tools
# --------------------------------------------------------------------------


def quality_kernel_checks(inputs: dict, path: str) -> dict:
    """B1, B2 and B3 on the arguments of a quality path's step with the
    most pairs (``capture_backward``) against their plain versions, at the
    tolerances of phases 5 and 10; B1 gets the arguments B2 got."""
    bargs = inputs["composite_bwd"]
    fargs = bargs[:5]
    color, t_fin, n_contrib = composite.composite_fwd(*fargs)
    p_color, p_tfin, p_nc = composite.composite_fwd_plain(*fargs)
    rows = composite.composite_bwd(*bargs)
    p_rows = composite.composite_bwd_plain(*bargs)
    g_rows, bins, n = inputs["pack_gradient"]
    sums = segsum.gathered_segment_sum(g_rows, bins.order, bins.offsets, n)
    ordered = gaussian_major(g_rows, bins.order)
    p_sums = segsum.sorted_segment_sum_plain(ordered, bins.pair_gid, n)
    wit = fp64_witness(sums, p_sums, ordered, bins.pair_gid, n,
                       f"{path}: the segment sum")
    del ordered
    torch.cuda.synchronize()
    out = {"n_pairs": int(fargs[1].numel()), "tiles": int(fargs[3].numel()),
           "gaussians": n,
           "composite_fwd": max(float((color - p_color).abs().max()),
                                float((t_fin - p_tfin).abs().max())),
           "n_contrib_agree": float((n_contrib == p_nc).float().mean()),
           "composite_bwd": plane_rel(rows, p_rows),
           "sorted_segment_sum": wit["kernel_vs_plain"],
           "segment_sum_fp64_witness": wit}
    log(f"{path}: its heaviest step ({out['n_pairs']} pairs over "
        f"{out['tiles']} tiles, {n} Gaussians) against the plain versions: "
        f"composite_fwd max_abs_err {out['composite_fwd']:.3e} (tol "
        f"{KERNEL_ATOL}), n_contrib agree {out['n_contrib_agree']:.6f}; "
        f"composite_bwd per-plane relative {out['composite_bwd']:.3e} (tol "
        f"{KERNEL_RSUM}); segment sum relative {out['sorted_segment_sum']:.3e}"
        f" (tol {KERNEL_RSEG})")
    check(out["composite_fwd"] <= KERNEL_ATOL
          and out["n_contrib_agree"] >= NCONTRIB_AGREE,
          f"{path}: composite_fwd vs plain on its step: {out}")
    check(out["composite_bwd"] <= KERNEL_RSUM,
          f"{path}: composite_bwd vs plain on its step: {out}")
    return out


def train_check_path() -> dict:
    """(a) ``tools.train_check`` on the card: its scene's GT views, 400
    steps and 2 + 2 eval views, with the launch counts from 0; then the
    kernels on its heaviest step against their plain versions."""
    from pcp_tpu_torch.tools import train_check

    composite.LAUNCHES.clear()
    t0 = time.perf_counter()
    inputs, r = capture_backward(lambda: train_check.run("cuda"))
    torch.cuda.synchronize()
    launches = counts()
    r["wall_s"] = time.perf_counter() - t0
    log(f"train_check: PSNR {r['before']:.2f} -> {r['after']:.2f} (bar: "
        f"+{train_check.GAIN_DB} dB and > {train_check.FLOOR_DB} dB) in "
        f"{r['wall_s']:.1f} s; launches {launches}")
    check(r["ok"], f"train_check's bar: {r}")
    steps = train_check.ITERATIONS
    check(launches["composite_bwd"] == launches["sorted_segment_sum"]
          == steps and launches["composite_fwd"]
          == train_check.N_CAMS + steps + 2 * train_check.EVAL_CAMS,
          f"train_check launches B2 and B3 once a step and B1 once a GT "
          f"view, step and eval view: {launches}")
    return dict(r, launches=launches,
                kernels=quality_kernel_checks(inputs, "train_check"))


def oracle_cpu_vs_cuda(seed: int) -> float:
    """The dense oracle on a small cloud on the CPU and on the card."""
    from pcp_tpu_torch.ops.projection import CameraIntrin
    from pcp_tpu_torch.tools.oracle import rasterize_dense
    from pcp_tpu_torch.tools.synthetic import (
        look_at_w2c,
        make_gaussian_cloud,
        viewmat_of,
    )

    xyz, rgb, scales, quats, op = make_gaussian_cloud(
        np.random.default_rng(seed), ORACLE_SMALL[0])
    w, h = ORACLE_SMALL[1]
    vm = viewmat_of(*look_at_w2c((5.0, 1.0, 2.0), (0.0, 0.0, 0.0)))
    intr = CameraIntrin(*(np.float32(v) for v in (0.9 * w, 0.9 * w, w / 2,
                                                  h / 2)))
    sh = rgb_to_sh(rgb)[:, None, :]
    args = (xyz, scales, quats, op, sh, vm, intr, (w, h),
            np.zeros(3, np.float32), 0)
    ref_img, ref_t = rasterize_dense(*args, device="cpu")
    img, t_fin = rasterize_dense(*args, device="cuda")
    err = float(max(np.abs(img - ref_img).max(), np.abs(t_fin - ref_t).max()))
    log(f"oracle CPU vs card: {ORACLE_SMALL[0]} Gaussians at {w}x{h}, "
        f"max abs err {err:.3e} (tolerance {ORACLE_TOL})")
    check(err <= ORACLE_TOL, f"the oracle on the card matches the CPU: {err}")
    return err


def oracle_vs_b1(qsr, block_dir: Path, view: int, dev,
                 exact_check: bool = True) -> dict:
    """B1's float image of held-out view ``view`` of the true cloud,
    through ``rasterize`` at the GT's max_per_tile, against the dense
    oracle's in the exact depth order and in the pair key's, with no
    colour correction. The exact order is held to ORACLE_GT_DB only where
    ``exact_check``; elsewhere it is logged (ROADMAP C1, the key's depth
    bits)."""
    from pcp_tpu_torch.scene import load_scene
    from pcp_tpu_torch.tools.oracle import rasterize_dense

    scene = load_scene(str(block_dir), eval_split=True)
    info = split_train_test(scene.cameras, True, qsr.LLFFHOLD)[1][view]
    cam = cam_mod.from_info(info, 1, load_image=False)
    xyz, rgb, scales, quats, op = qsr.make_true_cloud(
        np.random.default_rng(31))
    args = (xyz, scales, quats, op, rgb_to_sh(rgb)[:, None, :], cam.viewmat,
            qsr._intrin(dev), (qsr.W, qsr.H), np.zeros(3, np.float32), 0)
    with torch.no_grad():
        img, _ = rasterize(*args, max_per_tile=4096, device=dev)
    img = img.cpu().numpy()
    bits = key_depth_bits(-(-qsr.W // TILE) * -(-qsr.H // TILE))
    out = {"view": view, "key_depth_bits": bits}
    for name, kw in (("exact", {}), ("key", {"depth_bits": bits})):
        o_img, _ = rasterize_dense(*args, device=dev, **kw)
        diff = img.astype(np.float64) - o_img
        raw = evaluate_images([img], [o_img], use_color_correct=False,
                              device=dev)["mean"]
        out[name] = {"PSNR": raw["PSNR"], "SSIM": raw["SSIM"],
                     "channel_mean_offset":
                         diff.reshape(-1, 3).mean(0).tolist(),
                     "max_abs_err": float(np.abs(diff).max())}
        r = out[name]
        log(f"B1 vs the oracle ({name} order) on held-out view {view} "
            f"({qsr.W}x{qsr.H}, {xyz.shape[0]} Gaussians), float images, no "
            f"colour correction: PSNR {r['PSNR']:.2f} dB, SSIM "
            f"{r['SSIM']:.6f}, channel mean offsets "
            f"{[f'{v:.2e}' for v in r['channel_mean_offset']]}, max_abs_err "
            f"{r['max_abs_err']:.3e}")
    if exact_check:
        check(out["exact"]["PSNR"] >= ORACLE_GT_DB,
              f"B1's float image vs the oracle's {out['exact']['PSNR']:.2f} "
              f"dB >= {ORACLE_GT_DB}")
    key = out["key"]
    check(key["PSNR"] >= ORACLE_RAW_DB
          and max(map(abs, key["channel_mean_offset"])) <= ORACLE_RAW_BIAS
          and key["max_abs_err"] <= ORACLE_RAW_ATOL,
          f"B1's float image vs the oracle's in the key's order (PSNR >= "
          f"{ORACLE_RAW_DB}, offsets <= {ORACLE_RAW_BIAS}, values within "
          f"{ORACLE_RAW_ATOL}): {key}")
    return out


def quality_scale_path(root: Path, preset: str = "ref100k",
                       iters: int = 0) -> dict:
    """``tools.quality_scale_run`` at ``preset``'s full width with the
    launch counts from 0: (b) ``--smoke`` at ref100k (both variants, 1500
    steps, ``PCP_ORACLE_VIEWS`` = 1) when ``iters`` is 0; (c) else the
    preset's scene, partition, the densify variant for ``iters`` steps and
    the eval, phase by phase as a run across machines takes them, with no
    oracle view in the eval (``oracle_vs_b1`` scores one)."""
    from pcp_tpu_torch.scene import load_scene

    smoke = not iters
    env = {"PCP_QSR_PRESET": preset, "PCP_ORACLE_VIEWS": "1" if smoke else "0"}
    with mock.patch.dict(os.environ, env):
        qsr = importlib.reload(importlib.import_module(
            "pcp_tpu_torch.tools.quality_scale_run"))
        argv = ["--root", str(root), "--device", "cuda"]
        if smoke:
            iters = 1500

            def run():
                return qsr.main(argv + ["--smoke"])
        else:
            argv += ["--iters", str(iters),
                     "--out", str(root / f"QUALITY_{preset}_cut.json")]

            def run():
                for ph in ("scene", "partition", "train"):
                    qsr.main(argv + ["--phase", ph])
                return qsr.main(argv + ["--phase", "eval"])
        composite.LAUNCHES.clear()
        t0 = time.perf_counter()
        inputs, art = capture_backward(run)
        torch.cuda.synchronize()
        launches = counts()
        wall_s = time.perf_counter() - t0
    visible = root / "model" / "split_result" / "visible"
    blocks = sorted(p.name for p in visible.iterdir() if p.is_dir())
    block_dir = Path(qsr.block_dir_of(str(root), art["workload"]["block"]))
    n_test = len(split_train_test(load_scene(str(block_dir)).cameras, True,
                                  qsr.LLFFHOLD)[1])
    n_gt = qsr.N_CAMS_RING + qsr.N_CAMS_GRID
    runs = {r["variant"]: r for r in art["runs"]}
    out = {"preset": preset, "width": [qsr.W, qsr.H],
           "capacity": qsr.CAPACITY, "iterations": iters, "wall_s": wall_s,
           "phase_seconds": art["phase_seconds"], "blocks": len(blocks),
           "n_test": n_test, "launches": launches,
           "oracle_gt": art["oracle_gt"], "hbm": art["hbm"], "runs": {}}
    suffix = "_smoke" if smoke else ""
    variants = [("densify", "output_densify", qsr.CAPACITY),
                ("no_densify_control", "output_control",
                 qsr.CAPACITY_CONTROL)][:2 if smoke else 1]
    check(sorted(runs) == sorted(v[0] for v in variants),
          f"the eval scores {[v[0] for v in variants]}: {sorted(runs)}")
    for name, sub, cap in variants:
        logged = loss_rows(read_log(str(block_dir / (sub + suffix))))
        alive = [r["total_points"] for r in logged]
        run = runs[name]
        out["runs"][name] = {
            k: run[k] for k in ("iterations", "alive_final", "PSNR", "SSIM",
                                "LPIPS", "wall_minutes", "snapshot_curve",
                                "population_curve")}
        out["runs"][name].update(alive_initial=alive[0], alive_max=max(alive))
        check(all(math.isfinite(r["train_loss_patches/total_loss"])
                  for r in logged), f"{name}: every logged loss is finite")
        check(max(alive) <= cap, f"{name}: alive within {cap} slots")
        snap = run["snapshot_curve"]
        check(run["iterations"] == iters, f"{name}: {iters} steps: {run}")
        if smoke:
            check(snap and snap[-1]["iter"] == 1000
                  and run["PSNR"] > snap[-1]["PSNR"],
                  f"{name}: PSNR at {iters} above the 1000-step snapshot: "
                  f"{snap} -> {run['PSNR']}")
    dens = out["runs"]["densify"]
    check(dens["alive_max"] > dens["alive_initial"],
          f"densify grows the population: {dens['alive_initial']} -> "
          f"{dens['alive_max']}")
    check(len(blocks) == 16, f"the partition gives 16 blocks: {blocks}")
    if smoke:
        o_psnr = art["oracle_gt"]["production_gt_vs_oracle_gt"]["PSNR"]
        check(o_psnr >= ORACLE_GT_DB,
              f"production GT vs oracle GT {o_psnr:.2f} dB >= "
              f"{ORACLE_GT_DB}")
    steps = len(variants) * iters
    snap_views = n_test * sum(len(r["snapshot_curve"]) + 1
                              for r in runs.values())
    check(launches["composite_bwd"] == launches["sorted_segment_sum"]
          == steps and launches["composite_fwd"]
          == steps + n_gt + snap_views,
          f"the quality path launches B2 and B3 once a step and B1 once a "
          f"step, GT view and snapshot view ({steps} steps, {n_gt} GT "
          f"views, {snap_views} snapshot views): {launches}")
    out["kernels"] = quality_kernel_checks(
        inputs, f"quality_scale_run {preset}")
    del inputs
    view = art["oracle_gt"]["views"][0] if smoke else 0
    out["oracle_vs_b1"] = oracle_vs_b1(qsr, block_dir, view,
                                       torch.device("cuda"),
                                       exact_check=smoke)
    cut = ("--smoke" if smoke else
           f"depth cut to {iters} of 30,000 steps (densify from 500, every "
           f"100, to {iters}), the densify variant only, no oracle view in "
           f"the eval")
    log(f"quality_scale_run {preset} ({cut}; {qsr.W}x{qsr.H}, "
        f"{qsr.N_SFM} SfM points, {n_gt} cameras, capacity {qsr.CAPACITY}): "
        f"{len(blocks)} blocks, {n_test} held-out views, the run "
        f"{wall_s:.1f} s (phases {art['phase_seconds']}); "
        + "; ".join(f"{k}: alive {v['alive_initial']} -> {v['alive_final']} "
                    f"(max {v['alive_max']}), PSNR "
                    + (f"{v['snapshot_curve'][-1]['PSNR']:.2f} "
                       f"@{v['snapshot_curve'][-1]['iter']} -> "
                       if v["snapshot_curve"] else "")
                    + f"{v['PSNR']:.2f} @{v['iterations']}, SSIM "
                    f"{v['SSIM']:.4f}, LPIPS {v['LPIPS']:.4f} (synthetic), "
                    f"step ms {[c['step_ms'] for c in v['population_curve']]}"
                    for k, v in out["runs"].items())
        + (f"; production GT vs oracle GT "
           f"{art['oracle_gt']['production_gt_vs_oracle_gt']['PSNR']:.2f} "
           f"dB, oracle {art['oracle_gt']['seconds_per_view']} s/view"
           if smoke else "")
        + f"; memory {art['hbm']}; launches {launches}")
    return out


def quality_path(root: Path, seed: int, smi: str) -> dict:
    t_phase = time.perf_counter()
    res = {"train_check": train_check_path(),
           "oracle_cpu_vs_cuda": oracle_cpu_vs_cuda(seed),
           "scale_smoke": quality_scale_path(root / "ref100k")}
    shutil.rmtree(root / "ref100k")
    res["default_tier"] = quality_scale_path(root / "ref500k", "ref500k",
                                             DEFAULT_TIER_ITERS)
    res.update(phase_s=time.perf_counter() - t_phase, card=smi)
    log(f"quality tools: the phase {res['phase_s']:.1f} s [{smi}]")
    return res


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-eval-runs", type=int, default=0,
                    help="run only phase 14, this many times, and check "
                    "that every run gives the same bits")
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
                                          dev)))
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
            inputs["pack_gradient"], train["launches"]["sorted_segment_sum"])
        del inputs, state
        for name, r in real_block_checks(args.seed, dev).items():
            measured[name]["real_block"] = r
        small = cpu_vs_cuda_step(params, alive, cam, gt, 40_000, args.seed)

        weights = write_lpips_bundle(Path(tmp) / "lpips.npz", args.seed)
        ev = eval_path(model, weights)
        ev["times"] = eval_times(model / "test" / "ours_merged", weights, dev)
        ev["cpu_vs_cuda"] = eval_cpu_vs_cuda(weights, args.seed)
        fe = full_eval_path(Path(tmp) / "full_eval", args.seed + 1, dev)
        pipe = pipeline_path(Path(tmp) / "pipeline", args.seed + 2, dev,
                             weights, smi)
        multi = multi_path(Path(tmp) / "multi", pipe, dev, smi)
        del pipe["visible"], pipe["block0_ply"]
        viewer = viewer_path(
            scene, Path(tmp) / "viewer", Path(tmp) / "train" / "point_cloud"
            / f"iteration_{TRAIN_ITERS}" / "point_cloud.ply", params, alive,
            dev, smi)

        gather = gather_path()
        measured["gather_pack"] = gather_checks(gather["runs"], dev)
        other = exp_r2.main(["sort"])
        other.update(exp_r2.main(["xlagather"]))
        quality = quality_path(Path(tmp) / "quality", args.seed + 3, smi)

    paths = {"render": run["launches"], "train": train["launches"],
             "metrics": ev["launches"], "full_eval": fe["launches"],
             "pipeline": pipe["launches"], "fleet": multi["launches"],
             "intra_block": multi["intra_block_launches"],
             "viewer": viewer["launches"],
             "quality_check": quality["train_check"]["launches"],
             "quality_scale": quality["scale_smoke"]["launches"],
             "quality_default_tier": quality["default_tier"]["launches"],
             "exp_r2": gather["launches"]}
    main_path_of = {"composite_fwd": "train", "composite_bwd": "train",
                    "sorted_segment_sum": "train", "gather_pack": "exp_r2"}
    print(json.dumps({"render": dict(render, views=run["views"]),
                      "train": dict(train, step=step, small=small),
                      "eval": ev, "full_eval": fe, "pipeline": pipe,
                      "multi": multi, "viewer": viewer, "quality": quality,
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
