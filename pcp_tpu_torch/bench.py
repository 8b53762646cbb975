"""Benchmark: per-block training throughput on one CUDA card (the port's
counterpart of the root ``bench.py``).

    python -m pcp_tpu_torch.bench [--device cpu]

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``,
``unit``, ``vs_baseline``, the scale-free ``pairs_per_sec``, ``n_pairs``,
``max_tile_load``, the honesty fields ``overflow`` and ``tile_saturated``
(both must be false: no compositing work dropped), ``roofline`` (the step
against one H100's peaks, ``tools/roofline.py``), ``geometry``,
``scale_sweep`` and ``breakdown``; and beside them ``n_dropped``,
``device_busy_ms``, ``device_idle_share``, ``peak_memory_bytes`` and
``device`` (the card's name and power limit).

Workload: the reference's hot path (train.py:94-157): the full
differentiable render (preprocess -> binning -> the blend, B1), appearance
decoupling, 0.8 L1 + 0.2 (1 - SSIM), the backward (B2, B3 and autograd) and
Adam, at SH degree 3 with the appearance net, on the bench scene
(``tools/bench_scene.py``): 100k live Gaussians in 2^17 slots at 800x600 is
the canonical ``vs_baseline`` point. The scale sweep adds 500k and 1M live
at 800x600 and the reference-scale point of ``tools/profile_scale.py``
(719,802 live in 2^21 slots at 1280x800, fx = fy = 850).

Geometry: the port's pair lists are exact and variable-length, so nothing
is sized ahead; the steps run with ``max_per_tile=0``, no nearest-K clamp
(the counterpart of the JAX bench's production ``--max_per_tile 0``
geometry). ``bench.py``'s ``fixed_k512_iters_per_sec`` timed the TPU
kernel's K axis at 512 slots a tile; the port's blend has no K axis, so that
key is dropped.

The breakdown (``PCP_BENCH_BREAKDOWN``, default 1) is
``tools.profile_stages.stage_breakdown`` at the canonical point, in this
process after its timed steps; ``PCP_BENCH_SWEEP`` (default 1) runs the
sweep.

Baseline: the reference publishes no numbers (BASELINE.md); vanilla Inria
3DGS trains 30k iterations in roughly 25 minutes on a 24 GB-class CUDA GPU
at comparable scene scale, i.e. ~20 iters/s. vs_baseline is measured
iters/s / 20.

Without ``--device cpu`` it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

BASELINE_ITERS_PER_SEC = 20.0
WARMUP = 3
ITERS = 30
SWEEP_POINTS = (500_000, 1_000_000)
SWEEP_ITERS = 12
BREAKDOWN_REPS = 10                # tools/profile_stages.py's --iters
SH_DEGREE = 3
EXTENT = 30.0                      # the step's spatial_lr_scale
CANONICAL = dict(n_points=100_000, width=800, height=600, fx=700.0)
# tools/profile_scale.py's point: the reference's 719,802-point block
SCALE_POINT = dict(n_points=719_802, capacity=1 << 21, width=1280,
                   height=800, fx=850.0)


def train_state(params, alive, dev, seed: int):
    """A fresh TrainState: the appearance net drawn from ``seed``, zero Adam
    moments and densify statistics."""
    from pcp_tpu_torch.models import gaussians as G
    from pcp_tpu_torch.models.appearance import init_appearance
    from pcp_tpu_torch.train import optim
    from pcp_tpu_torch.train.step import TrainState, app_groups

    app = init_appearance(torch.Generator().manual_seed(seed), dev)
    return TrainState(params, app, optim.init_adam(params),
                      optim.init_adam(app_groups(app)), alive,
                      G.init_densify_stats(alive.shape[0], dev))


def make_point(n_points: int, width: int = 800, height: int = 600,
               fx: float = 700.0, capacity: int = None, seed: int = 0,
               device=None, max_per_tile: int = 0) -> SimpleNamespace:
    """The bench scene at ``n_points`` live (``.capacity`` slots) and a
    ``.step()`` that trains it one step in place and returns (state,
    metrics): the bench view, a uniform GT drawn from the scene's rng after
    the scene, a black background, view 0, extent 30, SH 3, the appearance
    net on, ``max_per_tile`` the tile clamp (0: none)."""
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.tools import bench_scene as BS
    from pcp_tpu_torch.train.config import OptimConfig
    from pcp_tpu_torch.train.step import train_step_impl

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params, alive = BS.make_scene(rng, n_points, capacity, width, height,
                                  fx, dev)
    capacity = params["xyz"].shape[0]
    viewmat, intrin = BS.camera(width, height, fx, dev)
    state = train_state(params, alive, dev, seed)
    ocfg = OptimConfig(capacity=capacity, max_per_tile=max_per_tile)
    gt = torch.as_tensor(
        rng.uniform(0, 1, (height, width, 3)).astype(np.float32), device=dev)
    bg = torch.zeros(3, device=dev)

    def step():
        return train_step_impl(
            state, viewmat, intrin, gt, 0, bg, EXTENT, ocfg=ocfg,
            image_size=(width, height), sh_degree=SH_DEGREE,
            use_appearance=True)

    return SimpleNamespace(step=step, capacity=capacity)


def time_steps(step, warmup: int, iters: int) -> tuple:
    """(iters/s of ``iters`` back-to-back steps after ``warmup``, with one
    synchronisation at the end; the last step's metrics)."""
    from pcp_tpu_torch.tools.profile_stages import sync

    for _ in range(warmup):
        step()
    sync()
    m = None
    t0 = time.perf_counter()
    for _ in range(iters):
        _, m = step()
    sync()
    return iters / (time.perf_counter() - t0), m


def run_point(n_points, warmup, iters, width=800, height=600, fx=700.0,
              capacity=None, seed=0, device=None,
              breakdown_reps: int = 0) -> tuple:
    """Build the bench scene at ``n_points`` live and time the full train
    step. Returns (iters_per_sec, honesty): ``n_live``, ``capacity``,
    ``n_pairs``, ``max_tile_load``, ``n_dropped``, ``overflow`` and
    ``tile_saturated`` of the last timed step; ``roofline``, the step
    against its bound (``roofline.brief``), with B1's and B2's work counted
    on one more step's inputs; and ``breakdown``, ``stage_breakdown`` over
    ``breakdown_reps`` steps (None at 0), whose stage times the roofline
    then scores."""
    from pcp_tpu_torch.tools import roofline
    from pcp_tpu_torch.tools.profile_stages import (
        capture_backward,
        stage_breakdown,
    )

    p = make_point(n_points, width, height, fx, capacity, seed, device)
    ips, m = time_steps(p.step, warmup, iters)
    honesty = {
        "n_live": int(n_points),
        "capacity": int(p.capacity),
        "n_pairs": int(m["n_pairs"]),
        "max_tile_load": int(m["max_tile_load"]),
        "n_dropped": int(m["n_dropped"]),
        "overflow": bool(m["overflow"]),
        "tile_saturated": bool(m["tile_saturated"]),
    }
    breakdown = (stage_breakdown(p.step, breakdown_reps)
                 if breakdown_reps else None)
    inputs, _ = capture_backward(p.step)
    bwd_args = inputs["composite_bwd"]
    r = roofline.summarize(
        1e3 / ips,
        stage_ms=breakdown["stage_device_ms"] if breakdown else None,
        capacity=p.capacity, n_pairs=int(bwd_args[1].numel()), width=width,
        height=height, sh_degree=SH_DEGREE,
        work=roofline.kernel_work(bwd_args))
    honesty.update(roofline=roofline.brief(r), breakdown=breakdown)
    return ips, honesty


def main(argv=None) -> int:
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.tools.profile_stages import card_text

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    reps = (BREAKDOWN_REPS
            if os.environ.get("PCP_BENCH_BREAKDOWN", "1") == "1" else 0)
    iters_per_sec, honesty = run_point(
        warmup=WARMUP, iters=ITERS, device=dev, breakdown_reps=reps,
        **CANONICAL)
    breakdown = honesty.pop("breakdown")

    sweep = []
    if os.environ.get("PCP_BENCH_SWEEP", "1") == "1":
        points = [dict(CANONICAL, n_points=n) for n in SWEEP_POINTS]
        for point in points + [SCALE_POINT]:
            ips, h = run_point(warmup=2, iters=SWEEP_ITERS, device=dev,
                               **point)
            h.pop("breakdown")
            sweep.append({"iters_per_sec": ips,
                          "pairs_per_sec": h["n_pairs"] * ips,
                          "width": point["width"],
                          "height": point["height"], **h})

    bd = breakdown or {}
    print(json.dumps({
        "metric": "train_iters_per_sec_100k_gauss_800x600",
        "value": iters_per_sec,
        "unit": "iters/s",
        "vs_baseline": iters_per_sec / BASELINE_ITERS_PER_SEC,
        "pairs_per_sec": honesty["n_pairs"] * iters_per_sec,
        **{k: honesty[k] for k in ("n_pairs", "max_tile_load", "overflow",
                                   "tile_saturated", "n_dropped")},
        "roofline": honesty["roofline"],
        "geometry": "exact: variable-length pair lists, no tile clamp",
        "scale_sweep": sweep,
        "breakdown": breakdown,
        "device_busy_ms": bd.get("device_busy_ms"),
        "device_idle_share": bd.get("device_idle_share"),
        "peak_memory_bytes": bd.get("peak_memory_bytes"),
        "device": card_text(dev),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
