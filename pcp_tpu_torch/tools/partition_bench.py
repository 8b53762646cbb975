"""Partition throughput benchmark: a 5M-point synthetic cloud end to end
(the port's counterpart of ``tools/partition_bench.py``).

    python -m pcp_tpu_torch.tools.partition_bench [--out PATH]
        [--device cpu]

Times ``partition.pipeline.ProgressiveDataPartitioning.run()`` (outlier
filter -> bisection -> expansion -> camera assignment -> visibility
selection) at threshold 500,000, with no plots, no image copies and no
export, in a temporary directory, and prints one JSON line with the JAX
tool's keys plus ``n_points_assigned`` (the distinct points the blocks
hold), ``n_outliers`` (what the outlier filter drops, run again after the
timed run), ``all_assigned`` (the blocks hold exactly the points the filter
keeps) and ``device``. It writes the line to ``--out`` only (the
JAX tool's ``PARTITION_BENCH.json`` is that package's record). The outlier
screen runs on the card without the native filter and without ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
import time

import numpy as np

N_POINTS = 5_000_000
N_CAMS = 500
THRESHOLD = 500_000


def make_scene(n_points: int = N_POINTS, n_cams: int = N_CAMS):
    """The JAX tool's scene, the same draws: an urban-scale 400 x 400 m
    quasi-2.5D surface (aerial SfM clouds concentrate on ground and roofs;
    ~31 points/m^2 at 5M) and ``n_cams`` nadir cameras on rings 40 m up."""
    from pcp_tpu_torch.scene.dataset import CameraInfo, SceneInfo, \
        nerfpp_extent

    rng = np.random.default_rng(0)
    pts = np.stack(
        [rng.uniform(-200, 200, n_points), rng.uniform(-200, 200, n_points),
         rng.normal(0, 0.5, n_points)], -1,
    ).astype(np.float32)
    cols = rng.uniform(0, 1, (n_points, 3)).astype(np.float32)

    cams = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        r = 30 + 150 * (i % 10) / 10
        pos = np.array([r * math.cos(ang), r * math.sin(ang), 40.0])
        R = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
        t = -R @ pos
        cams.append(CameraInfo(
            uid=i, image_id=i + 1, R=R, t=t, fovx=1.2, fovy=0.9,
            width=1600, height=1200, image_name=f"im{i}.jpg",
        ))
    centers = np.stack([c.center for c in cams])
    return SceneInfo(cameras=cams, points=pts, colors=cols,
                     extent=nerfpp_extent(centers))


def main(argv=None) -> int:
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.partition.pipeline import (
        PartitionConfig,
        ProgressiveDataPartitioning,
    )
    from pcp_tpu_torch.tools.profile_stages import card_text

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scene = make_scene(N_POINTS, N_CAMS)
    cfg = PartitionConfig(threshold=THRESHOLD, make_plots=False,
                          copy_images=False, device=str(dev))
    with tempfile.TemporaryDirectory() as td:
        pdp = ProgressiveDataPartitioning(scene, td, cfg)
        t0 = time.perf_counter()
        records = pdp.run()
        dt = time.perf_counter() - t0
        kept = pdp.filter_points()
    held = np.unique(np.concatenate([r.point_indices for r in records]))
    result = {
        "metric": "partition_5M_points_seconds",
        "value": dt,
        "unit": "s",
        "n_points": N_POINTS,
        "n_cameras": N_CAMS,
        "n_blocks": len(records),
        "mpts_per_sec": N_POINTS / dt / 1e6,
        "target_seconds": 10.0,
        "meets_target": dt < 10.0,
        "n_points_assigned": int(held.size),
        "n_outliers": N_POINTS - len(kept),
        "all_assigned": bool(np.array_equal(held, kept)),
        "device": card_text(dev),
    }
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
