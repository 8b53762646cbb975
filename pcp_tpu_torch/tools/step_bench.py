"""Fast full-train-step timing on the canonical bench scene (the port's
counterpart of ``tools/step_bench.py``): ``pcp_tpu_torch.bench`` without
the sweep, the breakdown and the roofline, for quick A/B runs.

    python -m pcp_tpu_torch.tools.step_bench [max_per_tile] [--device cpu]

Prints one JSON line with the JAX tool's keys. ``max_per_tile`` (default
0: no clamp, the bench's geometry) is the nearest-K clamp of each tile's
list; ``binning`` is always ``"exact"`` (variable-length pair lists).
Without ``--device cpu`` it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import json

ITERS = 30
WARMUP = 3


def main(argv=None) -> int:
    from pcp_tpu_torch import bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("max_per_tile", type=int, nargs="?", default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    p = bench.make_point(device=args.device, max_per_tile=args.max_per_tile,
                         **bench.CANONICAL)
    ips, m = bench.time_steps(p.step, WARMUP, ITERS)
    print(json.dumps({
        "step_ms": 1e3 / ips,
        "iters_per_sec": ips,
        "n_pairs": int(m["n_pairs"]),
        "max_tile_load": int(m["max_tile_load"]),
        "overflow": bool(m["overflow"]),
        "n_dropped": int(m["n_dropped"]),
        "tile_saturated": bool(m["tile_saturated"]),
        "max_per_tile": args.max_per_tile,
        "binning": "exact",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
