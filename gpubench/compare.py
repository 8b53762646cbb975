"""The numbers that decide ``correct``: each a gap between what the port
produced on the timed path and what the plain reference computes from the
same inputs, held against a limit of its own (``gpubench/limits``)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import numpy as np


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / max(abs(ref), 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip: Optional[set] = None) -> Dict[str, float]:
    """Each leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if not (skip and k in skip)}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             skip: Optional[set] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, skip).values())


def negligible(ref_grads: Dict[str, float]) -> set:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: Adam moves them by round-off alone."""
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v < 1e-3 * med}


def image_gaps(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """Largest and mean absolute difference of two (H, W, 3) images."""
    d = np.abs(prog.astype(np.float64) - ref.astype(np.float64))
    return {"max": float(d.max()), "mean": float(d.mean())}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """[{name, value, limit, ok}] for every limited number; a number that
    is missing or not finite fails."""
    out = []
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and np.isfinite(v) and v <= limit
        out.append({"name": name, "value": None if v is None else float(v),
                    "limit": float(limit), "ok": bool(ok)})
    return out
