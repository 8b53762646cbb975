"""Approximate 3-nearest-neighbour mean squared distance (counterpart of
``pcp_tpu/ops/knn.py`` ``mean_sq_dist_3nn``; simple-knn's distCUDA2, used
once per block for the scale init, gaussian_model.py:144).

The same Morton-window algorithm as the JAX version, in torch ops: 30-bit
Morton codes under three axis-permuted interleavings, one stable argsort
per ordering, the +/- ``window`` neighbours in each ordering as candidates,
per-row dedup, and the 3 smallest squared distances. The uint32 bit
arithmetic runs in int64: every intermediate keeps its low 32 bits, so the
codes equal the uint32 ones. Clamped to >= 1e-7.
"""

from __future__ import annotations

import torch

_MORTON_BITS = 10  # 10 bits/axis -> 30-bit codes (simple_knn.cu coord2Morton)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` with 2 zero bits between each
    (simple_knn.cu:45-56 prepMorton)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, perm=(0, 1, 2)) -> torch.Tensor:
    """(N,) int64 30-bit Morton codes of (N, 3) fp32 points, isotropically
    quantised; ``perm`` picks which axis takes which interleave position."""
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    scale = (2.0 ** _MORTON_BITS - 1.0) / torch.clamp_min((hi - lo).max(),
                                                          1e-12)
    q = torch.clamp((points - lo) * scale, 0.0, 2.0 ** _MORTON_BITS - 1.0)
    q = q.to(torch.int64)
    a, b, c = perm
    return (_expand_bits(q[:, a]) | (_expand_bits(q[:, b]) << 1)
            | (_expand_bits(q[:, c]) << 2))


def _window_candidates(order: torch.Tensor, window: int) -> torch.Tensor:
    """(N, 2*window) original-index candidates from a Morton ordering."""
    n = order.shape[0]
    dev = order.device
    pos = torch.arange(n, device=dev)[:, None]
    offs = torch.cat([torch.arange(-window, 0, device=dev),
                      torch.arange(1, window + 1, device=dev)])[None, :]
    cands_sorted = order[torch.clamp(pos + offs, 0, n - 1)]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=dev)
    return cands_sorted[inv]


def _knn_window_d2(points: torch.Tensor, window: int) -> torch.Tensor:
    """(N, 6*window) sorted squared candidate distances; self and duplicate
    candidates are +inf."""
    n = points.shape[0]
    ids = torch.arange(n, device=points.device)[:, None]
    cands = torch.cat([
        _window_candidates(torch.argsort(morton_codes(points, perm),
                                         stable=True), window)
        for perm in ((0, 1, 2), (1, 2, 0), (2, 0, 1))
    ], dim=1)
    cands = torch.sort(cands, dim=1).values
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool,
                                 device=points.device),
                     cands[:, 1:] == cands[:, :-1]], dim=1)
    cands = torch.where(dup, ids, cands)
    d2 = torch.sum((points[:, None, :] - points[cands]) ** 2, dim=-1)
    d2 = torch.where(cands == ids, torch.full_like(d2, float("inf")), d2)
    return torch.sort(d2, dim=1).values


def mean_sq_dist_3nn(points: torch.Tensor, window: int = 16) -> torch.Tensor:
    """Per-point mean squared distance to the (approximate) 3 nearest
    neighbours: (N,) fp32, clamped to >= 1e-7."""
    points = points.to(torch.float32)
    n = points.shape[0]
    if n <= 4:
        d2 = torch.sum((points[:, None] - points[None, :]) ** 2, dim=-1)
        d2 = torch.where(torch.eye(n, dtype=torch.bool, device=points.device),
                         torch.full_like(d2, float("inf")), d2)
        top = torch.sort(d2, dim=1).values[:, :min(3, n - 1)]
        return torch.clamp_min(top.mean(dim=1), 1e-7)
    top3 = _knn_window_d2(points, window)[:, :3]
    finite = torch.isfinite(top3)
    cnt = torch.clamp_min(finite.sum(dim=1), 1)
    mean = torch.where(finite, top3, torch.zeros_like(top3)).sum(dim=1) / cnt
    return torch.clamp_min(mean, 1e-7)
