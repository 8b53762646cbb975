"""Approximate 3-nearest-neighbour mean squared distance (counterpart of
``pcp_tpu/ops/knn.py`` ``mean_sq_dist_3nn``; simple-knn's distCUDA2, used
once per block for the scale init, gaussian_model.py:144), and the squared
distance to the approximate k-th nearest neighbour (``kth_nn_dist2`` on
tensors, ``kth_nn_dist2_np`` on numpy arrays; JAX knn.py:135-251).

The same Morton-window algorithm as the JAX version, in torch ops: 30-bit
Morton codes under three axis-permuted interleavings, one stable argsort
per ordering, the +/- ``window`` neighbours in each ordering as candidates,
per-row dedup, and the 3 smallest squared distances. The uint32 bit
arithmetic runs in int64: every intermediate keeps its low 32 bits, so the
codes equal the uint32 ones. Clamped to >= 1e-7.
"""

from __future__ import annotations

import numpy as np
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


_PERMS = ((0, 1, 2), (1, 2, 0), (2, 0, 1))


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
        for perm in _PERMS
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


def kth_nn_dist2(points: torch.Tensor, k: int, window: int = 16,
                 chunk: int = 1 << 19) -> torch.Tensor:
    """(N,) fp32 squared distance to the approximate k-th nearest neighbour,
    on the points' device; +inf for every point when N <= k. An
    approximation from above: a true neighbour outside every Morton window
    is missed. Above ``chunk`` points each ordering keeps only every
    point's k nearest (distance, id) candidates, ``chunk`` rows at a time,
    and the three lists merge by id, so no (N, 6 * window) array is made."""
    points = points.to(torch.float32)
    n = points.shape[0]
    dev = points.device
    if n <= k:
        return torch.full((n,), float("inf"), device=dev)
    if k > 6 * window:
        raise ValueError(f"k = {k} exceeds the {6 * window} candidates")
    if n <= chunk:
        return _knn_window_d2(points, window)[:, k - 1]

    inf = torch.tensor(float("inf"), device=dev)
    per_d2, per_id = [], []
    for perm in _PERMS:
        cands = _window_candidates(
            torch.argsort(morton_codes(points, perm), stable=True), window)
        ds, ids = [], []
        for r0 in range(0, n, chunk):
            c = cands[r0:r0 + chunk]
            rows = torch.arange(r0, r0 + c.shape[0], device=dev)
            d2 = torch.sum((points[rows][:, None, :] - points[c]) ** 2,
                           dim=-1)
            d2 = torch.where(c == rows[:, None], inf, d2)
            sd2, pos = torch.sort(d2, dim=1, stable=True)
            ds.append(sd2[:, :k])
            ids.append(torch.gather(c, 1, pos[:, :k]))
        per_d2.append(torch.cat(ds))
        per_id.append(torch.cat(ids))
    # a neighbour found by several orderings counts once
    sid, pos = torch.sort(torch.cat(per_id, dim=1), dim=1, stable=True)
    sd2 = torch.gather(torch.cat(per_d2, dim=1), 1, pos)
    dup = torch.cat([torch.zeros((n, 1), dtype=torch.bool, device=dev),
                     sid[:, 1:] == sid[:, :-1]], dim=1)
    sd2 = torch.where(dup, inf, sd2)
    return torch.sort(sd2, dim=1).values[:, k - 1]


def kth_nn_dist2_np(points, k: int, window: int = 16,
                    chunk: int = 1 << 20) -> np.ndarray:
    """Numpy twin of ``kth_nn_dist2`` for host pipelines (the partitioner's
    outlier filter): the same candidates, with the distance pass in row
    chunks of ``chunk``."""
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    if n <= k:
        return np.full((n,), np.inf, np.float32)

    def codes(perm):
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        scale = 1023.0 / max((hi - lo).max(), 1e-12)  # isotropic
        q = np.clip((pts - lo) * scale, 0, 1023).astype(np.uint32)

        def expand(v):
            v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
            v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
            v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
            v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
            return v

        a, b, c = perm
        return (expand(q[:, a]) | (expand(q[:, b]) << np.uint32(1))
                | (expand(q[:, c]) << np.uint32(2)))

    offs = np.concatenate(
        [np.arange(-window, 0), np.arange(1, window + 1)])[None, :]
    pos = np.arange(n)[:, None]
    cands_parts = []
    for perm in _PERMS:
        order = np.argsort(codes(perm), kind="stable")
        neigh = order[np.clip(pos + offs, 0, n - 1)]
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        cands_parts.append(neigh[inv])
    cands = np.concatenate(cands_parts, axis=1)

    cands.sort(axis=1)  # per row: duplicates become adjacent
    out = np.empty((n,), np.float32)
    for r0 in range(0, n, chunk):
        r1 = min(r0 + chunk, n)
        c = cands[r0:r1]
        d2 = ((pts[r0:r1, None, :] - pts[c]) ** 2).sum(-1)
        invalid = c == np.arange(r0, r1)[:, None]          # self
        invalid[:, 1:] |= c[:, 1:] == c[:, :-1]            # duplicates
        d2[invalid] = np.inf
        out[r0:r1] = np.partition(d2, k - 1, axis=1)[:, k - 1]
    return out
