"""Seeded synthetic inputs of the tile blend (``ops/composite.py``): one
attribute row per pair in a shuffled order, the pair list that reaches
them, and consecutive tile ranges, as ``ops/binning.py`` lays them out.
The card tests and ``chip_smoke.py`` hold the blend kernels against their
plain versions on them.

``real_block_counts`` draws tile loads shaped like a real block's: median
960, p99 2100 and largest 2640 pairs a tile (the reference block's load
histogram, PERF_NOTES.md "Real blocks need N levels").
"""

from __future__ import annotations

import numpy as np
import torch

REAL_BLOCK_LOADS = (960, 2100, 2640)     # p50, p99, max pairs a tile
_Z99 = 2.3263478740408408                # the standard normal's p99


def real_block_counts(rng: np.random.Generator, nt: int) -> np.ndarray:
    """(nt,) tile loads, lognormal through the real block's p50 and p99,
    clipped to its largest load, which the last tile takes."""
    p50, p99, top = REAL_BLOCK_LOADS
    sigma = np.log(p99 / p50) / _Z99
    counts = np.minimum(np.rint(p50 * np.exp(
        sigma * rng.standard_normal(nt))), top).astype(np.int64)
    counts[-1] = top
    return counts


def blend_inputs(rng: np.random.Generator, tiles_x: int, counts,
                 device, opacity=(0.0, 0.9), sigma=(1.5, 8.0),
                 dead: float = 0.0):
    """(pack, gids, tile_start, tile_count, tiles_x) for tiles of
    ``counts`` pairs: each pair's Gaussian has its mean within 6 px of its
    tile, a random 2D covariance with sigmas in ``sigma`` px, colours in
    [0, 1] and opacity uniform in ``opacity``; a share ``dead`` of the rows
    get opacity 0."""
    counts = np.asarray(counts, dtype=np.int64)
    nt = counts.shape[0]
    n_pairs = int(counts.sum())
    tile = np.repeat(np.arange(nt), counts)
    x0 = (tile % tiles_x) * 16.0
    y0 = (tile // tiles_x) * 16.0
    sig = rng.uniform(*sigma, (2, n_pairs))
    th = rng.uniform(0, np.pi, n_pairs)
    c, s = np.cos(th), np.sin(th)
    cxx = (c * sig[0]) ** 2 + (s * sig[1]) ** 2
    cyy = (s * sig[0]) ** 2 + (c * sig[1]) ** 2
    cxy = c * s * (sig[0] ** 2 - sig[1] ** 2)
    det = cxx * cyy - cxy * cxy
    rows = np.stack([
        x0 + rng.uniform(-6, 22, n_pairs), y0 + rng.uniform(-6, 22, n_pairs),
        cyy / det, -cxy / det, cxx / det, *rng.uniform(0, 1, (3, n_pairs)),
        rng.uniform(*opacity, n_pairs),
    ], -1).astype(np.float32)
    if dead:
        rows[rng.uniform(size=n_pairs) < dead, 8] = 0.0
    perm = rng.permutation(n_pairs)
    pack = np.empty_like(rows)
    pack[perm] = rows
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])

    def as_t(a, dt):
        return torch.tensor(a, dtype=dt, device=device)

    return (as_t(pack, torch.float32), as_t(perm, torch.int32),
            as_t(start, torch.int32), as_t(counts, torch.int32), tiles_x)
