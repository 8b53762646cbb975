"""Exact, variable-length tile binning (counterpart of
``pcp_tpu/ops/binning.py``).

The CUDA rasterizer's pipeline (rasterizer_impl.cu:70-138), in torch ops:
per-Gaussian tile counts -> exclusive cumsum -> one [tile | depth] key per
Gaussian x tile pair (duplicateWithKeys) -> ``torch.sort`` -> per-tile
[start, end) ranges (identifyTileRanges). One device-to-host read of the
pair total sizes the pair buffers; nothing else syncs.

The key is the JAX package's packed key (binning.py:740-754), so both
packages order each tile's Gaussians identically up to equal-key ties:
``tile << depth_bits | (float_bits(depth) >> tile_bits)`` with
``tile_bits = ceil_log2(num_tiles + 1)`` and ``depth_bits = 32 -
tile_bits``. It is held in int64, which orders the uint32 key exactly.

``max_per_tile`` is the JAX package's nearest-K clamp: a tile composites
only its first ``max_per_tile`` (nearest) Gaussians, so both packages
render the same image when a tile overflows. No pair is ever dropped, so
``n_dropped`` is 0.

The bins keep the sort's permutation, the Gaussian-major pair gids and each
Gaussian's range of them, so the backward reduces per-pair gradient rows
(tile-major) per Gaussian with no second sort: the role of the JAX
package's ``pos_from_counts`` shortcut (rasterize.py:218-228). On the card
the segment sum reads the rows through the inverse of the sort's
permutation; the plain path first scatters the rows into Gaussian-major
order (``gaussian_major``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileBins(NamedTuple):
    gids: torch.Tensor         # (n_pairs,) int32 Gaussian ids, tile-major,
                               #   depth-sorted within each tile
    tile_start: torch.Tensor   # (num_tiles,) int32 first pair of each tile
    tile_count: torch.Tensor   # (num_tiles,) int32 min(load, max_per_tile)
    n_pairs: int               # total Gaussian x tile pairs
    max_tile_load: torch.Tensor  # () int32 largest pre-clamp tile load
    order: torch.Tensor        # (n_pairs,) int64: gids[i] = pair_gid[order[i]]
    pair_gid: torch.Tensor     # (n_pairs,) int32 Gaussian-major (sorted) gids
    offsets: torch.Tensor      # (N + 1,) int32: Gaussian g owns pair_gid
                               #   [offsets[g], offsets[g + 1])
    n_dropped: int = 0


def _ceil_log2(x: int) -> int:
    return max(1, (x - 1).bit_length())


def key_depth_bits(num_tiles: int, key_tiles=None) -> int:
    """The bits of each depth's fp32 pattern that the pair key keeps: the
    top 32 - ceil_log2(tiles + 1). Gaussians of a tile whose depths agree
    in them keep their index order (1600 tiles at 800x512 keep 21 bits,
    depths 2^-12 apart)."""
    return 32 - _ceil_log2(max(num_tiles, key_tiles or 0) + 1)


def pair_keys(rect, depths, tiles_x, tiles_y, key_tiles=None):
    """(keys (P,) int64, gid (P,) int64, offsets (N + 1,) int64, n_pairs)
    for every Gaussian x tile pair of the rects, in Gaussian-major order;
    Gaussian g's pairs are [offsets[g], offsets[g + 1]). ``key_tiles``
    (default: the grid's own tile count) sets the key's depth precision,
    so a band of a frame can sort its tiles exactly as the whole frame
    does."""
    device = rect.device
    n = rect.shape[0]
    num_tiles = tiles_x * tiles_y
    depth_bits = key_depth_bits(num_tiles, key_tiles)
    tile_bits = 32 - depth_bits
    if tile_bits > 16:
        raise ValueError(f"{num_tiles} tiles do not fit the packed key")

    rect = rect.to(torch.int64)
    x0, y0 = rect[:, 0], rect[:, 1]
    wx = rect[:, 2] - rect[:, 0]
    counts = wx * (rect[:, 3] - rect[:, 1])
    offsets = torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0))
    n_pairs = int(offsets[-1])                           # the one D2H read

    gid = torch.repeat_interleave(
        torch.arange(n, device=device), counts, output_size=n_pairs)
    local = torch.arange(n_pairs, device=device) - offsets[:-1][gid]
    w = wx[gid]
    tile = (y0[gid] + local // w) * tiles_x + x0[gid] + local % w
    bits = depths.to(torch.float32).contiguous().view(torch.int32)
    dq = (bits.to(torch.int64) & 0xFFFFFFFF) >> tile_bits
    keys = (tile << depth_bits) | dq[gid]
    return keys, gid, offsets, n_pairs


def bin_gaussians(
    rect: torch.Tensor,      # (N, 4) int32 tile bounds [x0, y0, x1, y1)
    depths: torch.Tensor,    # (N,) camera-space depths
    tiles_x: int,
    tiles_y: int,
    max_per_tile: int,
    key_tiles=None,
) -> TileBins:
    num_tiles = tiles_x * tiles_y
    depth_bits = key_depth_bits(num_tiles, key_tiles)
    keys, gid, offsets, n_pairs = pair_keys(rect, depths, tiles_x, tiles_y,
                                            key_tiles)
    s_key, order = torch.sort(keys, stable=True)
    gids = gid[order].to(torch.int32)
    s_tile = s_key >> depth_bits
    bounds = torch.searchsorted(
        s_tile, torch.arange(num_tiles + 1, device=rect.device))
    load = bounds[1:] - bounds[:-1]
    max_load = load.max() if num_tiles > 0 else load.new_zeros(())
    return TileBins(
        gids=gids,
        tile_start=bounds[:-1].to(torch.int32),
        tile_count=torch.clamp_max(load, max_per_tile).to(torch.int32),
        n_pairs=n_pairs,
        max_tile_load=max_load.to(torch.int32),
        order=order,
        pair_gid=gid.to(torch.int32),
        offsets=offsets.to(torch.int32),
    )


def gaussian_major(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per-pair rows in pair-list (tile-major) order -> the same rows in
    Gaussian-major order, by the sort's permutation ``order``
    (``TileBins.order``); their gids are ``TileBins.pair_gid``."""
    out = torch.empty_like(rows)
    out[order] = rows
    return out


def tile_table(bins: TileBins, k: int) -> torch.Tensor:
    """Dense (num_tiles, k) gid table with -1 pads: the JAX package's
    ``tile_gauss`` layout, for tests."""
    idx = torch.arange(k, device=bins.gids.device)
    live = idx[None, :] < bins.tile_count[:, None].to(torch.int64)
    pos = bins.tile_start[:, None].to(torch.int64) + idx[None, :]
    pos = torch.where(live, pos, torch.zeros_like(pos))
    if bins.gids.numel() == 0:
        return torch.full(live.shape, -1, dtype=torch.int32,
                          device=bins.gids.device)
    return torch.where(live, bins.gids[pos], torch.full_like(pos, -1)).to(
        torch.int32)
