"""Tile compositing: front-to-back blend of each 16x16 tile's depth-sorted
Gaussians and its back-to-front VJP (counterpart of
``pcp_tpu/ops/pallas_composite.py`` ``_fwd`` and ``_composite_bwd``).

``composite_fwd`` and ``composite_bwd`` launch the hand-written CUDA kernels
(``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``) for CUDA tensors and
run the plain PyTorch versions ``composite_fwd_plain`` and
``composite_bwd_plain`` for CPU tensors. There is no fallback from one to
the other: a CUDA tensor either reaches the kernel or raises.

Semantics (renderCUDA, forward.cu:261-374; pallas_composite.py:358-450):
pixel (px, py) = (x0 + lane % 16, y0 + lane // 16), integer coordinates;
power = -0.5 (a dx^2 + c dy^2) - b dx dy; a slot is skipped if power > 0
or alpha = min(0.99, op exp(power)) < 1/255; the slot whose T (1 - alpha)
would fall below 1e-4 is not applied and the pixel is done from then on;
``n_contrib`` = 1 + index of the last applied slot (0 if none).

Inputs: ``pack`` (N, 9) f32 rows [mx, my, conic a, b, c, r, g, b, opacity]
(the JAX package's nine attribute planes, one row per Gaussian);
``gids`` (n_pairs,) int32 sorted pair list; ``tile_start``/``tile_count``
(num_tiles,) int32 ranges into it. Outputs keep the JAX layout:
color (nt, 3, 256), t_fin (nt, 256) f32 and n_contrib (nt, 256) int32.
The backward returns one gradient row per pair, (n_pairs, 9) f32 in
pair-list order with the rows of ``pack``; pairs past a tile's
``tile_count`` get zero rows.

Both kernels take each sample's decision from ``csrc/blend_math.cuh``. A
row's log-domain threshold ``logf(1/255 / op) - SKIP_MARGIN`` (+inf for
op <= 0) lies below every power the exact test applies and sizes the box
of the pixels the row can apply; a warp passes over a row whose box misses
its pixels. ``skip_threshold`` and ``pixel_box`` mirror the rules for the
tests and ``chip_smoke.py``'s work counts; nothing on the blend's path
calls them.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops.projection import TILE

P = TILE * TILE
NA = 9
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4
DENOM_MIN = 1.0 - ALPHA_MAX   # the backward's clamp of 1 - alpha
SKIP_MARGIN = 1.0e-3          # blend_math.cuh kSkipMargin
MAX_COND = 1.0e4              # blend_math.cuh kMaxCond

# Kernel launches per kernel name; each wrapper adds one where it launches.
LAUNCHES: collections.Counter = collections.Counter()


def pack_attributes(prep) -> torch.Tensor:
    """(N, 9) f32 per-Gaussian rows [mx, my, a, b, c, r, g, b, opacity]."""
    m, c, rgb = prep["means2d"], prep["conics"], prep["rgb"]
    return torch.cat(
        [m, c, rgb, prep["opacity"][:, None]], dim=1
    ).to(torch.float32).contiguous()


def skip_threshold(op: torch.Tensor) -> torch.Tensor:
    """The kernels' per-row skip threshold in fp32: log(ALPHA_MIN / op) -
    SKIP_MARGIN, +inf where op <= 0 (blend_math.cuh ``prepare_row``)."""
    op = op.to(torch.float32)
    thr = torch.log(torch.tensor(ALPHA_MIN, dtype=torch.float32) / op) \
        - torch.tensor(SKIP_MARGIN, dtype=torch.float32)
    return torch.where(op <= 0.0, torch.full_like(thr, float("inf")), thr)


def pixel_box(pack: torch.Tensor) -> torch.Tensor:
    """(N, 4) [xlo, xhi, ylo, yhi] per row of ``pack``: the box that holds
    every pixel the row can apply, in fp32 as blend_math.cuh
    ``sample_box`` computes it (empty where thr > 0, the whole plane for a
    conic that is not positive definite or beyond MAX_COND)."""
    f = torch.float32
    mx, my, a, b, c = (pack[:, i].to(f) for i in range(5))
    thr = skip_threshold(pack[:, 8])
    det = a * c - b * b
    half = 0.5 * (a - c)
    lmax = 0.5 * (a + c) + torch.sqrt(half * half + b * b)
    ok = (a > 0) & (c > 0) & (det > 0) & (lmax * lmax <= MAX_COND * det)
    t2 = 2.0 * (0.01 - 1.01 * thr)
    rx = torch.sqrt(t2 * c / det) * 1.001 + 0.01
    ry = torch.sqrt(t2 * a / det) * 1.001 + 0.01
    box = torch.stack([mx - rx, mx + rx, my - ry, my + ry], dim=1)
    inf = float("inf")
    plane = torch.tensor([-inf, inf, -inf, inf], dtype=f, device=pack.device)
    box = torch.where(ok[:, None], box, plane)
    return torch.where((thr > 0)[:, None], -plane, box)


def pixel_coords(num_tiles, tiles_x, device):
    """(px, py) (num_tiles, 256) f32 integer pixel coordinates."""
    tile = torch.arange(num_tiles, device=device)[:, None]
    lane = torch.arange(P, device=device)[None, :]
    px = ((tile % tiles_x) * TILE + lane % TILE).to(torch.float32)
    py = ((tile // tiles_x) * TILE + lane // TILE).to(torch.float32)
    return px, py


def composite_fwd_plain(pack, gids, tile_start, tile_count, tiles_x):
    """The blend in tensor ops: one step per slot, all pixels of all tiles
    at once, in the kernel's arithmetic order."""
    device = pack.device
    nt = tile_start.shape[0]
    px, py = pixel_coords(nt, tiles_x, device)
    T = torch.ones((nt, P), dtype=torch.float32, device=device)
    color = torch.zeros((nt, 3, P), dtype=torch.float32, device=device)
    done = torch.zeros((nt, P), dtype=torch.bool, device=device)
    n_contrib = torch.zeros((nt, P), dtype=torch.int32, device=device)
    k_max = int(tile_count.max()) if nt > 0 else 0
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    for k in range(k_max):
        live = k < count                                     # (nt,)
        pos = torch.where(live, start + k, torch.zeros_like(start))
        g = gids[pos].to(torch.int64)
        att = pack[g]                                        # (nt, 9)
        dx = px - att[:, 0:1]
        dy = py - att[:, 1:2]
        a, b, c = att[:, 2:3], att[:, 3:4], att[:, 4:5]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(att[:, 8:9] * torch.exp(power), ALPHA_MAX)
        ok = (live[:, None] & ~done & ~(power > 0.0)
              & ~(alpha < ALPHA_MIN))
        test_t = T * (1.0 - alpha)
        stop = ok & (test_t < T_EPS)
        done = done | stop
        apply = ok & ~stop
        w = torch.where(apply, alpha * T, torch.zeros_like(T))
        color = color + att[:, 5:8, None] * w[:, None, :]
        T = torch.where(apply, test_t, T)
        n_contrib = torch.where(apply, torch.full_like(n_contrib, k + 1),
                                n_contrib)
    return color, T, n_contrib


def check_tensors(dev, named):
    """Each (name, tensor, dtype) lies on ``dev``, has the dtype and is
    contiguous."""
    for name, t, dt in named:
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(pack, gids, tile_start, tile_count, tiles_x):
    check_tensors(pack.device, (("pack", pack, torch.float32),
                                 ("gids", gids, torch.int32),
                                 ("tile_start", tile_start, torch.int32),
                                 ("tile_count", tile_count, torch.int32)))
    if pack.dim() != 2 or pack.shape[1] != NA:
        raise ValueError(f"pack must be (N, {NA}), got {tuple(pack.shape)}")
    if gids.dim() != 1:
        raise ValueError("gids must be 1-D")
    if tile_start.shape != tile_count.shape or tile_start.dim() != 1:
        raise ValueError("tile_start and tile_count must be equal 1-D")
    if tiles_x < 1 or tile_start.shape[0] % tiles_x:
        raise ValueError(f"{tile_start.shape[0]} tiles are not rows of "
                         f"{tiles_x}")


def composite_fwd(pack, gids, tile_start, tile_count, tiles_x: int):
    """(color (nt, 3, 256), t_fin (nt, 256), n_contrib (nt, 256) int32).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(pack, gids, tile_start, tile_count, tiles_x)
    if pack.device.type == "cpu":
        return composite_fwd_plain(pack, gids, tile_start, tile_count,
                                   tiles_x)
    if pack.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {pack.device}")
    fn = _build.load("composite_fwd").composite_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    nt = tile_start.shape[0]
    dev = pack.device
    color = torch.empty((nt, 3, P), dtype=torch.float32, device=dev)
    t_fin = torch.empty((nt, P), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((nt, P), dtype=torch.int32, device=dev)
    if nt == 0:
        return color, t_fin, n_contrib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pack.data_ptr(), gids.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), nt, int(tiles_x), color.data_ptr(),
                 t_fin.data_ptr(), n_contrib.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["composite_fwd"] += 1
    return color, t_fin, n_contrib


def composite_bwd_plain(pack, gids, tile_start, tile_count, tiles_x, t_fin,
                        n_contrib, gcolor, gtfin):
    """The VJP in tensor ops: one step per slot from the last toward the
    first, all pixels of all tiles at once, in the kernel's arithmetic order.
    T before a slot is rebuilt by division from ``t_fin``; the suffix S
    starts at t_fin * gtfin (pallas_composite.py:466-620)."""
    device = pack.device
    nt = tile_start.shape[0]
    px, py = pixel_coords(nt, tiles_x, device)
    out = torch.zeros((gids.shape[0], NA), dtype=torch.float32, device=device)
    T = t_fin.clone()
    S = t_fin * gtfin
    g0, g1, g2 = gcolor[:, 0], gcolor[:, 1], gcolor[:, 2]
    nc = n_contrib.to(torch.int64)
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    k_max = int(torch.minimum(nc.max(dim=1).values, count).max()) \
        if nt > 0 else 0
    for k in range(k_max - 1, -1, -1):
        live = k < count                                     # (nt,)
        pos = torch.where(live, start + k, torch.zeros_like(start))
        att = pack[gids[pos].to(torch.int64)]                # (nt, 9)
        dx = px - att[:, 0:1]
        dy = py - att[:, 1:2]
        a, b, c, op = att[:, 2:3], att[:, 3:4], att[:, 4:5], att[:, 8:9]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        ok = (live[:, None] & (k < nc) & ~(power > 0.0)
              & ~(alpha < ALPHA_MIN))
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
        one_m = 1.0 - alpha
        t_before = T / one_m
        w = alpha * t_before
        rgb_dot = att[:, 5:6] * g0 + att[:, 6:7] * g1 + att[:, 7:8] * g2
        dalpha = t_before * rgb_dot - S / torch.clamp_min(one_m, DENOM_MIN)
        S = S + w * rgb_dot
        T = t_before
        grad = ok & (alpha < ALPHA_MAX)
        zero = torch.zeros_like(alpha)
        dpower = torch.where(grad, dalpha * alpha, zero)
        dop = torch.where(
            grad, dalpha * (alpha / torch.clamp_min(op, ALPHA_MIN)), zero)
        planes = torch.stack([
            dpower * (a * dx + b * dy),
            dpower * (c * dy + b * dx),
            dpower * (-0.5 * dx * dx),
            dpower * (-dx * dy),
            dpower * (-0.5 * dy * dy),
            w * g0, w * g1, w * g2,
            dop,
        ], dim=1).sum(dim=2)                                 # (nt, 9)
        out[pos[live]] = planes[live]
    return out


def composite_bwd(pack, gids, tile_start, tile_count, tiles_x: int, t_fin,
                  n_contrib, gcolor, gtfin):
    """Per-pair gradient rows (n_pairs, 9) of the blend, given the forward's
    ``t_fin`` and ``n_contrib`` and the cotangents of color and t_fin.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(pack, gids, tile_start, tile_count, tiles_x)
    nt = tile_start.shape[0]
    check_tensors(pack.device, (("t_fin", t_fin, torch.float32),
                                 ("n_contrib", n_contrib, torch.int32),
                                 ("gcolor", gcolor, torch.float32),
                                 ("gtfin", gtfin, torch.float32)))
    for name, t, shape in (("t_fin", t_fin, (nt, P)),
                           ("n_contrib", n_contrib, (nt, P)),
                           ("gcolor", gcolor, (nt, 3, P)),
                           ("gtfin", gtfin, (nt, P))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if pack.device.type == "cpu":
        return composite_bwd_plain(pack, gids, tile_start, tile_count,
                                   tiles_x, t_fin, n_contrib, gcolor, gtfin)
    if pack.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {pack.device}")
    fn = _build.load("composite_bwd").composite_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    dev = pack.device
    out = torch.zeros((gids.shape[0], NA), dtype=torch.float32, device=dev)
    if nt == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pack.data_ptr(), gids.data_ptr(), tile_start.data_ptr(),
                 tile_count.data_ptr(), nt, int(tiles_x), t_fin.data_ptr(),
                 n_contrib.data_ptr(), gcolor.data_ptr(), gtfin.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["composite_bwd"] += 1
    return out
