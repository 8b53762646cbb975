"""Differentiable rasterization: preprocess -> exact binning -> composite
(counterpart of ``pcp_tpu/ops/rasterize.py`` ``rasterize``, the render()
front-end of gaussian_renderer/__init__.py:18-100).

``image = color + T * background`` (forward.cu:365-373), cropped to the
image; the aux dict carries the JAX package's keys. Gradients reach the
Gaussians through autograd of preprocess and the ``Blend`` function: its
backward runs ``composite_bwd`` (per-pair rows, pair-list order) and sums
each Gaussian's rows with ``gathered_segment_sum``, which reads them in
Gaussian-major order through the inverse of the binning's sort -- the role
of the JAX package's gather VJP (``_gather_rows_segsum``,
rasterize.py:112-260). No atomics anywhere, so gradients are the same on
every run.

Each stage runs inside a ``torch.profiler.record_function`` range
(``preprocess``, ``binning``, ``composite_fwd``, ``composite_bwd``,
``segment_sum``), so a profiler run reads each stage's device time; the
ranges cost nothing measurable when no profiler is on.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.ops.binning import TileBins, bin_gaussians
from pcp_tpu_torch.ops.composite import (
    composite_bwd,
    composite_fwd,
    pack_attributes,
)
from pcp_tpu_torch.ops.projection import TILE, CameraIntrin, preprocess
from pcp_tpu_torch.ops.segsum import gathered_segment_sum


def pack_gradient(rows: torch.Tensor, bins: TileBins, n: int) -> torch.Tensor:
    """Per-pair gradient rows (pair-list order) -> (n, 9) per-Gaussian
    gradient of the attribute pack. The rows are read where they lie,
    through the inverse of the sort's permutation: no Gaussian-major copy
    is made."""
    return gathered_segment_sum(rows, bins.order, bins.offsets, n)


class Blend(torch.autograd.Function):
    """(pack (N, 9), bins, tiles_x) -> (color (nt, 3, 256), t_fin (nt, 256)),
    differentiable in ``pack``. Saves ``n_contrib`` for the backward."""

    @staticmethod
    def forward(ctx, pack, bins: TileBins, tiles_x: int):
        with record_function("composite_fwd"):
            color, t_fin, n_contrib = composite_fwd(
                pack, bins.gids, bins.tile_start, bins.tile_count, tiles_x)
        ctx.save_for_backward(pack, t_fin, n_contrib)
        ctx.bins = bins
        ctx.tiles_x = tiles_x
        return color, t_fin

    @staticmethod
    def backward(ctx, gcolor, gtfin):
        pack, t_fin, n_contrib = ctx.saved_tensors
        bins = ctx.bins
        with record_function("composite_bwd"):
            rows = composite_bwd(
                pack, bins.gids, bins.tile_start, bins.tile_count,
                ctx.tiles_x, t_fin, n_contrib, gcolor.contiguous(),
                gtfin.contiguous())
        with record_function("segment_sum"):
            dpack = pack_gradient(rows, bins, pack.shape[0])
        return dpack, None, None


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int, w: int, h: int):
    """(nt, ch, 256) tile-major pixels -> (h, w, ch) image."""
    ch = x.shape[1]
    x = x.reshape(tiles_y, tiles_x, ch, TILE, TILE)
    x = x.permute(0, 3, 1, 4, 2).reshape(tiles_y * TILE, tiles_x * TILE, ch)
    return x[:h, :w]


def rasterize(
    xyz,
    scales,
    quats,
    opacities,
    sh,
    viewmat,
    intrin: CameraIntrin,
    image_size,
    background,
    sh_degree: int,
    *,
    max_per_tile: int = 512,
    means2d_offset=None,
    tan_fov=None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, Dict]:
    """Returns (image (H, W, 3), aux) with aux keys radii, visible, final_t,
    n_pairs, tile_count, max_tile_load, n_dropped. Inputs are moved to
    ``device`` (the CUDA card unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)

    def on(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev)

    intrin = CameraIntrin(*(on(v) for v in intrin))
    with record_function("preprocess"):
        prep = preprocess(
            on(xyz), on(scales), on(quats), on(opacities), on(sh),
            on(viewmat), intrin, image_size, sh_degree, tan_fov=tan_fov,
            means2d_offset=None if means2d_offset is None
            else on(means2d_offset))
        pack = pack_attributes(prep)
    return blend_image(prep, pack, image_size, on(background), max_per_tile)


def blend_image(prep, pack, image_size, background, max_per_tile: int):
    """The rasterizer after preprocess: binning of ``prep``'s rects and
    depths, the blend of ``pack`` (differentiable), the untiled image over
    ``background`` (3,) and the aux dict of ``rasterize``."""
    w, h = int(image_size[0]), int(image_size[1])
    tiles_x = (w + TILE - 1) // TILE
    tiles_y = (h + TILE - 1) // TILE
    with record_function("binning"):
        bins = bin_gaussians(prep["rect"], prep["depths"], tiles_x, tiles_y,
                             max_per_tile)
    color, t_fin = Blend.apply(pack, bins, tiles_x)
    color_img = untile(color, tiles_x, tiles_y, w, h)
    t_img = untile(t_fin[:, None, :], tiles_x, tiles_y, w, h)[..., 0]
    image = color_img + t_img[..., None] * background.reshape(1, 1, 3)
    aux = {
        "radii": prep["radii"],
        "visible": prep["visible"],
        "final_t": t_img,
        "n_pairs": bins.n_pairs,
        "tile_count": bins.tile_count,
        "max_tile_load": bins.max_tile_load,
        "n_dropped": bins.n_dropped,
    }
    return image, aux
