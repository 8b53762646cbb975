"""Dense reference rasterizer (counterpart of ``pcp_tpu/ops/oracle.py``:
``rasterize_dense`` and ``rasterize_dense_jax``).

Replays the CUDA per-pixel compositing loop (forward.cu:261-374) over every
Gaussian: the port's ``preprocess``, then one global depth order, the
per-pixel tile-rect restriction and the exact skip and early-stop rules.
It shares nothing with the production path after ``preprocess``: no
binning, no tile tables, no kernel. So quality runs can score renders
against a GT that the blend kernel never touched.

``depth_bits`` below 32 orders the Gaussians as the production binning's
pair key does: by the top ``depth_bits`` bits of each depth's fp32
pattern, equal keys in index order (``ops.binning.key_depth_bits`` gives
a frame's). The default, 32, is the exact depth order of the JAX oracle.

Plain torch on the given device. The image is cut into bands of whole tile
rows; a band composites only the Gaussians whose tile rect meets its rows
(any other has alpha 0 at all of its pixels), in depth order, in chunks of
``CHUNK`` Gaussians x the band's pixels, and stops once every pixel of the
band has stopped. Inside a chunk the transmittance is a cumulative sum of
log(1 - alpha), as the JAX version computes it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, T_EPS
from pcp_tpu_torch.ops.projection import TILE, CameraIntrin, preprocess

# Gaussians a chunk composites at once, tile rows a band holds, and chunks
# composited between two checks of "every pixel of the band stopped"
CHUNK, BAND_ROWS, DONE_CHECK_EVERY = 512, 1, 8


def _composite_band(px, py, mean, conic, rgb, opac, rect):
    """(color (B, 3), trans (B,)) of the pixels (px, py) over the
    depth-ordered Gaussians (mean, conic, rgb, opac, rect)."""
    nb = px.shape[0]
    dev = px.device
    tx, ty = (px // TILE)[None, :], (py // TILE)[None, :]
    pxf, pyf = px.float()[None, :], py.float()[None, :]
    color = torch.zeros((nb, 3), dtype=torch.float32, device=dev)
    trans = torch.ones(nb, dtype=torch.float32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    chunk = CHUNK
    for k, s in enumerate(range(0, mean.shape[0], chunk)):
        if k and k % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        m, cn, rc = mean[s:s + chunk], conic[s:s + chunk], rect[s:s + chunk]
        dx = pxf - m[:, 0:1]                                   # (CH, B)
        dy = pyf - m[:, 1:2]
        a, b, c = cn[:, 0:1], cn[:, 1:2], cn[:, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp_max(opac[s:s + chunk, None] * torch.exp(power),
                                ALPHA_MAX)
        in_rect = ((rc[:, 0:1] <= tx) & (tx < rc[:, 2:3])
                   & (rc[:, 1:2] <= ty) & (ty < rc[:, 3:4]))
        alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN) | ~in_rect,
                            0.0, alpha)
        # the stop is sticky and comes before the offending contribution
        t_after = trans[None, :] * torch.exp(
            torch.cumsum(torch.log1p(-alpha), dim=0))
        done_k = done[None, :] | (torch.cumsum(t_after < T_EPS, dim=0) > 0)
        alpha = torch.where(done_k, 0.0, alpha)
        log1ma = torch.log1p(-alpha)
        cum = torch.cumsum(log1ma, dim=0)
        wgt = alpha * (trans[None, :] * torch.exp(cum - log1ma))
        color = color + wgt.T @ rgb[s:s + chunk]
        trans = trans * torch.exp(cum[-1])
        done = done_k[-1]
    return color, trans


def rasterize_dense(
    xyz, scales, quats, opacities, sh, viewmat, intrin: CameraIntrin,
    image_size, background, sh_degree: int, *, depth_bits: int = 32,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (image (H, W, 3), final_T (H, W)) as float32 numpy."""
    dev = resolve_device(device)

    def on(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev)

    w, h = int(image_size[0]), int(image_size[1])
    with torch.no_grad():
        prep = preprocess(
            on(xyz), on(scales), on(quats), on(opacities), on(sh),
            on(viewmat), CameraIntrin(*(on(v) for v in intrin)),
            (w, h), sh_degree)
        vis = prep["visible"]
        depths = prep["depths"]
        if depth_bits < 32:
            # visible depths are > 0, so their bit patterns order as they do
            bits = depths.contiguous().view(torch.int32).to(torch.int64)
            depths = (bits >> (32 - depth_bits)).to(torch.float64)
        order = torch.argsort(torch.where(vis, depths, torch.inf),
                              stable=True)
        order = order[:int(vis.sum())]           # the invisible sort last
        mean = prep["means2d"][order]
        conic = prep["conics"][order]
        rgb = prep["rgb"][order]
        opac = prep["opacity"][order]
        rect = prep["rect"][order].to(torch.int32)

        img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        t_fin = torch.ones((h, w), dtype=torch.float32, device=dev)
        xs = torch.arange(w, dtype=torch.int32, device=dev)
        band_h = BAND_ROWS * TILE
        for y0 in range(0, h, band_h):
            y1 = min(y0 + band_h, h)
            ty0, ty1 = y0 // TILE, (y1 + TILE - 1) // TILE
            meets = (rect[:, 1] < ty1) & (rect[:, 3] > ty0)
            ys = torch.arange(y0, y1, dtype=torch.int32, device=dev)
            py = ys[:, None].expand(-1, w).reshape(-1)
            px = xs[None, :].expand(y1 - y0, -1).reshape(-1)
            color, trans = _composite_band(
                px, py, mean[meets], conic[meets], rgb[meets], opac[meets],
                rect[meets])
            img[y0:y1] = color.reshape(y1 - y0, w, 3)
            t_fin[y0:y1] = trans.reshape(y1 - y0, w)
        img = img + t_fin[..., None] * on(background).reshape(1, 1, 3)
    return img.cpu().numpy(), t_fin.cpu().numpy()
