"""Image metrics: PSNR, MSE and the multinerf color correction (counterpart
of ``pcp_tpu/utils/image.py``; image_utils.py:20-69 of the reference)."""

from __future__ import annotations

import torch

from pcp_tpu_torch.device import resolve_device


def mse(img1, img2):
    """Per-image mean squared error over all but the leading axis."""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1)


def psnr(img1, img2):
    """PSNR in dB for images in [0, 1]; the leading axis is the batch."""
    m = mse(img1, img2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(m, 1e-12)))


def _quadratic_basis(img_mat):
    """Quadratic color expansion: for each channel c, products
    img[c] * img[c:], then the linear channels, then a bias column
    (the column order of image_utils.py:43-48)."""
    num_channels = img_mat.shape[-1]
    cols = [img_mat[:, c:c + 1] * img_mat[:, c:] for c in range(num_channels)]
    cols += [img_mat, torch.ones_like(img_mat[:, :1])]
    return torch.cat(cols, dim=-1)


def color_correct(img, ref, num_iters: int = 5, eps: float = 0.5 / 255):
    """Warp ``img`` (..., C) to match the colors of ``ref`` (multinerf).

    Each of ``num_iters`` rounds solves, per channel, a least-squares fit of
    ref's channel from a quadratic expansion of img's colors over the pixels
    that are unsaturated (within ``eps`` of neither 0 nor 1) in img, in the
    current warp and in ref, and re-applies the warp clipped to [0, 1]. The
    fit is the Tikhonov-regularised (1e-6 I) normal equations in fp32, solved
    with ``torch.linalg.solve``. The products A^T A square pixel sums over
    the whole image, so they must stay fp32: on the card TF32 is switched
    off first (``resolve_device``), as the JAX package pins
    ``precision="highest"``."""
    if img.shape[-1] != ref.shape[-1]:
        raise ValueError("img and ref channel counts must match")
    resolve_device(img.device)
    num_channels = img.shape[-1]
    img_mat = img.reshape(-1, num_channels).to(torch.float32)
    ref_mat = ref.reshape(-1, num_channels).to(torch.float32)

    def is_unclipped(z):
        return (z >= eps) & (z <= 1.0 - eps)

    mask0 = is_unclipped(img_mat)
    ref_ok = is_unclipped(ref_mat)
    for _ in range(num_iters):
        a_mat = _quadratic_basis(img_mat)
        reg = 1e-6 * torch.eye(a_mat.shape[-1], dtype=torch.float32,
                               device=a_mat.device)
        warps = []
        for c in range(num_channels):
            mask = mask0[:, c] & is_unclipped(img_mat[:, c]) & ref_ok[:, c]
            ma = torch.where(mask[:, None], a_mat, 0.0)
            mb = torch.where(mask, ref_mat[:, c], 0.0)
            warps.append(torch.linalg.solve(ma.T @ ma + reg, ma.T @ mb))
        img_mat = torch.clamp(a_mat @ torch.stack(warps, dim=-1), 0.0, 1.0)
    return img_mat.reshape(img.shape)
