"""Training losses: L1 and windowed SSIM (counterpart of
``pcp_tpu/utils/loss.py``; loss_utils.py:17-63 of the reference).

The SSIM blur is the JAX package's 11-tap zero-padded shift-and-add in fp32
(loss.py:46-75), not a convolution: sigma = blur(x^2) - mu^2 cancels ~1e-3
signals, and a TF32 convolution (cuDNN's default on the card) would round
them away. Gradients come from autograd through these ops.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred, target, valid_mask=None):
    """Mean |pred - target|; with ``valid_mask`` (H, W) the mean runs over
    valid pixels only (pad-and-mask mixed-resolution support)."""
    if valid_mask is None:
        return torch.abs(pred - target).mean()
    m = valid_mask.to(pred.dtype)[..., None]
    n = torch.clamp_min(m.sum() * pred.shape[-1], 1.0)
    return torch.sum(torch.abs(pred - target) * m) / n


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> Tuple[float, ...]:
    """The normalised window as fp32 values (held as Python floats, which
    multiply an fp32 tensor exactly as the fp32 constants do)."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _blur_1d(img, dim: int, window_size: int, sigma: float):
    """Zero-padded 'same' Gaussian blur along ``dim`` of a (C, H, W) image
    as a window_size-tap shift-and-add, fp32 throughout."""
    g = _gaussian_window(window_size, sigma)
    half = window_size // 2
    pad = [0, 0, 0, 0]
    pad[2 * (2 - dim)] = pad[2 * (2 - dim) + 1] = half
    x = F.pad(img, pad)
    n = img.shape[dim]
    out = None
    for k in range(window_size):
        term = g[k] * x.narrow(dim, k, n)
        out = term if out is None else out + term
    return out


def _depthwise_blur(img, window_size: int, sigma: float):
    """Separable Gaussian filter of a (C, H, W) image, rows then columns."""
    return _blur_1d(_blur_1d(img, 1, window_size, sigma), 2, window_size,
                    sigma)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5,
         valid_mask=None):
    """Mean SSIM over a (C, H, W) image pair in [0, 1]; C1 = 0.01^2,
    C2 = 0.03^2 (loss_utils.py:55-63). With ``valid_mask`` (H, W) the
    inputs are zeroed outside it and the map is averaged over it only."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    if valid_mask is not None:
        m = valid_mask.to(torch.float32)[None]
        img1 = img1 * m
        img2 = img2 * m
    mu1 = _depthwise_blur(img1, window_size, sigma)
    mu2 = _depthwise_blur(img2, window_size, sigma)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size, sigma) - mu1_mu2
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    if valid_mask is not None:
        m = valid_mask.to(torch.float32)[None]
        n = torch.clamp_min(m.sum() * ssim_map.shape[0], 1.0)
        return torch.sum(ssim_map * m) / n
    return ssim_map.mean()
