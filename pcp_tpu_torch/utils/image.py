"""Image metrics the training loop reads (counterpart of
``pcp_tpu/utils/image.py`` mse/psnr; image_utils.py:20-22)."""

from __future__ import annotations

import torch


def mse(img1, img2):
    """Per-image mean squared error over all but the leading axis."""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1)


def psnr(img1, img2):
    """PSNR in dB for images in [0, 1]; the leading axis is the batch."""
    m = mse(img1, img2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(m, 1e-12)))
