"""View rendering for evaluation (counterpart of
``pcp_tpu/eval/render_batch.py`` ``render_views`` and ``eval_views``;
render.py:27-38 of the reference). Views render one at a time: each launch
already fills the card, and exact binning sizes every view's pair list on
its own."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.scene.cameras import Camera, camera_tensors
from pcp_tpu_torch.train.step import render_gaussians
from pcp_tpu_torch.utils.image import psnr


def render_view(
    params,
    alive,
    cam: Camera,
    sh_degree: int,
    background,
    *,
    max_per_tile: int = 1024,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """One view -> ((H, W, 3) float32 image clipped to [0, 1], binning
    stats n_pairs / max_tile_load / n_dropped)."""
    dev = resolve_device(device)
    viewmat, intrin = camera_tensors(cam, dev)
    img, aux = render_gaussians(
        params, alive, viewmat, intrin, (cam.width, cam.height), background,
        sh_degree, max_per_tile=max_per_tile, device=dev)
    stats = {
        "n_pairs": int(aux["n_pairs"]),
        "max_tile_load": int(aux["max_tile_load"]),
        "n_dropped": int(aux["n_dropped"]),
    }
    return torch.clamp(img, 0.0, 1.0).cpu().numpy(), stats


def render_views(
    params,
    alive,
    cams: Sequence[Camera],
    sh_degree: int,
    background,
    *,
    max_per_tile: int = 1024,
    device: DeviceLike = None,
) -> List[np.ndarray]:
    """Render all cameras; returns a list of (H, W, 3) float32 images."""
    dev = resolve_device(device)
    return [
        render_view(params, alive, cam, sh_degree, background,
                    max_per_tile=max_per_tile, device=dev)[0]
        for cam in cams
    ]


def eval_views(
    params,
    alive,
    cams: Sequence[Camera],
    sh_degree: int,
    background,
    *,
    max_per_tile: int = 1024,
    device: DeviceLike = None,
) -> Tuple[List[float], List[float]]:
    """Per-view L1 and PSNR of the clipped renders against each camera's
    ``gt_image`` (training_report, train.py:188-243). Each view reduces to
    two scalars on the device; they come back together at the end."""
    dev = resolve_device(device)
    if not cams:
        return [], []
    l1s, psnrs = [], []
    with torch.no_grad():
        for cam in cams:
            viewmat, intrin = camera_tensors(cam, dev)
            img, _ = render_gaussians(
                params, alive, viewmat, intrin, (cam.width, cam.height),
                background, sh_degree, max_per_tile=max_per_tile, device=dev)
            img = torch.clamp(img, 0.0, 1.0)[None]
            gt = torch.as_tensor(cam.gt_image, device=dev)[None]
            l1s.append(torch.abs(img - gt).mean())
            psnrs.append(psnr(img, gt)[0])
    return torch.stack(l1s).tolist(), torch.stack(psnrs).tolist()
