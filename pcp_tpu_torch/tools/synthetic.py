"""Synthetic COLMAP scene factory (counterpart of ``tests/synthetic.py``).

Builds a scene whose ground-truth images are rendered from a known Gaussian
set with the port's rasterizer, so training on it must converge (a
self-realisable target). It is written as a real COLMAP dataset
(``images/`` + ``sparse/0/*.bin``), the layout the reference consumes
(README.md:106-112), so the loaders are exercised too.

The generator draws in the JAX factory's order, so a seed writes the same
``sparse/0/*.bin`` bytes; a GT PNG can differ by one level where the two
fp32 renders straddle a rounding boundary. GT renders on ``device`` (the
card unless ``"cpu"``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.io import colmap
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.ops.rasterize import rasterize
from pcp_tpu_torch.utils.graphics import rotmat_to_qvec
from pcp_tpu_torch.utils.sh import rgb_to_sh


def look_at_w2c(pos, target, up=(0.0, 0.0, 1.0)):
    """World->camera extrinsics (R, t) in float64, camera +z toward
    ``target``, +y down-ish (COLMAP convention)."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows: cam axes in world
    t = -R @ pos
    return R, t


def make_gaussian_cloud(rng, n=120, extent=1.5):
    xyz = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    rgb = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.08, 0.22, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.5, 0.95, size=n).astype(np.float32)
    return xyz, rgb, scales, quats, opac


def viewmat_of(R, t) -> np.ndarray:
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R
    vm[:3, 3] = t
    return vm


def render_true_scene(xyz, rgb, scales, quats, opac, R, t, fx, fy, W, H,
                      *, device: DeviceLike = None) -> np.ndarray:
    """(H, W, 3) float32 render in [0, 1] of the cloud at SH degree 0 on a
    black background."""
    dev = resolve_device(device)
    sh = rgb_to_sh(torch.as_tensor(rgb, device=dev))[:, None, :]

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    intrin = CameraIntrin(fx=f32(fx), fy=f32(fy), cx=f32(W / 2),
                          cy=f32(H / 2))
    with torch.no_grad():
        img, _ = rasterize(xyz, scales, quats, opac, sh, viewmat_of(R, t),
                           intrin, (W, H), torch.zeros(3), 0, device=dev)
    return np.clip(img.cpu().numpy(), 0.0, 1.0)


def write_synthetic_scene(
    out_dir: str,
    rng=None,
    n_points: int = 120,
    n_cams: int = 10,
    W: int = 64,
    H: int = 48,
    radius: float = 5.0,
    image_ext: str = "png",
    appearance_jitter: float = 0.0,
    appearance_field: float = 0.0,
    jitter_holdout: int = 0,
    jitter_atten_only: bool = False,
    rings=None,
    *,
    device: DeviceLike = None,
):
    """Create ``<out_dir>/{images/, sparse/0/*.bin}``; returns the true
    Gaussian tuple (xyz, rgb, scales, quats, opac).

    ``appearance_jitter`` > 0 applies a per-view exposure and white-balance
    gain to each saved GT image (log-uniform in +-jitter: one exposure
    scalar times three channel gains; with ``jitter_atten_only`` the same
    widths shifted so every gain is <= 1, the sigmoid transformation map's
    domain, appearance_network.py:59). ``appearance_field`` > 0 adds a
    per-view-strength vignette, a spatial pattern the eval's global colour
    fit cannot absorb. ``jitter_holdout`` > 0 keeps every holdout-th view
    (the llffhold test split) clean. ``rings`` ([(radius, count), ...])
    replaces the single ring of ``n_cams`` cameras."""
    from PIL import Image as PILImage

    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    xyz, rgb, scales, quats, opac = make_gaussian_cloud(rng, n_points)
    fx = fy = 0.9 * W

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    cams = {1: colmap.Camera(1, "PINHOLE", W, H,
                             np.array([fx, fy, W / 2, H / 2]))}
    imgs = {}
    ring_radii = [(radius, n_cams)] if rings is None else list(rings)
    cam_specs = [(r_ring, 2 * np.pi * k / cnt)
                 for r_ring, cnt in ring_radii for k in range(cnt)]

    for i, (r_i, ang) in enumerate(cam_specs):
        pos = np.array(
            [r_i * np.cos(ang), r_i * np.sin(ang),
             1.5 * (r_i / radius) + 0.5 * (r_i / radius) * np.sin(3 * ang)]
        )
        R, t = look_at_w2c(pos, (0.0, 0.0, 0.0))
        img = render_true_scene(xyz, rgb, scales, quats, opac, R, t, fx, fy,
                                W, H, device=dev)
        clean = jitter_holdout > 0 and i % jitter_holdout == 0
        if appearance_jitter > 0.0 and not clean:
            j = appearance_jitter
            if jitter_atten_only:
                exposure = np.exp(rng.uniform(-2 * j, 0.0))
                wb = np.exp(rng.uniform(-j, 0.0, size=3))
            else:
                exposure = np.exp(rng.uniform(-j, j))
                wb = np.exp(rng.uniform(-j / 2, j / 2, size=3))
            img = np.clip(img * (exposure * wb)[None, None, :], 0.0, 1.0)
        if appearance_field > 0.0 and not clean:
            s = appearance_field * rng.uniform(0.3, 1.0)
            yy = (np.linspace(-1, 1, H) * (H / W))[:, None]
            xx = np.linspace(-1, 1, W)[None, :]
            r2 = (xx * xx + yy * yy) / (1 + (H / W) ** 2)
            img = np.clip(img * (1.0 - s * r2)[:, :, None], 0.0, 1.0)
        name = f"im{i:03d}.{image_ext}"
        PILImage.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out_dir, "images", name))
        npts = min(20, n_points)
        imgs[i + 1] = colmap.Image(
            i + 1, rotmat_to_qvec(R), t, 1, name,
            xys=np.zeros((npts, 2)),
            point3D_ids=np.arange(npts, dtype=np.int64),
        )

    pts = colmap.Points3D.from_arrays(xyz, (rgb * 255).astype(np.uint8))
    colmap.write_model(cams, imgs, pts, os.path.join(out_dir, "sparse", "0"),
                       ext=".bin")
    return xyz, rgb, scales, quats, opac
