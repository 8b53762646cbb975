"""The benchmark's inputs, made on the device from ``--seed``.

Everything the port and the reference receive comes from here: the
Gaussians of a trained block or of a merged scene, the camera rig, the
ground-truth images, the appearance network's weights and the densify
noise. The recipes follow the upstream's documented settings as the
configuration files state them (the aerial slab, the ring of cameras over
the detail block, the resolutions); the quantities the upstream leaves
open are listed under ``assumed`` in each configuration file.

Each quantity has a stream of its own (``stream``), so a seed gives the same
numbers whichever of them a caller asks for, and in any order. Every seed
gives the same counts and sizes: the seed changes where the Gaussians lie,
their colours, the images and the camera order, not how much work there is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814
DEAD_FILL = -10.0        # log-scale and opacity logit of an empty slot
EMBED_DIM = 64
NUM_EMBEDDINGS = 2048
# (in, out) channels of the appearance network's convolutions, in order
APP_CONVS = ((3 + EMBED_DIM, 256), (64, 128), (32, 64), (16, 32), (8, 16),
             (16, 16), (16, 3))


def stream(seed: int, name: str, device) -> torch.Generator:
    """A generator on ``device`` for one named quantity of one seed."""
    h = 1469598103934665603
    for b in f"{int(seed)}/{name}".encode():
        h = ((h ^ b) * 1099511628211) % (1 << 64)
    return torch.Generator(device=device).manual_seed(h % (1 << 63))


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _normal(g, shape, device):
    return torch.randn(shape, generator=g, device=device)


def spectral_colors(xyz: torch.Tensor, g: torch.Generator,
                    n_freq: int = 48) -> torch.Tensor:
    """Natural-image-like colours: a pink-spectrum mixture of random 3D
    sinusoids of ``xyz``, wavelengths log-spaced from 24 units down to 0.1
    (the quality tools' recipe), in [0.02, 0.98]."""
    dev = xyz.device
    wl = torch.tensor(np.geomspace(24.0, 0.10, n_freq), dtype=torch.float32,
                      device=dev)
    d = _normal(g, (n_freq, 3), dev)
    freqs = (2 * math.pi / wl)[:, None] * d / d.norm(dim=1, keepdim=True)
    phases = _uniform(g, (n_freq,), 0.0, 2 * math.pi, dev)
    mix = _normal(g, (n_freq, 3), dev) * (wl ** 0.45)[:, None]
    acc = torch.zeros((xyz.shape[0], 3), dtype=torch.float32, device=dev)
    for k in range(n_freq):
        acc += torch.sin(xyz @ freqs[k] + phases[k])[:, None] * mix[k]
    acc /= 2.5 * acc.std()
    return torch.clamp(0.5 + acc, 0.02, 0.98)


def gaussians(cfg: Dict, seed: int, device) -> Tuple[Dict, torch.Tensor]:
    """(params, alive) of ``cfg["live"]`` Gaussians in ``cfg["capacity"]``
    slots, pre-activation, in the reference PLY schema: a share
    ``fine_share`` of fine splats in the detail disc, the rest coarse over
    ``area`` ([x0, y0, x1, y1]), log-normal world sizes, mild anisotropy,
    random rotations, opacities uniform in ``opacity`` and colours from
    ``spectral_colors``; SH rest terms small. Empty slots are zero with
    log-scale and opacity logit -10, as the port keeps them."""
    dev = torch.device(device)
    n, cap = int(cfg["live"]), int(cfg["capacity"])
    sh_rest = (int(cfg["sh_degree"]) + 1) ** 2 - 1
    g = stream(seed, "gaussians", dev)
    n_fine = int(round(n * float(cfg["fine_share"])))
    cx, cy = cfg["detail_center"]
    th = _uniform(g, (n_fine,), 0.0, 2 * math.pi, dev)
    rr = float(cfg["detail_radius"]) * torch.sqrt(
        torch.rand((n_fine,), generator=g, device=dev))
    x0, y0, x1, y1 = cfg["area"]
    zf, zc = cfg["z_fine"], cfg["z_coarse"]
    xyz = torch.cat([
        torch.stack([cx + rr * torch.cos(th), cy + rr * torch.sin(th),
                     _uniform(g, (n_fine,), zf[0], zf[1], dev)], 1),
        torch.stack([_uniform(g, (n - n_fine,), x0, x1, dev),
                     _uniform(g, (n - n_fine,), y0, y1, dev),
                     _uniform(g, (n - n_fine,), zc[0], zc[1], dev)], 1)])
    med = torch.cat([
        torch.full((n_fine, 1), math.log(cfg["fine_sigma"]), device=dev),
        torch.full((n - n_fine, 1), math.log(cfg["coarse_sigma"]),
                   device=dev)])
    log_s = (med + float(cfg["sigma_logstd"]) * _normal(g, (n, 1), dev)
             + _uniform(g, (n, 3), -0.3, 0.3, dev))
    op = _uniform(g, (n,), cfg["opacity"][0], cfg["opacity"][1], dev)
    rgb = spectral_colors(xyz, stream(seed, "colors", dev))

    def slots(a, fill=0.0):
        out = torch.full((cap,) + tuple(a.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n] = a
        return out

    rot = _normal(g, (n, 4), dev)
    params = {
        "xyz": slots(xyz),
        "f_dc": slots((rgb - 0.5) / SH_C0),
        "f_rest": slots(float(cfg["sh_rest_std"])
                        * _normal(g, (n, sh_rest, 3), dev)),
        "scaling": slots(log_s, DEAD_FILL),
        "rotation": slots(rot / rot.norm(dim=1, keepdim=True)),
        "opacity": slots(torch.log(op / (1.0 - op))[:, None], DEAD_FILL),
    }
    alive = torch.arange(cap, device=dev) < n
    return params, alive


@dataclass
class View:
    """One camera: world-to-camera (4, 4), pinhole intrinsics, size."""

    uid: int
    viewmat: np.ndarray
    fx: float
    fy: float
    width: int
    height: int


def look_at(pos, target) -> np.ndarray:
    """World-to-camera (4, 4) of a camera at ``pos`` looking at
    ``target``: x right, y down, z forward (the COLMAP convention)."""
    pos, target = np.asarray(pos, np.float64), np.asarray(target, np.float64)
    fwd = target - pos
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rot = np.stack([right, down, fwd])
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = -rot @ pos
    return m.astype(np.float32)


def ring_rig(rig: Dict, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` (position, target) pairs on four rings over the detail block,
    as the quality tools place them."""
    cx, cy = rig["detail_center"]
    out = []
    per_ring = max(n // 4, 1)
    for i in range(n):
        ring = i % 4
        r = 4.0 + 3.5 * ring
        ang = 2 * math.pi * (i // 4) / per_ring + 0.35 * ring
        pos = (cx + r * math.cos(ang), cy + r * math.sin(ang),
               16.0 + 2.5 * ring)
        tgt = (cx + 0.35 * r * math.cos(ang + 2.2),
               cy + 0.35 * r * math.sin(ang + 2.2), 0.8)
        out.append((np.array(pos), np.array(tgt)))
    return out


def grid_rig(rig: Dict, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` (position, target) pairs over the whole slab, looking down and
    a little aside; the jitter is fixed, not drawn from the seed."""
    if n == 0:
        return []
    slab = float(rig["slab"])
    side = int(math.ceil(math.sqrt(n)))
    out = []
    for k in range(n):
        gx, gy = k % side, k // side
        j = np.sin(np.array([1.3, 2.1, 3.7, 4.3, 5.9]) * (k + 1))
        pos = np.array([-slab + 2 * slab * (gx + 0.5) / side + 2 * j[0],
                        -slab + 2 * slab * (gy + 0.5) / side + 2 * j[1],
                        20.0 + 2 * j[2]])
        tgt = pos + np.array([6 * j[3], 6 * j[4], -pos[2] + 0.5])
        out.append((pos, tgt))
    return out


def views(cfg: Dict, rig: Dict) -> List[View]:
    """The rig's views at the configuration's resolution: ``ring_cameras``
    over the detail block and ``grid_cameras`` over the slab."""
    w, h, fx = int(cfg["width"]), int(cfg["height"]), float(cfg["fx"])
    poses = ring_rig(rig, int(rig["ring_cameras"])) + grid_rig(
        rig, int(rig.get("grid_cameras", 0)))
    return [View(i, look_at(p, t), fx, fx, w, h)
            for i, (p, t) in enumerate(poses)]


def split_views(all_views: List[View], hold: int):
    """(train, test): every ``hold``-th view is held out (llffhold)."""
    test = [v for v in all_views if v.uid % hold == 0]
    train = [v for v in all_views if v.uid % hold != 0]
    return train, test


def extent(vs: List[View]) -> float:
    """The scene extent the learning rates scale with: 1.1 x the largest
    distance of a camera centre from their mean (getNerfppNorm)."""
    centers = np.stack([-v.viewmat[:3, :3].T @ v.viewmat[:3, 3] for v in vs])
    return float(1.1 * np.linalg.norm(centers - centers.mean(0),
                                      axis=1).max())


def gt_image(seed: int, uid: int, width: int, height: int, device,
             n_freq: int = 48) -> torch.Tensor:
    """(H, W, 3) uint8 ground truth of view ``uid``: a pink-spectrum
    field of 2D sinusoids, wavelengths from the frame's width down to 4
    pixels, so it has structure at every scale as a photograph does."""
    dev = torch.device(device)
    g = stream(seed, f"gt/{uid}", dev)
    wl = torch.tensor(np.geomspace(float(width), 4.0, n_freq),
                      dtype=torch.float32, device=dev)
    ang = _uniform(g, (n_freq,), 0.0, 2 * math.pi, dev)
    phases = _uniform(g, (n_freq,), 0.0, 2 * math.pi, dev)
    mix = _normal(g, (n_freq, 3), dev) * (wl ** 0.45)[:, None]
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    acc = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    for k in range(n_freq):
        f = 2 * math.pi / wl[k]
        s = torch.sin(f * (torch.cos(ang[k]) * xs + torch.sin(ang[k]) * ys)
                      + phases[k])
        acc += s[..., None] * mix[k]
    acc /= 2.5 * acc.std()
    return torch.round(torch.clamp(0.5 + acc, 0.0, 1.0) * 255.0).to(
        torch.uint8)


def appearance_weights(seed: int, device) -> Dict[str, object]:
    """The appearance state: (2048, 64) embeddings and each convolution's
    (weight OIHW 3x3, bias), as a partly trained network holds them:
    lecun-normal weights (truncated at 2 sigma), small biases."""
    dev = torch.device(device)
    g = stream(seed, "appearance", dev)
    convs = []
    for cin, cout in APP_CONVS:
        std = math.sqrt(1.0 / (cin * 9))
        w = torch.clamp(_normal(g, (cout, cin, 3, 3), dev), -2.0, 2.0) * std
        convs.append((w, 0.01 * _normal(g, (cout,), dev)))
    emb = 0.01 * _normal(g, (NUM_EMBEDDINGS, EMBED_DIM), dev)
    return {"embeddings": emb, "convs": convs}


def split_noise(seed: int, iteration: int, capacity: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two (C, 3) standard normals: the offsets of a split's two children
    at the densify call of ``iteration``."""
    g = stream(seed, f"split/{iteration}", torch.device(device))
    return (_normal(g, (capacity, 3), device),
            _normal(g, (capacity, 3), device))


def camera_order(seed: int, n: int, length: int) -> List[int]:
    """``length`` view indices: the loop's epochs, each a shuffle of all
    ``n`` views, so every seed visits the same views as often."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    out: List[int] = []
    while len(out) < length:
        out.extend(int(i) for i in rng.permutation(n))
    return out[:length]
