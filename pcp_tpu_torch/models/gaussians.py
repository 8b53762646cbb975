"""Capacity-padded 3D Gaussian parameters (counterpart of
``pcp_tpu/models/gaussians.py``; GaussianModel, gaussian_model.py:26-435).

Parameters are stored pre-activation in the reference PLY schema, as a dict
of tensors with a fixed ``capacity`` of slots and an ``alive`` mask, so the
port keeps slot-for-slot parity with the JAX package:

  xyz (C, 3), f_dc (C, 3), f_rest (C, K-1, 3), scaling (C, 3) log-scales,
  rotation (C, 4) quaternions [w, x, y, z], opacity (C, 1) logits.

Densify, prune and opacity reset (gaussian_model.py:231-435) are masked
transforms at that fixed capacity: children fill dead slots, and the
returned ``written`` mask names the slots whose Adam moments must be zeroed.
Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.io import ply as ply_io
from pcp_tpu_torch.ops.knn import mean_sq_dist_3nn
from pcp_tpu_torch.utils.general import (
    inverse_sigmoid,
    normalize,
    quat_to_rotmat,
)
from pcp_tpu_torch.utils.sh import num_sh_bases, rgb_to_sh

Params = Dict[str, torch.Tensor]
PARAM_KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
DEAD_FILL = -10.0  # log-scale and opacity logit of dead slots


@dataclass(frozen=True)
class GaussianConfig:
    """Static model configuration: SH degree, slot capacity and the
    clone-vs-split scale boundary (arguments/__init__.py:103)."""

    sh_degree: int = 3
    capacity: int = 1 << 20
    percent_dense: float = 0.01

    @property
    def n_sh_rest(self) -> int:
        return num_sh_bases(self.sh_degree) - 1


def scaling_act(scaling: torch.Tensor) -> torch.Tensor:
    return torch.exp(scaling)


def opacity_act(opacity: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(opacity)


def rotation_act(rotation: torch.Tensor) -> torch.Tensor:
    return normalize(rotation, dim=-1)


def sh_coeffs(params: Params) -> torch.Tensor:
    """(C, K, 3) SH coefficients, dc ++ rest (get_features)."""
    return torch.cat([params["f_dc"][:, None, :], params["f_rest"]], dim=1)


def create_from_pcd(xyz: np.ndarray, rgb: np.ndarray, cfg: GaussianConfig,
                    device: DeviceLike = None) -> Tuple[Params, torch.Tensor]:
    """Gaussians from a coloured point cloud (create_from_pcd,
    gaussian_model.py:134-157): DC SH from RGB, isotropic log-scale =
    log sqrt(mean sq dist to the 3 NN), identity rotation, opacity logit
    of 0.1. Points past ``cfg.capacity`` are dropped; free slots are zero,
    with log-scale and opacity logit at -10, and dead."""
    dev = resolve_device(device)
    c = cfg.capacity
    n = min(len(xyz), c)
    xyz_t = torch.tensor(np.asarray(xyz, np.float32)[:n], device=dev)
    rgb = np.asarray(rgb, np.float32)[:n]
    if rgb.max() > 1.5:   # 0..255 input
        rgb = rgb / 255.0
    dist2 = mean_sq_dist_3nn(xyz_t)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].expand(n, 3)

    def pad(a, tail):
        out = torch.zeros((c,) + tail, dtype=torch.float32, device=dev)
        out[:n] = a
        return out

    logit = float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))
    rotation = torch.zeros((c, 4), dtype=torch.float32, device=dev)
    rotation[:, 0] = 1.0
    alive = torch.arange(c, device=dev) < n
    params = {
        "xyz": pad(xyz_t, (3,)),
        "f_dc": pad(rgb_to_sh(torch.tensor(rgb, device=dev)), (3,)),
        "f_rest": torch.zeros((c, cfg.n_sh_rest, 3), dtype=torch.float32,
                              device=dev),
        "scaling": pad(log_scale, (3,)),
        "rotation": rotation,
        "opacity": pad(torch.full((n, 1), logit, device=dev), (1,)),
    }
    params["scaling"][~alive] = DEAD_FILL
    params["opacity"][~alive] = DEAD_FILL
    return params, alive


def init_densify_stats(capacity: int, device: DeviceLike = None):
    """Screen-space gradient accumulators (gaussian_model.py:181-184)."""
    dev = resolve_device(device)
    return {k: torch.zeros(capacity, dtype=torch.float32, device=dev)
            for k in ("grad_accum", "denom", "max_radii2d")}


def bmask(mask: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """A (C,) mask shaped to broadcast against ``arr`` (first axis C)."""
    return mask.reshape(mask.shape + (1,) * (arr.dim() - 1))


def _compact_scatter(params: Params, alive, children: Params, child_valid):
    """The k-th valid child fills the k-th dead slot (fixed capacity);
    children that do not fit are dropped. Returns (params, alive, written)
    with ``written`` the slots that just received a Gaussian."""
    c = alive.shape[0]
    dead_slots = torch.argsort(alive.to(torch.int8), stable=True)
    n_free = c - alive.sum()
    rank = torch.cumsum(child_valid.to(torch.int64), 0) - 1
    ok = child_valid & (rank < n_free)
    target = dead_slots[torch.clamp(rank, 0, c - 1)][ok]
    out = {}
    for k, v in params.items():
        v = v.clone()
        v[target] = children[k][ok]
        out[k] = v
    written = torch.zeros(c, dtype=torch.bool, device=alive.device)
    written[target] = True
    return out, alive | written, written


def split_noise(generator: Optional[torch.Generator], capacity: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal (C, 3) offsets for the two children of a split,
    drawn on the host from ``generator`` (the same numbers on every
    device) and moved to ``device``."""
    return tuple(torch.randn((capacity, 3), generator=generator).to(device)
                 for _ in range(2))


def densify_and_prune(
    params: Params,
    alive: torch.Tensor,
    stats: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    percent_dense: float = 0.01,
    prune_big_screen: bool = False,
    max_screen_size: float = 20.0,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    counts: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """One densify+prune step (densify_and_prune, gaussian_model.py:417-429).

    clone: mean grad >= threshold and max scale <= percent_dense * extent,
    copied in place (:397-415); split: mean grad >= threshold and a larger
    scale, two children at sigma-scaled offsets with scale / 1.6, the
    original pruned (:377-395); prune: opacity < min_opacity, and with
    ``prune_big_screen`` screen radius > 20 px or size > 0.1 extent.
    ``noise`` (two (C, 3) standard normals) replaces the generator's draw,
    so a test can feed both packages the same numbers. Returns (params,
    alive, written): ``written`` marks slots whose moments must be zeroed.

    At a full block the children outnumber the free slots, and those past
    the last free slot are dropped (the capacity is the reference's
    population cap, train.py:146). A given ``counts`` dict receives, as
    0-d int64 tensors on the params' device (no host read): ``wanted``
    (clones plus two per split), ``placed``, ``dropped`` (wanted less
    placed), ``pruned`` (live Gaussians the opacity and size rules remove;
    split parents not counted) and ``free`` (free slots once the pruned
    and the split parents are gone).
    """
    grads = stats["grad_accum"] / torch.clamp_min(stats["denom"], 1.0)
    stds = scaling_act(params["scaling"])
    max_scale = stds.max(dim=-1).values
    hot = alive & (grads >= grad_threshold)
    clone = hot & (max_scale <= percent_dense * extent)
    split = hot & (max_scale > percent_dense * extent)

    prune = alive & (opacity_act(params["opacity"])[:, 0] < min_opacity)
    if prune_big_screen:
        prune = prune | (alive & (stats["max_radii2d"] > max_screen_size))
        prune = prune | (alive & (max_scale > 0.1 * extent))
    if counts is not None:
        counts["pruned"] = prune.sum()
    prune = prune | split
    alive = alive & ~prune

    if noise is None:
        noise = split_noise(generator, alive.shape[0], alive.device)
    rot = quat_to_rotmat(params["rotation"])

    def split_child(z):
        child = dict(params)
        child["xyz"] = params["xyz"] + torch.einsum("nij,nj->ni", rot,
                                                    z * stds)
        child["scaling"] = torch.log(stds / (0.8 * 2.0))
        return child

    child0_split = split_child(noise[0])
    child1_split = split_child(noise[1])
    children = {
        k: torch.cat([torch.where(bmask(split, v), v, params[k]),
                      child1_split[k]])
        for k, v in child0_split.items()
    }
    child_valid = torch.cat([clone | split, split])
    if counts is not None:
        counts["free"] = (~alive).sum()
    params, alive, written = _compact_scatter(params, alive, children,
                                              child_valid)
    if counts is not None:
        counts["wanted"] = child_valid.sum()
        counts["placed"] = written.sum()
        counts["dropped"] = counts["wanted"] - counts["placed"]
    dead = ~alive
    params["opacity"] = torch.where(dead[:, None], DEAD_FILL,
                                    params["opacity"])
    params["scaling"] = torch.where(dead[:, None], DEAD_FILL,
                                    params["scaling"])
    return params, alive, written | prune


def reset_opacity(params: Params, alive: torch.Tensor) -> Params:
    """Clamp live opacities to at most 0.01 (reset_opacity,
    gaussian_model.py:231-234); the caller zeroes the opacity moments."""
    new_op = torch.clamp_max(params["opacity"], math.log(0.01 / 0.99))
    out = dict(params)
    out["opacity"] = torch.where(bmask(alive, new_op), new_op,
                                 params["opacity"])
    return out


def params_from_numpy(
    params: Mapping[str, np.ndarray], alive, device: DeviceLike = None
) -> Tuple[Params, torch.Tensor]:
    """Pre-activation params (the JAX package's schema, as numpy arrays)
    and the alive mask -> fp32 tensors and a bool mask on ``device``."""
    dev = resolve_device(device)
    out = {k: torch.tensor(np.asarray(params[k], np.float32), device=dev)
           for k in PARAM_KEYS}
    return out, torch.tensor(np.asarray(alive, bool), device=dev)


def load_gaussians_ply(path: str, cfg: GaussianConfig,
                       device: DeviceLike = None) -> Tuple[Params, torch.Tensor]:
    """Read a reference-schema Gaussian PLY into capacity-padded params.
    Slots past the file's count are dead: zero, with log-scale and opacity
    logit at -10."""
    d = ply_io.load_gaussian_ply(path)
    n = min(len(d["xyz"]), cfg.capacity)
    c = cfg.capacity

    def pad(a):
        a = np.asarray(a, np.float32)[:n]
        out = np.zeros((c,) + a.shape[1:], np.float32)
        out[:n] = a
        return out

    params = {
        "xyz": pad(d["xyz"]),
        "f_dc": pad(d["f_dc"].reshape(-1, 3)),
        "f_rest": pad(d["f_rest"]),
        "scaling": pad(d["scaling"]),
        "rotation": pad(d["rotation"]),
        "opacity": pad(d["opacity"].reshape(-1, 1)),
    }
    alive = np.arange(c) < n
    params["scaling"][~alive] = DEAD_FILL
    params["opacity"][~alive] = DEAD_FILL
    return params_from_numpy(params, alive, device)


def save_gaussians_ply(path: str, params: Params, alive) -> None:
    """Write live Gaussians in the reference PLY schema."""
    m = torch.as_tensor(alive).cpu().numpy().astype(bool)

    def host(k):
        return params[k].detach().cpu().numpy()[m]

    ply_io.save_gaussian_ply(
        path, host("xyz"), host("f_dc"), host("f_rest"), host("opacity"),
        host("scaling"), host("rotation"),
    )
