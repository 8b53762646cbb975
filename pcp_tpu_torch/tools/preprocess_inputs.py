"""Seeded stored parameters of N Gaussian slots around one camera, the
inputs of the render path's preprocess (``ops/preprocess_fwd.py``), and the
rule by which the card tests and ``chip_smoke.py`` hold the kernel against
its plain version on them (``plain_near_integer``, ``kernel_gaps``).

Most slots lie in front of the camera and on screen. Every 16th slot from
index 1 on is one of the rows preprocess treats apart, in
``SPECIAL``'s order: a dead slot, a Gaussian behind the near plane (or on
the camera's plane, where the Jacobian is infinite), a needle (one scale
thousands of times the others, so the 2D covariance's determinant cancels
and rounds to either sign), an opacity below 1/255, and a Gaussian far off
screen.
"""

from __future__ import annotations

import math

import torch

from pcp_tpu_torch.ops import projection
from pcp_tpu_torch.ops.preprocess_fwd import preprocess_params_plain
from pcp_tpu_torch.ops.projection import CameraIntrin

SPECIAL = ("dead", "behind", "needle", "faint", "offscreen")


def view(width: int, height: int, device):
    """(viewmat (4, 4), intrin): a camera turned 0.3 rad about y and -0.2
    about x, translated, with fx = fy = 0.8 width at the image centre."""
    a, b = 0.3, -0.2
    ry = torch.tensor([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                       [-math.sin(a), 0, math.cos(a)]], dtype=torch.float64)
    rx = torch.tensor([[1, 0, 0], [0, math.cos(b), -math.sin(b)],
                       [0, math.sin(b), math.cos(b)]], dtype=torch.float64)
    vm = torch.eye(4, dtype=torch.float64)
    vm[:3, :3] = rx @ ry
    vm[:3, 3] = torch.tensor([0.2, -0.1, 0.5], dtype=torch.float64)
    f = 0.8 * width

    def s(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return (vm.to(torch.float32).to(device),
            CameraIntrin(s(f), s(f), s(width / 2.0), s(height / 2.0)))


def row_kind(n: int, device) -> torch.Tensor:
    """(n,) int64: 0 for an ordinary slot, 1 + SPECIAL's index for the
    special rows."""
    kind = torch.arange(n, device=device) % 16
    return torch.where(kind <= len(SPECIAL), kind, 0)


def preprocess_inputs(n: int, rest: int, viewmat, intrin: CameraIntrin,
                      width: int, height: int, seed: int, device):
    """(params, alive): ``G.PARAM_KEYS`` (f32, contiguous; ``f_rest`` (n,
    rest, 3)) and alive (n,) bool, drawn from ``seed`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                           dtype=f32)

    def nrm(std, *shape):
        return std * torch.randn(shape, generator=g, device=device,
                                 dtype=f32)

    fx = float(intrin.fx)
    z = u(2.0, 12.0, n)
    px = u(-0.55, 0.55, n) * width / fx * z       # ~1.1 frames across
    py = u(-0.55, 0.55, n) * height / fx * z
    log_s = u(math.log(0.01), math.log(0.3), n, 3)
    logit = nrm(2.0, n, 1)
    kind = row_kind(n, device)
    alive = kind != 1
    behind = kind == 2
    z = torch.where(behind, u(-2.0, 0.3, n), z)
    z = torch.where(behind & (torch.arange(n, device=device) % 64 == 2),
                    torch.zeros_like(z), z)
    needle = kind == 3
    long_axis = torch.full((n, 3), math.log(1e-4), device=device)
    long_axis[:, 0] = math.log(3000.0)
    log_s = torch.where(needle[:, None], long_axis, log_s)
    logit = torch.where((kind == 4)[:, None], u(-12.0, -5.6, n, 1), logit)
    off = kind == 5
    px = torch.where(off, u(8.0, 60.0, n) * torch.sign(u(-1, 1, n)) * z, px)
    cam = torch.stack([px, py, z], 1).to(torch.float64)
    R = viewmat[:3, :3].to(torch.float64)
    t = viewmat[:3, 3].to(torch.float64)
    xyz = ((cam - t) @ R).to(f32)                  # R^T (cam - t), per row
    params = {
        "xyz": xyz.contiguous(),
        "f_dc": nrm(0.5, n, 3),
        "f_rest": nrm(0.1, n, rest, 3),
        "scaling": log_s.contiguous(),
        "rotation": nrm(1.0, n, 4),
        "opacity": logit.contiguous(),
    }
    return params, alive


def plain_near_integer(near: float, *args, **kwargs):
    """``preprocess_params_plain(*args, **kwargs)``'s (prep, pack) and an
    (N,) bool mask of the rows where a float the plain version ceils (the
    radius) or truncates (a tile index) lies within ``near`` of an
    integer: the only rows where the kernel may round an integer output
    the other way."""
    cut = []
    tile_index, ceil = projection._tile_index, torch.ceil
    projection._tile_index = lambda x, m: cut.append(x) or tile_index(x, m)
    torch.ceil = lambda x: cut.append(x) or ceil(x)
    try:
        prep, pack = preprocess_params_plain(*args, **kwargs)
    finally:
        projection._tile_index, torch.ceil = tile_index, ceil
    mask = torch.zeros(pack.shape[0], dtype=torch.bool, device=pack.device)
    for x in cut:
        mask |= (x - torch.round(x)).abs() <= near
    return prep, pack, mask


def kernel_gaps(prep, pack, p_prep, p_pack, near):
    """The kernel's (prep, pack) against the plain version's, with
    ``near`` from ``plain_near_integer``: ``flips``, the rows whose rect,
    radius or visibility differ, ``far_flips``, those of them not near an
    integer, and ``pack`` and ``p_pack`` to compare on every row (on a row
    whose visibility flipped, the opacity that the cull zeroes is taken
    from the plain version)."""
    vflip = prep["visible"] != p_prep["visible"]
    flip = ((prep["rect"] != p_prep["rect"]).any(1)
            | (prep["radii"] != p_prep["radii"]) | vflip)
    pack = pack.clone()
    pack[vflip, 8] = p_pack[vflip, 8]
    return {"flips": int(flip.sum()), "far_flips": int((flip & ~near).sum()),
            "pack": pack, "p_pack": p_pack}
