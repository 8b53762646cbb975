"""Plain PyTorch rendering of 3D Gaussians: the function the port's render
computes, written out without kernels (renderCUDA, forward.cu:261-374, and
preprocessCUDA, forward.cu:118-256, of the upstream's rasterizer).

- ``project``: each Gaussian's screen mean, conic, colour from its SH,
  opacity and the rect of tiles it may touch. The rect is the box of the
  ellipse where alpha can reach 1/255, at most 3 sigma, plus half a pixel,
  as the port draws it; visibility as the upstream culls.
- ``Lists``: the (tile, Gaussian) pairs of the rects, each tile's
  Gaussians in depth order. The order key keeps the top bits of each
  depth's fp32 pattern that fit beside the tile number, and equal keys
  keep index order; that is the rasterizer's radix-sort key.
- ``render``: each pixel composites its tile's list front to back: a
  sample is skipped where power > 0 or alpha = min(0.99, o exp(power)) <
  1/255; the sample that would take the transmittance below 1e-4 is not
  applied and the pixel stops there.

The blend pads each tile's list to the longest in a group of tiles of
similar load and evaluates every (pixel, list entry): plain tensors, with
autograd through them when asked, group by group. ``render`` returns the
image; ``render_backward`` the gradients of the projected quantities for a
given image gradient, by recomputing one group at a time.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch

TILE = 16
NEAR = 0.2
LOW_PASS = 0.3
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1.0e-4
# samples (pixels x list entries) a group evaluates at once
GROUP_SAMPLES = 1 << 23

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def sh_to_rgb(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """max(SH(d) + 0.5, 0) per colour; sh (N, K, 3), unit d (N, 3)."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    r = C0 * sh[:, 0]
    if deg >= 1:
        r = r - C1 * y * sh[:, 1] + C1 * z * sh[:, 2] - C1 * x * sh[:, 3]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        r = (r + C2[0] * x * y * sh[:, 4] + C2[1] * y * z * sh[:, 5]
             + C2[2] * (2 * zz - xx - yy) * sh[:, 6]
             + C2[3] * x * z * sh[:, 7] + C2[4] * (xx - yy) * sh[:, 8])
    if deg >= 3:
        r = (r + C3[0] * y * (3 * xx - yy) * sh[:, 9]
             + C3[1] * x * y * z * sh[:, 10]
             + C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
             + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
             + C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
             + C3[5] * z * (xx - yy) * sh[:, 14]
             + C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp_min(r + 0.5, 0.0)


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotation of unnormalised quaternions [w, x, y, z]."""
    q = q / (q.norm(dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def project(xyz, scales, quats, opac, sh, viewmat, fx, fy, width, height,
            sh_degree, offset=None) -> Dict[str, torch.Tensor]:
    """Screen-space quantities of N Gaussians (activated scales and
    opacities): mean (N, 2), conic (N, 3) [a, b, c], rgb (N, 3), opacity
    (N,) (0 where culled), depth (N,), radius (N,), rect (N, 4) int64
    [x0, y0, x1, y1) of tiles, visible (N,). ``offset`` (N, 2) is added to
    the means (the densify statistic's probe)."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    p = xyz @ R.T + t
    z = p[:, 2]
    front = z > NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    u, v = p[:, 0] / zs, p[:, 1] / zs
    mean = torch.stack([u * fx + width / 2.0, v * fy + height / 2.0], -1)
    if offset is not None:
        mean = mean + offset
    tanx, tany = 0.5 * width / fx, 0.5 * height / fy
    tx = torch.clamp(u, -1.3 * tanx, 1.3 * tanx) * z
    ty = torch.clamp(v, -1.3 * tany, 1.3 * tany) * z
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * tx / (z * z)], -1),
                     torch.stack([zero, fy / z, -fy * ty / (z * z)], -1)], 1)
    M = J @ R[None] @ rotation(quats) * scales[:, None, :]     # (N, 2, 3)
    cov = M @ M.transpose(1, 2)
    a = cov[:, 0, 0] + LOW_PASS
    c = cov[:, 1, 1] + LOW_PASS
    b = cov[:, 0, 1]
    det = a * c - b * b
    ok = det > 0
    dets = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c / dets, -b / dets, a / dets], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))

    campos = -R.T @ t
    d = xyz - campos
    d = d / torch.clamp_min(d.norm(dim=-1, keepdim=True), 1e-12)
    rgb = sh_to_rgb(sh_degree, sh, d)

    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    q = torch.clamp_max(2.0 * torch.log(torch.clamp_min(255.0 * opac,
                                                        1.0 + 1e-6)), 9.0)
    rx = torch.sqrt(q * a) + 0.5
    ry = torch.sqrt(q * c) + 0.5
    m = mean.detach()

    def tile(x, n):
        return torch.clamp(x, 0.0, float(n)).to(torch.int64)

    rect = torch.stack([tile((m[:, 0] - rx) / TILE, tiles_x),
                        tile((m[:, 1] - ry) / TILE, tiles_y),
                        tile((m[:, 0] + rx + TILE - 1) / TILE, tiles_x),
                        tile((m[:, 1] + ry + TILE - 1) / TILE, tiles_y)], -1)
    visible = (front & ok & (opac > ALPHA_MIN)
               & ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]) > 0))
    rect = torch.where(visible[:, None], rect, torch.zeros_like(rect))
    return {"mean": mean, "conic": conic, "rgb": rgb,
            "opacity": torch.where(visible, opac, torch.zeros_like(opac)),
            "depth": z, "radius": torch.where(visible, radius, zero),
            "rect": rect, "visible": visible}


class Lists:
    """The pairs of one frame: ``gid`` (P,) Gaussian of each pair, tile by
    tile in depth order; ``start``, ``count`` (tiles,) each tile's range."""

    def __init__(self, rect: torch.Tensor, depth: torch.Tensor,
                 tiles_x: int, tiles_y: int):
        dev = rect.device
        n_tiles = tiles_x * tiles_y
        tile_bits = max(1, n_tiles.bit_length())
        wx = rect[:, 2] - rect[:, 0]
        count = wx * (rect[:, 3] - rect[:, 1])
        gid = torch.repeat_interleave(torch.arange(rect.shape[0],
                                                   device=dev), count)
        first = torch.cumsum(count, 0) - count
        local = torch.arange(gid.shape[0], device=dev) - first[gid]
        tile = ((rect[gid, 1] + local // wx[gid]) * tiles_x
                + rect[gid, 0] + local % wx[gid])
        bits = depth.detach().contiguous().view(torch.int32).to(
            torch.int64) & 0xFFFFFFFF
        key = (tile << (32 - tile_bits)) | (bits[gid] >> tile_bits)
        order = torch.sort(key, stable=True).indices
        self.gid = gid[order]
        self.start = torch.searchsorted(
            tile[order], torch.arange(n_tiles, device=dev))
        self.count = torch.bincount(tile, minlength=n_tiles)
        self.tiles_x, self.tiles_y = tiles_x, tiles_y

    def groups(self) -> Iterator[Tuple[torch.Tensor, int]]:
        """(tile ids, padded length) of groups of tiles of similar load,
        each at most GROUP_SAMPLES samples."""
        order = torch.argsort(self.count, descending=True)
        loads = self.count[order].tolist()
        i = 0
        while i < len(loads) and loads[i] > 0:
            k = loads[i]
            n = max(1, GROUP_SAMPLES // (k * TILE * TILE))
            yield order[i:i + n], k
            i += n


def _pixels(tiles: torch.Tensor, tiles_x: int):
    """(T, 256) pixel x and y of ``tiles``, row-major inside a tile."""
    lane = torch.arange(TILE * TILE, device=tiles.device)
    px = (tiles % tiles_x)[:, None] * TILE + lane % TILE
    py = (tiles // tiles_x)[:, None] * TILE + lane // TILE
    return px, py


def _group_blend(att, lists: Lists, tiles, k):
    """color (T, 256, 3), T_final (T, 256), applied (T, K, 256) of one
    group; ``att`` = (mean, conic, rgb, opacity), differentiable."""
    mean, conic, rgb, opac = att
    dev = mean.device
    idx = torch.arange(k, device=dev)
    live = idx[None, :] < lists.count[tiles][:, None]                # (T, K)
    pos = torch.where(live, lists.start[tiles][:, None] + idx[None, :], 0)
    g = lists.gid[pos]                                               # (T, K)
    px, py = _pixels(tiles, lists.tiles_x)
    dx = px[:, None, :].float() - mean[g][..., 0:1]                  # (T,K,P)
    dy = py[:, None, :].float() - mean[g][..., 1:2]
    cn = conic[g]
    power = (-0.5 * (cn[..., 0:1] * dx * dx + cn[..., 2:3] * dy * dy)
             - cn[..., 1:2] * dx * dy)
    alpha = torch.clamp_max(opac[g][..., None] * torch.exp(power), ALPHA_MAX)
    ok = live[..., None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    with torch.no_grad():
        applied = ok & (torch.cumprod(1.0 - alpha, dim=1) >= T_EPS)
    a = torch.where(applied, alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - a, dim=1)
    before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
    color = torch.einsum("tkp,tkc->tpc", a * before, rgb[g])
    return color, trans[:, -1], applied


def _to_image(x: torch.Tensor, tiles, lists: Lists, width, height, out):
    """Scatter (T, 256, ...) tile pixels of ``tiles`` into ``out`` (H, W,
    ...), cropping at the frame's edge."""
    px, py = _pixels(tiles, lists.tiles_x)
    keep = (px < width) & (py < height)
    out[py[keep], px[keep]] = x[keep]


def render(prep: Dict, width: int, height: int, background,
           counts: bool = False):
    """(image (H, W, 3), T_final (H, W)), without gradients; with
    ``counts`` also the work the blend needs (``blend_counts``)."""
    dev = prep["mean"].device
    lists = Lists(prep["rect"], prep["depth"], -(-width // TILE),
                  -(-height // TILE))
    img = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    tfin = torch.ones((height, width), dtype=torch.float32, device=dev)
    att = tuple(prep[k].detach() for k in ("mean", "conic", "rgb", "opacity"))
    work = torch.zeros(3, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for tiles, k in lists.groups():
            color, t, applied = _group_blend(att, lists, tiles, k)
            _to_image(color, tiles, lists, width, height, img)
            _to_image(t, tiles, lists, width, height, tfin)
            if counts:
                px, py = _pixels(tiles, lists.tiles_x)
                inside = ((px < width) & (py < height))[:, None, :]
                applied = applied & inside
                work[0] += applied.sum()
                work[1] += applied.any(dim=2).sum()
    img = img + tfin[..., None] * background.reshape(1, 1, 3)
    if not counts:
        return img, tfin
    work[2] = int(prep["visible"].sum())
    return img, tfin, {"samples": int(work[0]), "pairs": int(work[1]),
                       "visible": int(work[2]),
                       "pixels": width * height}


def render_backward(prep: Dict, width: int, height: int,
                    grad_image: torch.Tensor, grad_tfin: Optional[
                        torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Gradients of (mean, conic, rgb, opacity) for the image gradient
    ``grad_image`` (H, W, 3) (and of T_final, where given), by recomputing
    the blend group by group under autograd."""
    lists = Lists(prep["rect"], prep["depth"], -(-width // TILE),
                  -(-height // TILE))
    att = tuple(prep[k].detach().requires_grad_(True)
                for k in ("mean", "conic", "rgb", "opacity"))
    for tiles, k in lists.groups():
        px, py = _pixels(tiles, lists.tiles_x)
        inside = (px < width) & (py < height)
        pxc, pyc = px.clamp_max(width - 1), py.clamp_max(height - 1)
        gc = torch.where(inside[..., None], grad_image[pyc, pxc], 0.0)
        with torch.enable_grad():
            color, t, _ = _group_blend(att, lists, tiles, k)
            outs, grads = [color], [gc]
            if grad_tfin is not None:
                outs.append(t)
                grads.append(torch.where(inside, grad_tfin[pyc, pxc], 0.0))
            torch.autograd.backward(outs, grads)
    return tuple(a.grad if a.grad is not None else torch.zeros_like(a)
                 for a in att)


def render_params(p: Dict[str, torch.Tensor], view, sh_degree: int,
                  background, counts: bool = False):
    """``render`` of pre-activation parameters ``p`` (live Gaussians only)
    from ``view`` (``scene.View``), without gradients."""
    sh = torch.cat([p["f_dc"][:, None], p["f_rest"]], 1)
    with torch.no_grad():
        prep = project(p["xyz"], torch.exp(p["scaling"]), p["rotation"],
                       torch.sigmoid(p["opacity"][:, 0]), sh,
                       torch.as_tensor(view.viewmat, device=sh.device),
                       view.fx, view.fy, view.width, view.height, sh_degree)
        return render(prep, view.width, view.height, background,
                      counts=counts)
