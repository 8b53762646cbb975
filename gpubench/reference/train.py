"""Plain PyTorch training of one block: the step the port's loop runs
(train.py:94-157 of the upstream, with VastGaussian's appearance
decoupling), its Adam update and its densify and prune.

The step: activate the parameters, render (``render``), decouple the
appearance (a 1/32 bilinear downsample, the view's 64-d embedding, the
convolutional network, an align-corners upsample, a sigmoid map times the
render), the loss (1 - lambda) L1(decoupled, gt) + lambda (1 - SSIM(render,
gt)) with the usual 11-tap Gaussian window, gradients of every parameter
and of a zero offset on the screen means (the densify statistic), the
statistics, and Adam with the upstream's learning rates and eps 1e-15.
Only live Gaussians are carried; the rest of a block's slots take no part.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from gpubench.reference import render as R

B1, B2, EPS = 0.9, 0.999, 1e-15
GAUSS_KEYS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def expon_lr(step: int, lr_init: float, lr_final: float, delay_mult: float,
             max_steps: int) -> float:
    """The upstream's log-linear schedule (get_expon_lr_func, no delay)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def gaussian_lrs(cfg: Dict, extent: float, step: int) -> Dict[str, float]:
    lr = cfg["lr"]
    return {"xyz": expon_lr(step, lr["position_init"] * extent,
                            lr["position_final"] * extent,
                            lr["position_delay_mult"],
                            int(cfg["position_lr_max_steps"])),
            "f_dc": lr["feature"], "f_rest": lr["feature"] / 20.0,
            "scaling": lr["scaling"], "rotation": lr["rotation"],
            "opacity": lr["opacity"]}


def app_net(x: torch.Tensor, convs, h: int, w: int,
            map_scale: float) -> torch.Tensor:
    """The appearance network on (1, 67, h/32, w/32): conv, 4 x (pixel
    shuffle 2, conv, ReLU), bilinear (align corners) to (h, w), conv,
    ReLU, conv, sigmoid, times ``map_scale``."""
    (w0, b0), *ups, (w1, b1), (w2, b2) = convs
    x = F.relu(F.conv2d(x, w0, b0, padding=1))
    for wk, bk in ups:
        x = F.relu(F.conv2d(F.pixel_shuffle(x, 2), wk, bk, padding=1))
    x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
    x = F.conv2d(F.relu(F.conv2d(x, w1, b1, padding=1)), w2, b2, padding=1)
    return map_scale * torch.sigmoid(x)


def decouple(image: torch.Tensor, emb: torch.Tensor, convs,
             map_scale: float) -> torch.Tensor:
    """map * image for an (H, W, 3) render and one view's embedding."""
    h, w = image.shape[:2]
    chw = image.permute(2, 0, 1)[None]
    down = F.interpolate(chw, size=(max(h // 32, 1), max(w // 32, 1)),
                         mode="bilinear", align_corners=True)
    x = torch.cat([down, emb[None, :, None, None].expand(
        1, emb.shape[0], down.shape[2], down.shape[3])], 1)
    return (app_net(x, convs, h, w, map_scale) * chw)[0].permute(1, 2, 0)


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images: 11-tap Gaussian window of sigma
    1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2 (loss_utils.py)."""
    g = torch.exp(-(torch.arange(11, dtype=torch.float32, device=x.device)
                    - 5) ** 2 / (2 * 1.5 ** 2))
    g = g / g.sum()
    win = (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()

    def blur(t):
        return F.conv2d(t[None], win, padding=5, groups=3)[0]

    mu1, mu2 = blur(x), blur(y)
    s1 = blur(x * x) - mu1 * mu1
    s2 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def loss_of(image, gt, app: Optional[Dict], uid: int, lam: float,
            map_scale: float) -> torch.Tensor:
    dec = image if app is None else decouple(
        image, app["embeddings"][uid], app["convs"], map_scale)
    return (1 - lam) * (dec - gt).abs().mean() + lam * (
        1 - ssim(image.permute(2, 0, 1), gt.permute(2, 0, 1)))


class Trainer:
    """The live Gaussians of a block (pre-activation, compact), the
    appearance state and both Adam states; ``step`` trains on one view."""

    def __init__(self, params: Dict[str, torch.Tensor], app: Optional[Dict],
                 cfg: Dict, extent: float, count: int):
        self.p = {k: params[k].detach().clone() for k in GAUSS_KEYS}
        self.app = None
        if app is not None:
            self.app = {"embeddings": app["embeddings"].detach().clone(),
                        "convs": [(w.detach().clone(), b.detach().clone())
                                  for w, b in app["convs"]]}
        self.cfg, self.extent, self.count = cfg, extent, count
        self.m = {k: torch.zeros_like(v) for k, v in self.leaves().items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.leaves().items()}
        n = self.p["xyz"].shape[0]
        dev = self.p["xyz"].device
        self.stats = {k: torch.zeros(n, device=dev)
                      for k in ("grad_accum", "denom", "max_radii2d")}

    def leaves(self) -> Dict[str, torch.Tensor]:
        out = dict(self.p)
        if self.app is not None:
            out["embeddings"] = self.app["embeddings"]
            for i, (w, b) in enumerate(self.app["convs"]):
                out[f"conv{i}.weight"], out[f"conv{i}.bias"] = w, b
        return out

    def lrs(self) -> Dict[str, float]:
        lr = gaussian_lrs(self.cfg, self.extent, self.count)
        a = self.cfg["lr"]
        for k in self.leaves():
            if k not in lr:
                lr[k] = (a["appearance_embeddings"] if k == "embeddings"
                         else a["appearance_network"])
        return lr

    def step(self, view, gt_u8: torch.Tensor, background,
             sh_degree: int) -> Dict:
        """One training step on ``view`` (scene.View) against the uint8
        ground truth; returns the loss and every leaf's gradient."""
        cfg = self.cfg
        w, h = view.width, view.height
        dev = self.p["xyz"].device
        gt = gt_u8.to(torch.float32) / 255.0
        leaves = {k: t.detach().requires_grad_(True)
                  for k, t in self.leaves().items()}
        probe = torch.zeros((self.p["xyz"].shape[0], 2), device=dev,
                            requires_grad=True)
        sh = torch.cat([leaves["f_dc"][:, None], leaves["f_rest"]], 1)
        prep = R.project(
            leaves["xyz"], torch.exp(leaves["scaling"]), leaves["rotation"],
            torch.sigmoid(leaves["opacity"][:, 0]), sh,
            torch.as_tensor(view.viewmat, device=dev), view.fx, view.fy,
            w, h, sh_degree, offset=probe)
        image, _ = R.render(prep, w, h, background)
        image = image.requires_grad_(True)
        app = None
        if self.app is not None:
            app = {"embeddings": leaves["embeddings"],
                   "convs": [(leaves[f"conv{i}.weight"],
                              leaves[f"conv{i}.bias"])
                             for i in range(len(self.app["convs"]))]}
        loss = loss_of(image, gt, app, view.uid, cfg["lambda_dssim"],
                       cfg.get("app_map_scale", 1.0))
        app_keys = [k for k in leaves if k not in GAUSS_KEYS]
        g_img, *g_app = torch.autograd.grad(
            loss, [image] + [leaves[k] for k in app_keys], allow_unused=True)
        g_att = R.render_backward(prep, w, h, g_img,
                                  (g_img * background).sum(-1))
        outs = [prep[k] for k in ("mean", "conic", "rgb", "opacity")]
        g_gauss = torch.autograd.grad(
            outs, [leaves[k] for k in GAUSS_KEYS] + [probe], g_att,
            allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(list(GAUSS_KEYS) + app_keys,
                                 list(g_gauss[:-1]) + g_app)}
        with torch.no_grad():
            gp = g_gauss[-1] if g_gauss[-1] is not None else torch.zeros_like(
                probe)
            vis = prep["visible"]
            gn = (gp * torch.tensor([0.5 * w, 0.5 * h], device=dev)).norm(
                dim=-1)
            st = self.stats
            st["grad_accum"] += torch.where(vis, gn, 0.0)
            st["denom"] += vis.float()
            st["max_radii2d"] = torch.maximum(
                st["max_radii2d"], torch.where(vis, prep["radius"], 0.0))
            self.adam(grads)
        return {"loss": float(loss.detach()), "grads": grads}

    def adam(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        t = self.count
        bc1, bc2 = 1 - B1 ** t, 1 - B2 ** t
        lrs = self.lrs()
        for k, p in self.leaves().items():
            g = grads[k]
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            p -= lrs[k] * (self.m[k] / bc1) / (
                torch.sqrt(self.v[k] / bc2) + EPS)


def densify(params: Dict[str, torch.Tensor], alive: torch.Tensor,
            stats: Dict[str, torch.Tensor], noise, cfg: Dict, extent: float,
            prune_big: bool):
    """One densify and prune (densify_and_prune, gaussian_model.py:
    377-429) on a block's slots: Gaussians whose mean screen gradient
    reaches the threshold are cloned (small) or split in two (large, the
    children drawn at ``noise`` times the scales, scales / 1.6, the
    parent removed); low opacity, and with ``prune_big`` large ones, are
    pruned. New Gaussians take the free slots in ascending order: first
    the clones and first children in slot order, then the second
    children. Returns (params, alive) with free slots at -10 log-scale
    and opacity logit."""
    c = alive.shape[0]
    grads = stats["grad_accum"] / torch.clamp_min(stats["denom"], 1.0)
    s = torch.exp(params["scaling"])
    smax = s.max(dim=1).values
    big = smax > cfg["percent_dense"] * extent
    hot = alive & (grads >= cfg["densify_grad_threshold"])
    clone, split = hot & ~big, hot & big
    opac = torch.sigmoid(params["opacity"][:, 0])
    prune = alive & (opac < cfg["min_opacity"])
    if prune_big:
        prune |= alive & ((stats["max_radii2d"] > 20.0)
                          | (smax > 0.1 * extent))
    keep = alive & ~prune & ~split

    rot = R.rotation(params["rotation"])

    def child(z):
        out = dict(params)
        out["xyz"] = params["xyz"] + (rot @ (z * s)[..., None])[..., 0]
        out["scaling"] = torch.log(s / 1.6)
        return out

    first = {k: torch.where(split.reshape((c,) + (1,) * (v.dim() - 1)), v,
                            params[k]) for k, v in child(noise[0]).items()}
    second = child(noise[1])
    srcs = torch.cat([torch.nonzero(clone | split)[:, 0],
                      c + torch.nonzero(split)[:, 0]])
    free = torch.nonzero(~keep)[:, 0]
    n = min(srcs.shape[0], free.shape[0])
    out = {}
    for k in params:
        v = params[k].clone()
        both = torch.cat([first[k], second[k]])
        v[free[:n]] = both[srcs[:n]]
        out[k] = v
    new_alive = keep.clone()
    new_alive[free[:n]] = True
    for k in ("opacity", "scaling"):
        out[k] = torch.where(new_alive[:, None], out[k],
                             torch.full_like(out[k], -10.0))
    return out, new_alive
