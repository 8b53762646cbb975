"""The training step: render -> appearance decouple -> loss -> gradients ->
Adam (counterpart of ``pcp_tpu/train/step.py``; train.py:94-157).

Gradients come from autograd: preprocess, the loss and the appearance net
in torch ops, the blend through ``ops.rasterize.Blend`` (the composite
forward and backward kernels and the per-Gaussian segment sum). The
densification signal is the gradient of a zero ``means2d_offset`` probe,
as in the JAX package. Parameters, moments and stats are updated in place;
densify, prune and opacity reset are separate functions on the same
fixed-capacity state, called by the loop on the reference cadence.

The loss and the update run inside ``torch.profiler.record_function``
ranges (``appearance + loss``, ``densify stats + adam``), beside those of
``ops.rasterize``, so a profiler run reads each stage's device time.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.models.appearance import (
    appearance_from_flax,
    decouple_appearance,
    net_tensors_from_flax,
)
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.ops.rasterize import rasterize
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.utils.general import expon_lr
from pcp_tpu_torch.utils.loss import l1_loss, ssim


@dataclass
class TrainState:
    """Everything that evolves during training."""

    params: Dict[str, torch.Tensor]   # Gaussian params (capacity-padded)
    app: Optional[Dict[str, Any]]     # {"embeddings", "net"} or None
    opt_g: Dict                       # Adam state of the Gaussian groups
    opt_a: Optional[Dict]             # Adam state of the appearance or None
    alive: torch.Tensor               # (C,) bool
    stats: Dict[str, torch.Tensor]    # densify accumulators


def app_groups(app) -> Dict[str, Any]:
    """The appearance parameters as Adam groups."""
    return {"embeddings": app["embeddings"],
            "net": list(app["net"].parameters())}


def gaussian_lrs(ocfg: OptimConfig, spatial_lr_scale: float):
    """Per-group LRs (training_setup, gaussian_model.py:159-179): xyz gets
    the exponential schedule scaled by the scene extent."""
    xyz_sched = functools.partial(
        expon_lr,
        lr_init=ocfg.position_lr_init * spatial_lr_scale,
        lr_final=ocfg.position_lr_final * spatial_lr_scale,
        lr_delay_steps=0,
        lr_delay_mult=ocfg.position_lr_delay_mult,
        max_steps=ocfg.position_lr_max_steps,
    )
    return {
        "xyz": xyz_sched,
        "f_dc": ocfg.feature_lr,
        "f_rest": ocfg.feature_lr / 20.0,
        "scaling": ocfg.scaling_lr,
        "rotation": ocfg.rotation_lr,
        "opacity": ocfg.opacity_lr,
    }


def appearance_lrs(ocfg: OptimConfig):
    return {
        "embeddings": ocfg.appearance_embeddings_lr,
        "net": ocfg.appearance_network_lr,
    }


def render_gaussians(
    params,
    alive,
    viewmat,
    intrin: CameraIntrin,
    image_size,
    background,
    sh_degree: int,
    *,
    max_per_tile: int = 1024,
    means2d_offset=None,
    tan_fov=None,
    scaling_modifier: float = 1.0,
    device: DeviceLike = None,
):
    """Activate the pre-activation params and rasterize. Dead slots get
    opacity 0 and are culled by preprocess."""
    opac = G.opacity_act(params["opacity"])[:, 0] * alive.to(torch.float32)
    return rasterize(
        params["xyz"],
        G.scaling_act(params["scaling"]) * scaling_modifier,
        params["rotation"],
        opac,
        G.sh_coeffs(params),
        viewmat,
        intrin,
        image_size,
        background,
        sh_degree,
        max_per_tile=max_per_tile,
        means2d_offset=means2d_offset,
        tan_fov=tan_fov,
        device=device,
    )


def photometric_loss(image, gt, app, view_idx, ocfg: OptimConfig):
    """(1 - lambda) L1(decoupled, gt) + lambda (1 - SSIM(image, gt)): L1 on
    the appearance-decoupled image, SSIM on the raw render
    (train.py:111-117)."""
    decoupled = image if app is None else decouple_appearance(
        image, app, view_idx)[0]
    chw = lambda x: x.permute(2, 0, 1)  # noqa: E731
    return (1.0 - ocfg.lambda_dssim) * l1_loss(decoupled, gt) + (
        ocfg.lambda_dssim) * (1.0 - ssim(chw(image), chw(gt)))


def train_step_impl(
    state: TrainState,
    viewmat,
    intrin: CameraIntrin,
    gt,                      # (H, W, 3) f32 in [0, 1] or u8
    view_idx: int,           # appearance embedding id
    background,              # (3,)
    extent: float,           # spatial_lr_scale
    *,
    ocfg: OptimConfig,
    image_size,
    sh_degree: int,
    use_appearance: bool,
) -> Tuple[TrainState, Dict[str, Any]]:
    """One step (train.py:94-157), updating ``state`` in place. Returns the
    state and the JAX package's metrics keys; the values stay on the card
    (``n_pairs`` and ``n_dropped`` are host ints). The JAX package's
    ``valid_wh`` pad-and-mask (its fleet's mixed resolutions) is not
    ported: every view trains at its own size."""
    w, h = int(image_size[0]), int(image_size[1])
    dev = state.alive.device
    if gt.dtype == torch.uint8:
        gt = gt.to(torch.float32) / 255.0
    app = state.app if use_appearance else None

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    probe = torch.zeros_like(state.params["xyz"][:, :2], requires_grad=True)
    app_leaves = {}
    if app is not None:
        app_leaves = {"embeddings": app["embeddings"].detach()
                      .requires_grad_(True)}
        app = {"embeddings": app_leaves["embeddings"], "net": app["net"]}
    image, aux = render_gaussians(
        leaves, state.alive, viewmat, intrin, (w, h), background, sh_degree,
        max_per_tile=ocfg.tile_clamp(), means2d_offset=probe, device=dev)
    with record_function("appearance + loss"):
        loss = photometric_loss(image, gt, app, view_idx, ocfg)
    net_params = list(app["net"].parameters()) if app is not None else []
    inputs = [*leaves.values(), probe, *app_leaves.values(), *net_params]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    n_g = len(leaves)
    g_gauss = dict(zip(leaves, grads[:n_g]))
    g_probe = grads[n_g]

    with torch.no_grad(), record_function("densify stats + adam"):
        # densify bookkeeping (add_densification_stats): the CUDA
        # rasterizer accumulates NDC-frame gradients, pixel grad * (W/2, H/2)
        scale = torch.tensor([0.5 * w, 0.5 * h], device=dev)
        gnorm = torch.linalg.norm(g_probe * scale, dim=-1)
        visible = aux["visible"] & state.alive
        zero = torch.zeros_like(gnorm)
        state.stats = {
            "grad_accum": state.stats["grad_accum"]
            + torch.where(visible, gnorm, zero),
            "denom": state.stats["denom"] + visible.to(torch.float32),
            "max_radii2d": torch.maximum(
                state.stats["max_radii2d"],
                torch.where(visible, aux["radii"], zero)),
        }
        # dead slots: no gradient leaks into them
        dead = ~state.alive
        g_gauss = {k: g.masked_fill(G.bmask(dead, g), 0.0)
                   for k, g in g_gauss.items()}
        optim.adam_step(state.params, g_gauss, state.opt_g,
                        gaussian_lrs(ocfg, extent))
        if app is not None:
            g_app = {"embeddings": grads[n_g + 1], "net": grads[n_g + 2:]}
            optim.adam_step(app_groups(state.app), g_app, state.opt_a,
                            appearance_lrs(ocfg))

    metrics = {
        "loss": loss.detach(),
        "n_pairs": aux["n_pairs"],
        "n_visible": visible.sum(),
        "overflow": aux["n_dropped"] > 0,
        "n_dropped": aux["n_dropped"],
        "max_tile_load": aux["max_tile_load"],
        "tile_saturated": aux["max_tile_load"] > ocfg.tile_clamp(),
    }
    return state, metrics


def densify_impl(state: TrainState, generator: Optional[torch.Generator],
                 extent: float, *, ocfg: OptimConfig, prune_big: bool,
                 noise=None) -> TrainState:
    """Densify + prune with the moment surgery; ``noise`` as in
    ``gaussians.densify_and_prune``."""
    params, alive, written = G.densify_and_prune(
        state.params, state.alive, state.stats, generator,
        grad_threshold=ocfg.densify_grad_threshold,
        min_opacity=ocfg.min_opacity, extent=extent,
        percent_dense=ocfg.percent_dense, prune_big_screen=prune_big,
        noise=noise)
    optim.zero_moments(state.opt_g, written)
    return TrainState(params, state.app, state.opt_g, state.opt_a, alive,
                      G.init_densify_stats(alive.shape[0], alive.device))


def opacity_reset_impl(state: TrainState) -> TrainState:
    """reset_opacity + zeroed opacity moments (gaussian_model.py:231-234,
    train.py:150-152)."""
    params = G.reset_opacity(state.params, state.alive)
    optim.zero_moments(state.opt_g, torch.ones_like(state.alive),
                       keys=("opacity",))
    return TrainState(params, state.app, state.opt_g, state.opt_a,
                      state.alive, state.stats)


def _adam_from_numpy(opt: Mapping, groups: Mapping[str, Any], dev) -> Dict:
    """The JAX package's {"mu", "nu", "count"} (numpy leaves, each group's
    leaves in ``groups``' order) -> the port's Adam state."""
    def leaves(tree):
        return {k: [torch.tensor(np.asarray(a, np.float32), device=dev)
                    for a in groups[k](tree[k])] for k in groups}
    return {"mu": leaves(opt["mu"]), "nu": leaves(opt["nu"]),
            "count": int(np.asarray(opt["count"]))}


def train_state_from_numpy(params: Mapping, app: Optional[Mapping],
                           opt_g: Mapping, opt_a: Optional[Mapping], alive,
                           stats: Mapping,
                           device: DeviceLike = None) -> TrainState:
    """A JAX ``TrainState``'s arrays as numpy (params, the appearance's
    embeddings and Flax tree, both Adam states, alive, stats) -> the port's
    state on ``device``, the same numbers."""
    dev = resolve_device(device)
    p, alive_t = G.params_from_numpy(params, alive, dev)
    one = lambda a: [a]  # noqa: E731
    opt_g_t = _adam_from_numpy(opt_g, {k: one for k in G.PARAM_KEYS}, dev)
    app_t = opt_a_t = None
    if app is not None:
        app_t = appearance_from_flax(app, dev)
        flax_np = lambda tree: [t.cpu().numpy() for t in  # noqa: E731
                                net_tensors_from_flax(tree, "cpu")]
        opt_a_t = _adam_from_numpy(opt_a, {"embeddings": one,
                                           "net": flax_np}, dev)
    stats_t = {k: torch.tensor(np.asarray(stats[k], np.float32), device=dev)
               for k in ("grad_accum", "denom", "max_radii2d")}
    return TrainState(p, app_t, opt_g_t, opt_a_t, alive_t, stats_t)
