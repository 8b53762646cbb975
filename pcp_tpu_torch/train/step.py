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
``ops.preprocess_fwd`` and ``ops.rasterize``, so a profiler run reads each
stage's device time.
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
from pcp_tpu_torch.ops.preprocess_fwd import (
    preprocess_params,
    preprocess_params_plain,
)
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.ops.rasterize import blend_image
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
    opacity 0 and are culled by preprocess.

    Where no gradient can flow (autograd off, or no parameter requiring
    one) and there is no ``means2d_offset`` probe, the view's preprocess is
    ``preprocess_fwd.preprocess_params``, one kernel on the card reading the
    stored parameters in place; otherwise it is its plain version under
    autograd. Both then bin and blend through ``rasterize.blend_image``."""
    dev = resolve_device(device)

    def on(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev)

    args = ({k: on(params[k]).contiguous() for k in G.PARAM_KEYS},
            torch.as_tensor(alive, device=dev).contiguous(), on(viewmat),
            CameraIntrin(*(on(v) for v in intrin)), image_size, sh_degree)
    kw = dict(scaling_modifier=scaling_modifier, tan_fov=tan_fov)
    if means2d_offset is None and not (torch.is_grad_enabled() and any(
            params[k].requires_grad for k in G.PARAM_KEYS)):
        prep, pack = preprocess_params(*args, **kw)
    else:
        prep, pack = preprocess_params_plain(
            *args, **kw, means2d_offset=None if means2d_offset is None
            else on(means2d_offset))
    return blend_image(prep, pack, image_size, on(background), max_per_tile)


def photometric_loss(image, gt, app, view_idx, ocfg: OptimConfig,
                     mask=None):
    """(1 - lambda) L1(decoupled, gt) + lambda (1 - SSIM(image, gt)): L1 on
    the appearance-decoupled image, SSIM on the raw render
    (train.py:111-117); with ``mask`` (H, W) both run over its pixels
    only."""
    decoupled = image if app is None else decouple_appearance(
        image, app, view_idx)[0]
    chw = lambda x: x.permute(2, 0, 1)  # noqa: E731
    return (1.0 - ocfg.lambda_dssim) * l1_loss(decoupled, gt, mask) + (
        ocfg.lambda_dssim) * (1.0 - ssim(chw(image), chw(gt),
                                         valid_mask=mask))


def valid_mask(valid_wh, image_size, device) -> Optional[torch.Tensor]:
    """(H, W) bool mask of a camera's native (w, h) inside the padded
    ``image_size`` frame (JAX step.py:168-171), or None for no mask."""
    if valid_wh is None:
        return None
    w, h = int(image_size[0]), int(image_size[1])
    return ((torch.arange(w, device=device)[None, :] < int(valid_wh[0]))
            & (torch.arange(h, device=device)[:, None] < int(valid_wh[1])))


def apply_app_update(state: TrainState, g_app: Mapping,
                     ocfg: OptimConfig) -> TrainState:
    """The appearance Adam on gradients ``g_app`` ({"embeddings", "net"}),
    the half of a step that ``train_step_impl(defer_app=True)`` leaves to
    its caller (JAX's ``app_grad_reduce`` point, step.py:229-231)."""
    with torch.no_grad():
        optim.adam_step(app_groups(state.app), g_app, state.opt_a,
                        appearance_lrs(ocfg))
    return state


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
    valid_wh=None,
    defer_app: bool = False,
    render=None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """One step (train.py:94-157), updating ``state`` in place. Returns the
    state and the JAX package's metrics keys; the values stay on the card
    (``n_pairs`` and ``n_dropped`` are host ints).

    ``valid_wh`` (the camera's native (w, h), host ints) is the JAX
    package's pad-and-mask for mixed resolutions: ``image_size`` is the
    padded frame, ``gt`` is zero-padded into it, L1 and SSIM run over the
    native pixels only, and the render, the probe's NDC scaling and the
    appearance net see the whole frame, as in JAX. ``defer_app`` skips
    the appearance Adam and returns its gradients as ``metrics["g_app"]``
    for the caller to reduce and apply (``apply_app_update``): the
    fleet's shared appearance. ``render`` (default ``render_gaussians``,
    same signature) is the rasterizer: the intra-block path passes its
    Gaussian-sharded one, and the rest of the step then runs on this
    rank's shard of the slots."""
    w, h = int(image_size[0]), int(image_size[1])
    dev = state.alive.device
    if gt.dtype == torch.uint8:
        gt = gt.to(torch.float32) / 255.0
    app = state.app if use_appearance else None
    mask = valid_mask(valid_wh, (w, h), dev)

    leaves = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    probe = torch.zeros_like(state.params["xyz"][:, :2], requires_grad=True)
    app_leaves = {}
    if app is not None:
        app_leaves = {"embeddings": app["embeddings"].detach()
                      .requires_grad_(True)}
        app = {"embeddings": app_leaves["embeddings"], "net": app["net"]}
    image, aux = (render or render_gaussians)(
        leaves, state.alive, viewmat, intrin, (w, h), background, sh_degree,
        max_per_tile=ocfg.tile_clamp(), means2d_offset=probe, device=dev)
    with record_function("appearance + loss"):
        loss = photometric_loss(image, gt, app, view_idx, ocfg, mask)
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
        g_app = None
        if app is not None:
            g_app = {"embeddings": grads[n_g + 1], "net": grads[n_g + 2:]}
            if not defer_app:
                apply_app_update(state, g_app, ocfg)

    metrics = {
        "loss": loss.detach(),
        "n_pairs": aux["n_pairs"],
        "n_visible": visible.sum(),
        "overflow": aux["n_dropped"] > 0,
        "n_dropped": aux["n_dropped"],
        "max_tile_load": aux["max_tile_load"],
        "tile_saturated": aux["max_tile_load"] > ocfg.tile_clamp(),
    }
    if defer_app:
        metrics["g_app"] = g_app
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
