"""Host-side training loop for one scene/block (counterpart of
``pcp_tpu/train/loop.py``; training(), train.py:40-243).

Random camera order per epoch, the SH degree warm-up (+1 every 1000
iterations), the densify cadence (every ``densification_interval`` after
``densify_from_iter`` while below ``densify_until_iter``) and the opacity
reset, both with the reference's strict bounds, the GT bank on the card as
uint8, L1/PSNR on the held-out views at ``test_iterations``, PLY saves at
``save_iterations`` and a cooperative STOP file.

Not here (queued in ROADMAP.md): the JAX package's tile-table re-tuning
(exact binning has nothing to re-tune), the viewer, checkpoint resume and
the ``--debug`` NaN dump.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.models.appearance import init_appearance
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.scene.dataset import SceneInfo, split_train_test
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import TrainRunConfig, save_cfg_args
from pcp_tpu_torch.train.logging import TrainLogger
from pcp_tpu_torch.train.step import (
    TrainState,
    app_groups,
    densify_impl,
    opacity_reset_impl,
    render_gaussians,
    train_step_impl,
)
from pcp_tpu_torch.utils.image import psnr


def init_state(scene: SceneInfo, cfg: TrainRunConfig,
               generator: torch.Generator,
               device: DeviceLike = None) -> TrainState:
    """Gaussians from the scene's points, appearance from ``generator``,
    zero Adam moments and densify stats."""
    dev = resolve_device(device)
    gcfg = G.GaussianConfig(sh_degree=cfg.model.sh_degree,
                            capacity=cfg.optim.capacity,
                            percent_dense=cfg.optim.percent_dense)
    params, alive = G.create_from_pcd(scene.points, scene.colors, gcfg, dev)
    if cfg.pipeline.app_map_scale != 1.0:
        raise ValueError("app_map_scale != 1 (the JAX package's "
                         "PCP_APP_MAP_SCALE) is not ported")
    app = opt_a = None
    if cfg.pipeline.use_appearance:
        app = init_appearance(generator, dev)
        opt_a = optim.init_adam(app_groups(app))
    return TrainState(params=params, app=app, opt_g=optim.init_adam(params),
                      opt_a=opt_a, alive=alive,
                      stats=G.init_densify_stats(cfg.optim.capacity, dev))


def evaluate_cameras(state: TrainState, cams, sh_degree: int, background,
                     ocfg) -> Dict[str, float]:
    """Mean L1 and PSNR of the clipped renders over ``cams``
    (training_report, train.py:188-243); each view reduces on the card."""
    dev = state.alive.device
    l1s, psnrs = [], []
    with torch.no_grad():
        for cam in cams:
            viewmat, intrin = cam_mod.camera_tensors(cam, dev)
            img, _ = render_gaussians(
                state.params, state.alive, viewmat, intrin,
                (cam.width, cam.height), background, sh_degree,
                max_per_tile=ocfg.tile_clamp(), device=dev)
            img = torch.clamp(img, 0.0, 1.0)[None]
            gt = torch.as_tensor(cam.gt_image, device=dev)[None]
            l1s.append(torch.abs(img - gt).mean())
            psnrs.append(psnr(img, gt)[0])
    if not cams:
        return {"l1": 0.0, "psnr": 0.0}
    return {"l1": float(torch.stack(l1s).mean()),
            "psnr": float(torch.stack(psnrs).mean())}


def save_model(state: TrainState, model_path: str, iteration: int,
               stem: str) -> str:
    """PLY snapshot under point_cloud/iteration_<it>/
    (scene/__init__.py:85-87)."""
    out_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{stem}.ply")
    G.save_gaussians_ply(path, state.params, state.alive)
    return path


def train_scene(
    scene: SceneInfo,
    cfg: TrainRunConfig,
    *,
    save_name: str = "point_cloud",
    log_fn: Optional[Callable[[str], None]] = print,
    state: Optional[TrainState] = None,
    log_interval: int = 100,
    device: DeviceLike = None,
) -> TrainState:
    """Train one scene/block on ``device`` (the card unless ``"cpu"``);
    writes its outputs under cfg.model.model_path. Metrics are read and
    logged at iteration 1 and every ``log_interval`` iterations."""
    dev = resolve_device(device)
    model_path = cfg.model.model_path
    os.makedirs(model_path, exist_ok=True)
    save_cfg_args(model_path, cfg)
    ocfg = cfg.optim

    train_infos, test_infos = split_train_test(
        scene.cameras, cfg.model.eval, cfg.model.llffhold,
        explicit_test=scene.test_camera_uids)
    cams = [cam_mod.from_info(i, cfg.model.resolution) for i in train_infos]
    test_cams = [cam_mod.from_info(i, cfg.model.resolution)
                 for i in test_infos]
    if not cams:
        raise ValueError("no training cameras")

    background = torch.tensor(
        [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
        device=dev)
    generator = torch.Generator().manual_seed(cfg.seed)
    if state is None:
        state = init_state(scene, cfg, generator, dev)

    logger = TrainLogger(model_path)
    rng = random.Random(cfg.seed)
    stack: List[int] = []
    ema_loss = 0.0
    t0 = t_last = time.time()
    it_last = 0
    # GT bank on the card as uint8: the sources are 8-bit images, so u8
    # holds them exactly at a quarter of the memory (loop.py:440-460);
    # images outside [0, 1] stay f32.
    gt_dev: Dict[int, torch.Tensor] = {}

    def gt_of(cam):
        if cfg.model.data_device != "device":
            return torch.as_tensor(cam.gt_image, device=dev)
        buf = gt_dev.get(cam.uid)
        if buf is None:
            img = np.asarray(cam.gt_image)
            if img.dtype != np.uint8 and img.min() >= 0.0 and img.max() <= 1.0:
                img = np.round(img * 255.0).astype(np.uint8)
            buf = gt_dev.setdefault(cam.uid, torch.as_tensor(img, device=dev))
        return buf

    for it in range(1, ocfg.iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
            rng.shuffle(stack)
        cam = cams[stack.pop()]
        sh_degree = min(cfg.model.sh_degree, (it - 1) // 1000)
        viewmat, intrin = cam_mod.camera_tensors(cam, dev)
        state, metrics = train_step_impl(
            state, viewmat, intrin, gt_of(cam), cam.uid, background,
            scene.extent, ocfg=ocfg, image_size=(cam.width, cam.height),
            sh_degree=sh_degree, use_appearance=cfg.pipeline.use_appearance)

        # densification cadence (train.py:140-152); both bounds are strict
        if it < ocfg.densify_until_iter:
            if (it % ocfg.densification_interval == 0
                    and it > ocfg.densify_from_iter):
                state = densify_impl(
                    state, generator, scene.extent, ocfg=ocfg,
                    prune_big=it > ocfg.opacity_reset_interval)
            if it % ocfg.opacity_reset_interval == 0 or (
                    cfg.model.white_background
                    and it == ocfg.densify_from_iter):
                state = opacity_reset_impl(state)

        if it % log_interval == 0 or it == 1:
            loss = float(metrics["loss"])
            ema_loss = loss if it == 1 else 0.6 * ema_loss + 0.4 * loss
            now = time.time()
            n_alive = int(state.alive.sum())
            if bool(metrics["tile_saturated"]) and log_fn:
                log_fn(f"[warn] iter {it}: per-tile saturation (densest tile "
                       f"holds {int(metrics['max_tile_load'])} Gaussians > "
                       f"max_per_tile={ocfg.max_per_tile}); the farthest are "
                       f"dropped in dense tiles -- raise --max_per_tile")
            logger.scalars(it, {
                "train_loss_patches/total_loss": loss,
                "total_points": n_alive,
                "iter_time": (now - t_last) / max(it - it_last, 1),
                "n_pairs": float(metrics["n_pairs"]),
                "n_dropped": metrics["n_dropped"],
            })
            t_last, it_last = now, it
            if log_fn:
                log_fn(f"iter {it:6d} loss {ema_loss:.5f} alive {n_alive} "
                       f"({now - t0:.1f}s)")
        if it in cfg.test_iterations and test_cams:
            m = evaluate_cameras(state, test_cams, sh_degree, background, ocfg)
            if log_fn:
                log_fn(f"[eval {it}] test l1 {m['l1']:.4f} "
                       f"psnr {m['psnr']:.2f}")
            logger.scalars(it, {"test/loss_viewpoint_l1": m["l1"],
                                "test/loss_viewpoint_psnr": m["psnr"]})
            logger.histogram(
                it, "scene/opacity_histogram",
                G.opacity_act(state.params["opacity"])[state.alive, 0]
                .cpu().numpy())
            with open(os.path.join(model_path, f"eval_{it}.json"), "w") as f:
                json.dump(m, f)
        if it in cfg.save_iterations:
            save_model(state, model_path, it, save_name)
        # cooperative early stop: `touch <model_path>/STOP` saves a PLY at
        # the current iteration and returns
        if it % 50 == 0 and os.path.exists(os.path.join(model_path, "STOP")):
            if log_fn:
                log_fn(f"STOP file seen at iter {it}: saving and exiting")
            save_model(state, model_path, it, save_name)
            logger.close()
            return state

    save_model(state, model_path, ocfg.iterations, save_name)
    logger.close()
    return state
