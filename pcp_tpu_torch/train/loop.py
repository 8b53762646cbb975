"""Host-side training loop for one scene/block (counterpart of
``pcp_tpu/train/loop.py``; training(), train.py:40-243).

Random camera order per epoch, the SH degree warm-up (+1 every 1000
iterations), the densify cadence (every ``densification_interval`` after
``densify_from_iter`` while below ``densify_until_iter``) and the opacity
reset, both with the reference's strict bounds, the GT bank on the card as
uint8, L1/PSNR on the held-out views at ``test_iterations``, PLY saves at
``save_iterations``, full checkpoints (``chkpnt<it>.pth``) at
``checkpoint_iterations``, a cooperative STOP file, the ``pipeline.debug``
NaN dump, a ``torch.profiler`` trace and the viewer poll before each step
(``poll_viewer``; train.py:67-84).

Resume (``state`` and ``start_iter``) follows the JAX package: the loop runs
iterations ``start_iter + 1 .. iterations``, and both the camera shuffle and
the densify generator restart from ``cfg.seed`` (JAX loop.py:221-224,
434-435, 461-465), so a resumed run is JAX's resumed run, not the unbroken
one.

Not here (ROADMAP.md, "Not to port"): the JAX package's tile-table
re-tuning; exact binning has nothing to re-tune.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.eval.render_batch import eval_views
from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.models.appearance import init_appearance
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.scene.dataset import SceneInfo, split_train_test
from pcp_tpu_torch.train import checkpoint as ckpt
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

# What the viewer protocol expects after each frame (JAX loop.py:125).
VIEWER_VERIFY = "pcp_tpu"


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
    app = opt_a = None
    if cfg.pipeline.use_appearance:
        app = init_appearance(generator, dev,
                              map_scale=cfg.pipeline.app_map_scale)
        opt_a = optim.init_adam(app_groups(app))
    return TrainState(params=params, app=app, opt_g=optim.init_adam(params),
                      opt_a=opt_a, alive=alive,
                      stats=G.init_densify_stats(cfg.optim.capacity, dev))


def evaluate_cameras(state: TrainState, cams, sh_degree: int, background,
                     ocfg) -> Dict[str, float]:
    """Mean L1 and PSNR of the clipped renders over ``cams``
    (training_report, train.py:188-243), through ``eval_views``."""
    l1s, psnrs = eval_views(
        state.params, state.alive, cams, sh_degree, background,
        max_per_tile=ocfg.tile_clamp(), device=state.alive.device)
    return {"l1": float(np.mean(l1s)) if l1s else 0.0,
            "psnr": float(np.mean(psnrs)) if psnrs else 0.0}


def viewer_image(state: TrainState, cam, sh_degree: int, background,
                 ocfg) -> torch.Tensor:
    """The (H, W, 3) f32 render of the live state from a viewer camera
    (``viewer.ViewerCamera``) on the state's device, with no autograd
    graph: fx = w / (2 tan(fovx / 2)) (fy likewise) in double, then fp32;
    the principal point at the centre; viewmat = world_view_transform.T;
    the camera's ``scaling_modifier`` scales the extents (JAX
    loop.py:96-126). It reads the state and changes nothing in it."""
    dev = state.alive.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    fx = cam.width / (2.0 * math.tan(cam.fovx * 0.5))
    fy = cam.height / (2.0 * math.tan(cam.fovy * 0.5))
    intrin = CameraIntrin(fx=f32(fx), fy=f32(fy), cx=f32(cam.width / 2.0),
                          cy=f32(cam.height / 2.0))
    viewmat = torch.as_tensor(
        np.ascontiguousarray(cam.world_view_transform.T, np.float32),
        device=dev)
    with torch.no_grad():
        image, _ = render_gaussians(
            state.params, state.alive, viewmat, intrin,
            (cam.width, cam.height), background, sh_degree,
            max_per_tile=ocfg.tile_clamp(),
            scaling_modifier=cam.scaling_modifier, device=dev)
    return image


def to_frame(image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 on the image's device: clip to [0, 1], times 255 in
    fp32, truncated as numpy's ``astype(np.uint8)`` truncates."""
    return (torch.clamp(image, 0.0, 1.0) * 255.0).to(torch.uint8)


def poll_viewer(viewer, state: TrainState, sh_degree: int, background,
                ocfg, training_done: bool) -> bool:
    """One viewer poll (train.py:67-84): accept a waiting viewer, read one
    camera, render it, send the frame and VIEWER_VERIFY. Returns whether to
    poll again before the next step: the viewer keeps the connection alive
    and pauses training, and training is not done. The frame is cast on
    the device and crosses to the host as uint8; a failed render raises
    to the caller, only socket errors close the connection."""
    if viewer is None or not viewer.try_connect():
        return False
    cam = viewer.receive()
    if cam is None:
        return False
    frame = to_frame(viewer_image(state, cam, sh_degree, background, ocfg))
    viewer.send(frame.cpu().numpy(), VIEWER_VERIFY)
    return cam.keep_alive and not cam.do_training and not training_done


def save_model(state: TrainState, model_path: str, iteration: int,
               stem: str) -> str:
    """PLY snapshot under point_cloud/iteration_<it>/
    (scene/__init__.py:85-87)."""
    out_dir = os.path.join(model_path, "point_cloud", f"iteration_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{stem}.ply")
    G.save_gaussians_ply(path, state.params, state.alive)
    return path




def _profiler(enabled: bool, model_path: str, dev: torch.device):
    """A ``torch.profiler`` trace of the run under <model>/trace (in place
    of JAX's ``jax.profiler`` trace, loop.py:430-433), or nothing."""
    if not enabled:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            os.path.join(model_path, "trace")))


def _dump_step_inputs(path: str, state_host: List[np.ndarray], cam,
                      iteration: int, sh_degree: int) -> None:
    """The pre-step state's leaves and the camera's inputs in one npz, with
    the keys of JAX's dump (loop.py:648-660)."""
    arrs = {f"state_leaf_{i}": a for i, a in enumerate(state_host)}
    arrs["viewmat"] = np.asarray(cam.viewmat)
    arrs["gt_image"] = np.asarray(cam.gt_image)
    arrs["intrin"] = np.asarray([cam.fx, cam.fy, cam.width / 2.0,
                                 cam.height / 2.0], np.float32)
    arrs["view_uid"] = np.asarray(cam.uid)
    arrs["iteration"] = np.asarray(iteration)
    arrs["sh_degree"] = np.asarray(sh_degree)
    np.savez_compressed(path, **arrs)


def train_scene(
    scene: SceneInfo,
    cfg: TrainRunConfig,
    *,
    save_name: str = "point_cloud",
    log_fn: Optional[Callable[[str], None]] = print,
    state: Optional[TrainState] = None,
    start_iter: int = 0,
    log_interval: int = 100,
    profile: bool = False,
    viewer=None,
    device: DeviceLike = None,
) -> TrainState:
    """Train one scene/block on ``device`` (the card unless ``"cpu"``);
    writes its outputs under cfg.model.model_path. Metrics are read and
    logged at iteration 1 and every ``log_interval`` iterations, with the
    newest densify call's counts (``densify/wanted``, ``placed``,
    ``dropped``, ``pruned``, ``free``) where one ran since the last
    report. A given ``state`` (a loaded checkpoint) resumes at
    ``start_iter + 1``. A ``viewer`` (``viewer.NetworkGUI``) is polled
    before each step, and again while it pauses training (JAX
    loop.py:461-466)."""
    dev = resolve_device(device)
    model_path = cfg.model.model_path
    os.makedirs(model_path, exist_ok=True)
    save_cfg_args(model_path, cfg)
    ocfg = cfg.optim
    debug = cfg.pipeline.debug

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
    # a fresh run draws the appearance init and then the densify noise from
    # this generator; a resumed one starts its densify draws at the seed
    generator = torch.Generator().manual_seed(cfg.seed)
    if state is None:
        state = init_state(scene, cfg, generator, dev)

    rng = random.Random(cfg.seed)
    stack: List[int] = []
    ema_loss = 0.0
    t0 = t_last = time.time()
    it_last = start_iter
    # the newest densify call's counts (device tensors), read at the next
    # report: children wanted, placed and dropped at the capacity, pruned
    densify_counts: Dict[str, torch.Tensor] = {}
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

    def checkpoint(it):
        ckpt.save(os.path.join(model_path, f"chkpnt{it}.pth"), state, it)

    logger = TrainLogger(model_path)
    with contextlib.closing(logger), _profiler(profile, model_path, dev):
        for it in range(start_iter + 1, ocfg.iterations + 1):
            if viewer is not None:
                sh_now = min(cfg.model.sh_degree, (it - 1) // 1000)
                while poll_viewer(viewer, state, sh_now, background, ocfg,
                                  it >= ocfg.iterations):
                    pass
            if not stack:
                stack = list(range(len(cams)))
                rng.shuffle(stack)
            cam = cams[stack.pop()]
            sh_degree = min(cfg.model.sh_degree, (it - 1) // 1000)
            viewmat, intrin = cam_mod.camera_tensors(cam, dev)
            if debug:
                # the step updates the state in place: keep the inputs
                prev_host = ckpt.host_leaves(state)
            state, metrics = train_step_impl(
                state, viewmat, intrin, gt_of(cam), cam.uid, background,
                scene.extent, ocfg=ocfg, image_size=(cam.width, cam.height),
                sh_degree=sh_degree,
                use_appearance=cfg.pipeline.use_appearance)
            if debug and not np.isfinite(float(metrics["loss"])):
                # forensic dump, as the reference rasterizer's snapshot on a
                # CUDA error + --detect_anomaly (train.py:256)
                dump = os.path.join(model_path, f"nan_snapshot_{it}.npz")
                _dump_step_inputs(dump, prev_host, cam, it, sh_degree)
                raise FloatingPointError(
                    f"non-finite loss at iteration {it} "
                    f"(loss={float(metrics['loss'])}); step inputs dumped "
                    f"to {dump}")

            # densification cadence (train.py:140-152); both bounds strict
            if it < ocfg.densify_until_iter:
                if (it % ocfg.densification_interval == 0
                        and it > ocfg.densify_from_iter):
                    state = densify_impl(
                        state, generator, scene.extent, ocfg=ocfg,
                        prune_big=it > ocfg.opacity_reset_interval,
                        counts=densify_counts)
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
                    log_fn(f"[warn] iter {it}: per-tile saturation (densest "
                           f"tile holds {int(metrics['max_tile_load'])} "
                           f"Gaussians > max_per_tile={ocfg.max_per_tile}); "
                           f"the farthest are dropped in dense tiles -- "
                           f"raise --max_per_tile")
                densified = {k: int(v) for k, v in densify_counts.items()}
                densify_counts.clear()
                logger.scalars(it, {
                    "train_loss_patches/total_loss": loss,
                    "total_points": n_alive,
                    "iter_time": (now - t_last) / max(it - it_last, 1),
                    "n_pairs": float(metrics["n_pairs"]),
                    "n_dropped": metrics["n_dropped"],
                    **{f"densify/{k}": v for k, v in densified.items()},
                })
                t_last, it_last = now, it
                if log_fn:
                    log_fn(f"iter {it:6d} loss {ema_loss:.5f} alive "
                           f"{n_alive} ({now - t0:.1f}s)")
                    if densified:
                        log_fn("  densify: " + ", ".join(
                            f"{k} {v}" for k, v in densified.items()))
            if it in cfg.test_iterations and test_cams:
                m = evaluate_cameras(state, test_cams, sh_degree, background,
                                     ocfg)
                if log_fn:
                    log_fn(f"[eval {it}] test l1 {m['l1']:.4f} "
                           f"psnr {m['psnr']:.2f}")
                logger.scalars(it, {"test/loss_viewpoint_l1": m["l1"],
                                    "test/loss_viewpoint_psnr": m["psnr"]})
                logger.histogram(
                    it, "scene/opacity_histogram",
                    G.opacity_act(state.params["opacity"])[state.alive, 0]
                    .cpu().numpy())
                with open(os.path.join(model_path, f"eval_{it}.json"),
                          "w") as f:
                    json.dump(m, f)
            if it in cfg.save_iterations:
                save_model(state, model_path, it, save_name)
            if it in cfg.checkpoint_iterations:
                checkpoint(it)
            # cooperative early stop: `touch <model_path>/STOP` saves a PLY
            # and a resumable checkpoint at the current iteration and returns
            if it % 50 == 0 and os.path.exists(
                    os.path.join(model_path, "STOP")):
                if log_fn:
                    log_fn(f"STOP file seen at iter {it}: saving and exiting")
                save_model(state, model_path, it, save_name)
                checkpoint(it)
                return state

        save_model(state, model_path, ocfg.iterations, save_name)
    return state
