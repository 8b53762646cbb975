"""Fleet training: every block of a partitioned scene at once (counterpart
of ``pcp_tpu/parallel/fleet.py``).

The JAX package stacks the blocks' states along a ``blocks`` axis and runs
one SPMD program over a device mesh. Here a rank keeps a list of per-block
``TrainState``s and steps them in turn, one ``train_step_impl`` each; each
block's autograd graph is freed before the next block's forward, so only
the small appearance gradients of the shared mode stay alive across
blocks. Several cards run one rank each (``parallel.distributed``), each
owning a contiguous slice of the blocks.

Blocks are independent: without ``share_appearance`` a block trained in
the fleet is the block trained alone, bit for bit. Block *i* (its global
index) draws its camera order from ``random.Random(seed + 17 i)``, as
JAX's fleet does, and its appearance init and densify noise from a
``torch.Generator`` seeded with ``seed + 17 i``; block 0 of a fleet is
therefore ``train.loop.train_scene``'s block.

Mixed resolutions pad into one frame (the largest width and height over
every block's cameras); the step masks L1 and SSIM to each camera's native
size (``train_step_impl(valid_wh=...)``), and a camera of the frame's size
trains unmasked.

``share_appearance`` replaces the per-block appearance nets, whose
exposures diverge and leave seams after the merge, with one appearance
state for all blocks, initialised as block 0's: the steps defer the
appearance Adam, the embedding gradients are summed and the net's averaged
over the blocks, in global block order (an all-gather of every block's
gradients, then a sum block by block), so the bits do not depend on how
many ranks there are; then one Adam step updates the shared state.

Not ported (TPU machinery): the stacked state, padding the blocks to a
mesh multiple, and the tile-table autosize and re-tune.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.models.appearance import init_appearance
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.parallel import distributed as pdist
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.train import checkpoint as ckpt
from pcp_tpu_torch.train import loop
from pcp_tpu_torch.train import optim
from pcp_tpu_torch.train.config import OptimConfig
from pcp_tpu_torch.train.step import (
    TrainState,
    app_groups,
    apply_app_update,
    densify_impl,
    opacity_reset_impl,
    train_step_impl,
)

FLEET_CKPT_NAME = "chkpnt_fleet.pth"

# (viewmat (4, 4), CameraIntrin, gt (H, W, 3) in the frame, uid, valid_wh)
View = Tuple[torch.Tensor, CameraIntrin, torch.Tensor, int,
             Optional[Tuple[int, int]]]


def _valid_wh(cam, frame) -> Optional[Tuple[int, int]]:
    """None when the camera fills the frame (the step then masks nothing,
    the single-block step's bits), else its native (w, h)."""
    wh = (cam.width, cam.height)
    return None if wh == tuple(frame) else wh


@dataclass
class CameraBank:
    """One block's cameras (JAX ``CameraBank``): viewmats, intrinsics and
    the GT zero-padded into the frame, as uint8 (the sources are 8-bit
    images; the step turns u8 into f32 on the device, as the loop's GT
    bank does), f32 where a GT lies outside [0, 1]. On the card the host
    sends only a camera index a step; in host memory (the host-fed fleet)
    ``view`` ships the camera each step."""

    viewmats: torch.Tensor            # (C, 4, 4)
    intrins: torch.Tensor             # (C, 4) fx, fy, cx, cy
    gts: torch.Tensor                 # (C, H, W, 3) u8 or f32
    uid: List[int]
    valid_wh: List[Optional[Tuple[int, int]]]

    def view(self, ci: int, device: Optional[torch.device] = None) -> View:
        """Camera ``ci`` as the step takes it, on ``device`` (default: the
        bank's)."""
        dev = self.gts.device if device is None else device
        fx, fy, cx, cy = self.intrins[ci].to(dev)
        return (self.viewmats[ci].to(dev), CameraIntrin(fx, fy, cx, cy),
                self.gts[ci].to(dev), self.uid[ci], self.valid_wh[ci])


def build_camera_bank(block_cams: Sequence[Sequence], frame,
                      device: torch.device) -> List[CameraBank]:
    """One ``CameraBank`` per block of ``block_cams`` on ``device``, padded
    to the (w, h) ``frame``."""
    w, h = frame
    banks = []
    for cams in block_cams:
        imgs = [np.asarray(c.gt_image) for c in cams]
        u8 = all(i.min() >= 0.0 and i.max() <= 1.0 for i in imgs)
        gts = np.zeros((len(cams), h, w, 3), np.uint8 if u8 else np.float32)
        for k, (c, img) in enumerate(zip(cams, imgs)):
            gts[k, :c.height, :c.width] = (np.round(img * 255.0) if u8
                                           else img)
        banks.append(CameraBank(
            viewmats=torch.as_tensor(np.stack([c.viewmat for c in cams]),
                                     dtype=torch.float32, device=device),
            intrins=torch.tensor(
                [[c.fx, c.fy, c.width / 2.0, c.height / 2.0] for c in cams],
                dtype=torch.float32, device=device),
            gts=torch.as_tensor(gts, device=device),
            uid=[c.uid for c in cams],
            valid_wh=[_valid_wh(c, frame) for c in cams]))
    return banks


def _app_shapes(app) -> List[torch.Size]:
    return [app["embeddings"].shape] + [p.shape
                                        for p in app["net"].parameters()]


def shared_app_reduce(g_apps: Sequence, block_index: Sequence[int],
                      n_blocks: int, app) -> dict:
    """The shared appearance's gradients over all ``n_blocks`` blocks
    (JAX ``_shared_app_reduce``, fleet.py:91-118): the embedding rows
    summed (each view belongs to one block), the net averaged over the
    blocks. ``g_apps[j]`` is the gradient of this rank's block
    ``block_index[j]``; every rank of the joined group calls this once a
    step, a rank without blocks too. Each block's flat gradient is
    all-gathered and the blocks are added in global order, so the sum's
    bits do not depend on the number of ranks."""
    shapes = _app_shapes(app)
    sizes = [s.numel() for s in shapes]
    dev = app["embeddings"].device
    world, rank = pdist.world(), pdist.rank()
    per = (n_blocks + world - 1) // world
    rows = torch.zeros((per, sum(sizes)), dtype=torch.float32, device=dev)
    for gi, g in zip(block_index, g_apps):
        j = gi - rank * per
        assert 0 <= j < per, (gi, rank, per)
        rows[j] = torch.cat([g["embeddings"].reshape(-1)]
                            + [t.reshape(-1) for t in g["net"]])
    if dist.is_initialized():
        parts = [torch.empty_like(rows) for _ in range(world)]
        dist.all_gather(parts, rows)
        rows = torch.cat(parts)
    acc = rows[0].clone()
    for b in range(1, n_blocks):
        acc += rows[b]
    leaves = list(torch.split(acc, sizes))
    emb = leaves[0].view(shapes[0])
    net = [t.view(s) / float(max(n_blocks, 1))
           for t, s in zip(leaves[1:], shapes[1:])]
    return {"embeddings": emb, "net": net}


def make_fleet_step(ocfg: OptimConfig, image_size, *,
                    use_appearance: bool = True,
                    share_appearance: bool = False,
                    n_blocks: Optional[int] = None) -> Callable:
    """The fleet step (JAX ``make_fleet_step``): ``step(states, extents,
    views, background, sh_degree, block_index, shared)`` takes one
    ``View`` per local block (global indices ``block_index``), steps every
    block at the padded ``image_size`` frame and returns the per-block
    metrics. With
    sharing, ``shared`` is the appearance-only state every block's
    ``app``/``opt_a`` point to, and ``n_blocks`` the fleet's size."""
    share = share_appearance and use_appearance

    def step(states, extents, views, background, sh_degree: int,
             block_index: Sequence[int], shared=None):
        metrics, g_apps = [], []
        for st, extent, (viewmat, intrin, gt, uid, wh) in zip(
                states, extents, views):
            _, m = train_step_impl(
                st, viewmat, intrin, gt, uid, background, extent, ocfg=ocfg,
                image_size=image_size, sh_degree=sh_degree,
                use_appearance=use_appearance, valid_wh=wh, defer_app=share)
            if share:
                g_apps.append(m.pop("g_app"))
            metrics.append(m)
        if share:
            g = shared_app_reduce(g_apps, block_index,
                                  n_blocks or len(states), shared.app)
            apply_app_update(shared, g, ocfg)
        return metrics

    return step


def make_fleet_step_banked(ocfg: OptimConfig, image_size, **kw) -> Callable:
    """The fleet step on camera banks (JAX ``make_fleet_step_banked``):
    ``step(states, extents, banks, cam_idx, background, sh_degree,
    block_index, shared, device)``; each block's camera ``cam_idx[j]``
    comes from its bank, shipped to ``device`` when the bank is in host
    memory."""
    inner = make_fleet_step(ocfg, image_size, **kw)

    def step(states, extents, banks, cam_idx, background, sh_degree: int,
             block_index: Sequence[int], shared=None, device=None):
        views = [b.view(ci, device) for b, ci in zip(banks, cam_idx)]
        return inner(states, extents, views, background, sh_degree,
                     block_index, shared)

    return step


def _save(path: str, state: TrainState, it: int) -> None:
    tmp = path + ".tmp"
    ckpt.save(tmp, state, it)
    os.replace(tmp, path)


def train_blocks_parallel(
    block_scenes,                  # this rank's SceneInfos, in block order
    cfg,                           # TrainRunConfig
    *,
    iterations: Optional[int] = None,
    log_fn: Optional[Callable[[str], None]] = print,
    seed: int = 0,
    device_data: bool = False,
    block_dirs: Optional[List[str]] = None,   # per-block output dirs
    block_ids: Optional[List[str]] = None,    # names for progress_fn
    progress_fn=None,                          # progress_fn(bid, **fields)
    checkpoint_interval: int = 0,              # >0: rolling ckpt cadence
    resume: bool = False,                      # restore FLEET_CKPT_NAME
    block_offset: int = 0,                     # fleet position of block 0
    n_blocks: Optional[int] = None,            # the fleet's block count
    seed_index: Optional[Sequence[int]] = None,  # index in the scene's list
    device: DeviceLike = None,
) -> List[TrainState]:
    """Train this rank's blocks all at once (JAX
    ``train_blocks_parallel``); returns their final states in order.

    Under a joined process group (``parallel.distributed``) each rank
    passes its slice of the blocks with ``block_offset`` and the fleet's
    ``n_blocks``; the frame, the resume iteration and the shared
    appearance are agreed across ranks, and a rank without blocks still
    joins every collective. Block j's camera order and generator come
    from ``seed + 17 * seed_index[j]`` (default: its fleet position), so a
    fleet of some of a scene's blocks gives each the draws it has in the
    whole fleet; the shared appearance's net is averaged over the blocks
    trained together. Each step the host picks a camera per block;
    with ``device_data`` the blocks' cameras and uint8 GT live on the card
    (``CameraBank``) and only indices cross, otherwise the banks stay in
    host memory and each step ships its cameras (the GT as uint8, a
    quarter of JAX's f32 bytes, turned into f32 on the card as the loop
    does).

    With ``block_dirs``: every ``checkpoint_interval`` iterations each
    block writes a rolling ``chkpnt_fleet.pth`` (and one at the end), and
    ``progress_fn`` records it; ``cfg.test_iterations`` run a per-block
    L1/PSNR eval on up to 3 of its training views, ``cfg.save_iterations``
    write PLY snapshots, and each block logs to its own ``TrainLogger``.
    ``resume=True`` loads each block's rolling checkpoint and restarts
    every block from the oldest iteration among them (the minimum over
    all ranks)."""
    dev = resolve_device(device)
    ocfg = cfg.optim
    iterations = iterations or ocfg.iterations
    n_local = len(block_scenes)
    n_blocks = n_local if n_blocks is None else n_blocks
    pos = [block_offset + j for j in range(n_local)]
    # seeds and log numbers: each block's index in the scene's whole block
    # list, so a fleet of some blocks (a retry) keeps every block's draws
    gidx = pos if seed_index is None else [int(i) for i in seed_index]
    if len(gidx) != n_local:
        raise ValueError(f"{len(gidx)} seed indices for {n_local} blocks")
    if block_ids is None:
        block_ids = [f"block{i}" for i in gidx]
    share = bool(cfg.pipeline.share_appearance
                 and cfg.pipeline.use_appearance)

    block_cams = [[cam_mod.from_info(i, cfg.model.resolution)
                   for i in scene.cameras] for scene in block_scenes]
    sizes = {(c.width, c.height) for cams in block_cams for c in cams}
    frame = tuple(pdist.allreduce_int(max((s[k] for s in sizes), default=0),
                                      dev, dist.ReduceOp.MAX)
                  for k in (0, 1))
    if len(sizes) > 1 and log_fn:
        log_fn(f"fleet: {len(sizes)} camera resolutions; padding to "
               f"{frame[0]}x{frame[1]} with per-camera loss masks")

    generators = [torch.Generator().manual_seed(seed + 17 * i) for i in gidx]
    states, ckpt_iters = [], []
    for j, scene in enumerate(block_scenes):
        st = loop.init_state(scene, cfg, generators[j], dev)
        path = (os.path.join(block_dirs[j], FLEET_CKPT_NAME)
                if block_dirs else None)
        if resume and path and os.path.exists(path):
            st, it0 = ckpt.load(path, st)
            ckpt_iters.append(int(it0))
        else:
            ckpt_iters.append(0)
        states.append(st)
    start_iter = 0
    if resume:
        start_iter = pdist.allreduce_int(min(ckpt_iters, default=iterations),
                                         dev, dist.ReduceOp.MIN)
        if log_fn:
            log_fn(f"fleet: resuming from iteration {start_iter} "
                   f"(per-block checkpoints at {ckpt_iters})")

    shared = None
    if share:
        # one appearance state for every block: block 0's init, or the
        # first restored block's (checkpoints are written in lockstep)
        loaded = [st for st, i in zip(states, ckpt_iters) if i > 0]
        if loaded:
            app, opt_a = loaded[0].app, loaded[0].opt_a
        else:
            app = init_appearance(torch.Generator().manual_seed(seed), dev,
                                  map_scale=cfg.pipeline.app_map_scale)
            opt_a = optim.init_adam(app_groups(app))
        shared = TrainState({}, app, None, opt_a, None, {})
        for st in states:
            st.app, st.opt_a = app, opt_a

    # the banks on the card, or in host memory for the host-fed fleet
    banks = build_camera_bank(
        block_cams, frame, dev if device_data else torch.device("cpu"))
    step_fn = make_fleet_step_banked(
        ocfg, frame, use_appearance=cfg.pipeline.use_appearance,
        share_appearance=share, n_blocks=n_blocks)
    extents = [s.extent for s in block_scenes]
    background = torch.tensor(
        [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
        device=dev)

    rngs = [random.Random(seed + 17 * i) for i in gidx]
    stacks: List[List[int]] = [[] for _ in gidx]

    def pick(j: int) -> int:
        if not stacks[j]:
            stacks[j] = list(range(len(block_cams[j])))
            rngs[j].shuffle(stacks[j])
        return stacks[j].pop()

    loggers = [None] * n_local
    eval_cams = [[] for _ in range(n_local)]
    if block_dirs:
        for j, d in enumerate(block_dirs):
            os.makedirs(d, exist_ok=True)
            loggers[j] = loop.TrainLogger(d)
            cams = block_cams[j]
            eval_cams[j] = cams[::max(1, len(cams) // 3)][:3]

    def checkpoint_all(it):
        for j, st in enumerate(states):
            _save(os.path.join(block_dirs[j], FLEET_CKPT_NAME), st, it)
            if progress_fn:
                progress_fn(block_ids[j], status="running", ckpt_iter=it)

    tag = (f"fleet rank {pdist.rank()}/{pdist.world()}"
           if dist.is_initialized() else "fleet")
    # a rank without blocks and without sharing has no collective to join
    last = iterations if n_local or share else start_iter
    for it in range(start_iter + 1, last + 1):
        sh_degree = min(cfg.model.sh_degree, (it - 1) // 1000)
        metrics = step_fn(states, extents, banks,
                          [pick(j) for j in range(n_local)], background,
                          sh_degree, pos, shared, dev)

        # strict bounds, matching the reference cadence (train.py:140-152)
        if it < ocfg.densify_until_iter:
            if (it % ocfg.densification_interval == 0
                    and it > ocfg.densify_from_iter):
                for j in range(n_local):
                    states[j] = densify_impl(
                        states[j], generators[j], extents[j], ocfg=ocfg,
                        prune_big=it > ocfg.opacity_reset_interval)
            if it % ocfg.opacity_reset_interval == 0 or (
                    cfg.model.white_background
                    and it == ocfg.densify_from_iter):
                states = [opacity_reset_impl(st) for st in states]

        if block_dirs and checkpoint_interval and \
                it % checkpoint_interval == 0 and it < iterations:
            checkpoint_all(it)

        if block_dirs and it in cfg.test_iterations:
            for j, st in enumerate(states):
                if not eval_cams[j]:
                    continue
                m = loop.evaluate_cameras(st, eval_cams[j], sh_degree,
                                          background, ocfg)
                if log_fn:
                    log_fn(f"[eval {it}] {block_ids[j]} l1 {m['l1']:.4f} "
                           f"psnr {m['psnr']:.2f}")
                loggers[j].scalars(it, {"test/loss_viewpoint_l1": m["l1"],
                                        "test/loss_viewpoint_psnr":
                                            m["psnr"]})
                if progress_fn:
                    progress_fn(block_ids[j], eval_iter=it,
                                psnr=round(m["psnr"], 3))

        if block_dirs and it in cfg.save_iterations and it < iterations:
            for j, st in enumerate(states):
                loop.save_model(st, block_dirs[j], it,
                                f"{block_ids[j]}_point_cloud")

        if (it % 100 == 0 or it == 1) and n_local:
            losses = np.array([float(m["loss"]) for m in metrics])
            if log_fn:
                log_fn(f"{tag} iter {it:6d} mean loss {losses.mean():.5f}")
            for j, lg in enumerate(loggers):
                if lg:
                    lg.scalars(it, {
                        "train_loss_patches/total_loss": float(losses[j]),
                        "total_points": float(metrics[j]["n_visible"])})
            over = [gidx[j] for j, m in enumerate(metrics)
                    if bool(m["overflow"])]
            if over and log_fn:
                log_fn(f"[warn] fleet iter {it}: tile-pair overflow in "
                       f"blocks {over} (max n_pairs "
                       f"{max(int(m['n_pairs']) for m in metrics)}); "
                       "nearest Gaussians are kept but quality degrades "
                       "-- raise --pairs_per_gaussian")
            sat = [gidx[j] for j, m in enumerate(metrics)
                   if bool(m["tile_saturated"])]
            if sat and log_fn:
                log_fn(f"[warn] fleet iter {it}: per-tile saturation in "
                       f"blocks {sat} (densest tile "
                       f"{max(int(m['max_tile_load']) for m in metrics)} > "
                       f"max_per_tile={ocfg.max_per_tile}) -- raise "
                       "--max_per_tile")

    if block_dirs and checkpoint_interval:
        checkpoint_all(iterations)
    for lg in loggers:
        if lg:
            lg.close()
    return states
