"""Intra-block parallelism: one block's Gaussians sharded over the ranks of
a process group (counterpart of ``pcp_tpu/parallel/intra_block.py``).

Each of the D ranks (one card each) holds C/D of the block's slots: their
parameters, Adam moments, densify stats and ``alive`` (ZeRO: nothing
Gaussian is replicated). A step:

  forward: preprocess runs on the rank's C/D slots; their attribute rows
  (the composite's (n, 9) pack of means2d, conic, rgb and opacity, plus
  depths and tile rects) are all-gathered; each rank bins and composites
  its own band of tile rows (rects clamped to the band, means2d shifted
  into it; the sort key keeps the whole frame's depth precision, so every
  band tile lists the same Gaussians in the same order as the whole-frame
  tile); the bands are all-gathered into the image, and every rank
  computes L1 and D-SSIM on the whole image and the replicated appearance
  net on it.

  backward: the image gather hands each rank its own band's slice of the
  gradient (every rank computes the same loss, so a sum would count it D
  times); the attribute gather's backward sums the ranks' gradients of
  the rank's rows in rank order (an all-to-all, so each rank receives
  only its own rows from every rank, and a fixed-order sum: gloo has no
  reduce-scatter, and this keeps the bits from run to run).

Adam runs on the rank's shard; the appearance net's gradients are the same
on every rank, so its replicated Adam stays in lockstep. Densify runs
shard-local: clones and splits land in free slots of the same shard, with
a per-rank generator (rank 0 draws from the block's seed generator, as
``train_scene`` does, rank r > 0 from ``seed + r``), so slots are balanced
once at the start (``balance_for_sharding``). Every D runs the same
code: at D = 1 the gathers are copies within a one-rank group, and the
step is the single-card step bit for bit.

Not ported: the JAX trainer's ``max_per_tile`` autosize and re-tune.
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.ops.binning import bin_gaussians
from pcp_tpu_torch.ops.preprocess_fwd import preprocess_params_plain
from pcp_tpu_torch.ops.projection import TILE, CameraIntrin
from pcp_tpu_torch.ops.rasterize import Blend, untile
from pcp_tpu_torch.parallel import distributed as pdist
from pcp_tpu_torch.scene import cameras as cam_mod
from pcp_tpu_torch.scene.dataset import split_train_test
from pcp_tpu_torch.train import checkpoint as ckpt
from pcp_tpu_torch.train import loop
from pcp_tpu_torch.train.config import save_cfg_args
from pcp_tpu_torch.train.step import (
    TrainState,
    densify_impl,
    opacity_reset_impl,
    train_step_impl,
)
from pcp_tpu_torch.utils.image import psnr

SHARDED_CKPT_NAME = "chkpnt_sharded.pth"


def sharding_permutation(alive, d: int) -> np.ndarray:
    """The slot permutation of JAX ``balance_for_sharding``: alive slots
    dealt round-robin over the d shards, each shard filled up with dead
    slots, so every shard has free slots to densify into."""
    alive_np = np.asarray(alive, bool)
    c = alive_np.shape[0]
    per = c // d
    if per * d != c:
        raise ValueError(f"capacity {c} must divide the {d}-way sharding")
    a_idx = np.flatnonzero(alive_np)
    dead_q = np.flatnonzero(~alive_np)
    buckets = [list(a_idx[s::d]) for s in range(d)]
    perm, di = [], 0
    for s in range(d):
        need = per - len(buckets[s])
        assert need >= 0
        buckets[s].extend(dead_q[di:di + need])
        di += need
        perm.extend(buckets[s])
    return np.asarray(perm, dtype=np.int64)


def balance_for_sharding(params, alive, d: int):
    """(params, alive) with the capacity axis permuted by
    ``sharding_permutation``; numpy arrays or tensors."""
    perm = sharding_permutation(
        alive.cpu().numpy() if torch.is_tensor(alive) else alive, d)

    def take(x):
        if torch.is_tensor(x):
            return x[torch.as_tensor(perm, device=x.device)]
        return np.asarray(x)[perm]

    return {k: take(v) for k, v in params.items()}, take(alive)


def _gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (bool as
    uint8: gloo gathers no bool)."""
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(pdist.world())]
    dist.all_gather(parts, y)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


class _GatherRows(torch.autograd.Function):
    """(n, k) rows of every rank -> (D n, k). Backward: this rank's rows of
    every rank's gradient, summed in rank order."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return _gather_cat(x)

    @staticmethod
    def backward(ctx, g):
        # chunk j of g goes to rank j; parts[i] is rank i's gradient of
        # this rank's rows
        parts = torch.empty_like(g)
        dist.all_to_all_single(parts, g.contiguous())
        parts = parts.split(ctx.n)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc


class _GatherBands(torch.autograd.Function):
    """(band_h, W, 3) band of every rank -> (D band_h, W, 3). Backward: the
    rank's own band of the gradient (each rank holds the whole loss)."""

    @staticmethod
    def forward(ctx, band):
        ctx.band_h = band.shape[0]
        return _gather_cat(band)

    @staticmethod
    def backward(ctx, g):
        r, bh = pdist.rank(), ctx.band_h
        return g[r * bh:(r + 1) * bh].contiguous()


def sharded_render(params, alive, viewmat, intrin: CameraIntrin, image_size,
                   background, sh_degree: int, *, max_per_tile: int = 1024,
                   means2d_offset=None, device: DeviceLike = None):
    """``render_gaussians`` over the ranks of the joined group, each holding
    a shard of the slots: returns the whole (H, W, 3) image on every rank
    and this shard's aux (radii, visible) with this band's binning stats.
    Every rank of the joined group (one rank too) must call it together."""
    dev = resolve_device(device)
    w, h = int(image_size[0]), int(image_size[1])
    d, r = pdist.world(), pdist.rank()
    tiles_x = (w + TILE - 1) // TILE
    tiles_y = (h + TILE - 1) // TILE
    band_rows = (tiles_y + d - 1) // d
    r0 = r * band_rows
    prep, pack = preprocess_params_plain(params, alive, viewmat, intrin,
                                         (w, h), sh_degree,
                                         means2d_offset=means2d_offset)
    depths, rect = prep["depths"].detach(), prep["rect"]
    pack = _GatherRows.apply(pack)
    depths, rect = _gather_cat(depths), _gather_cat(rect)
    if r0:
        shift = torch.zeros(pack.shape[1], dtype=pack.dtype, device=dev)
        shift[1] = r0 * TILE
        pack = pack - shift
    y0 = torch.clamp(rect[:, 1] - r0, 0, band_rows)
    y1 = torch.clamp(rect[:, 3] - r0, 0, band_rows)
    band_rect = torch.stack([rect[:, 0], y0, rect[:, 2], y1], dim=1)
    bins = bin_gaussians(band_rect, depths, tiles_x, band_rows, max_per_tile,
                         key_tiles=tiles_x * tiles_y)
    color, t_fin = Blend.apply(pack, bins, tiles_x)
    band_h = band_rows * TILE
    color_img = untile(color, tiles_x, band_rows, w, band_h)
    t_img = untile(t_fin[:, None, :], tiles_x, band_rows, w, band_h)[..., 0]
    band = color_img + t_img[..., None] * torch.as_tensor(
        background, dtype=torch.float32, device=dev).reshape(1, 1, 3)
    image = _GatherBands.apply(band)[:h]
    aux = {"radii": prep["radii"], "visible": prep["visible"],
           "n_pairs": bins.n_pairs, "max_tile_load": bins.max_tile_load,
           "n_dropped": bins.n_dropped}
    return image, aux


def shard_state(state: TrainState, d: int, r: int) -> TrainState:
    """Rank r's C/d slots of every per-slot leaf (copies); the appearance,
    its Adam state and the Adam counts are shared as they are."""
    c = state.alive.shape[0]
    sl = slice(r * c // d, (r + 1) * c // d)
    cut = lambda t: t[sl].clone()  # noqa: E731
    opt_g = {m: {k: [cut(t) for t in v] for k, v in state.opt_g[m].items()}
             for m in ("mu", "nu")}
    opt_g["count"] = state.opt_g["count"]
    return TrainState({k: cut(v) for k, v in state.params.items()},
                      state.app, opt_g, state.opt_a, cut(state.alive),
                      {k: cut(v) for k, v in state.stats.items()})


def gather_state(state: TrainState) -> TrainState:
    """The whole block's state from every rank's shard, on every rank
    (copies, at D = 1 too)."""
    opt_g = {m: {k: [_gather_cat(t) for t in v]
                 for k, v in state.opt_g[m].items()} for m in ("mu", "nu")}
    opt_g["count"] = state.opt_g["count"]
    return TrainState({k: _gather_cat(v) for k, v in state.params.items()},
                      state.app, opt_g, state.opt_a,
                      _gather_cat(state.alive),
                      {k: _gather_cat(v) for k, v in state.stats.items()})


def train_scene_sharded(
    scene,
    cfg,
    *,
    save_name: str = "point_cloud",
    log_fn: Optional[Callable[[str], None]] = print,
    checkpoint_every: int = 2000,
    resume: bool = True,
    log_interval: int = 100,
    device: DeviceLike = None,
) -> TrainState:
    """Train one block sharded over the joined process group (every rank
    calls it) with the reference cadence: the densify window and interval,
    the opacity reset and the SH warm-up (JAX ``train_scene_sharded``).
    Every ``checkpoint_every`` iterations rank 0 writes the whole state to
    ``chkpnt_sharded.pth`` (after the slot balancing, so a resume shards
    it directly), and ``resume`` restarts from it. Held-out views (with
    ``cfg.model.eval``) are scored at ``cfg.test_iterations`` through the
    sharded renderer; rank 0 logs to a ``TrainLogger`` and writes
    ``cfg_args.json`` and the final PLY. Returns the whole state."""
    dev = resolve_device(device)
    d, r = pdist.world(), pdist.rank()
    ocfg = cfg.optim
    if ocfg.capacity % d:
        raise ValueError(f"capacity {ocfg.capacity} must divide the "
                         f"{d}-way sharding")
    model_path = cfg.model.model_path
    lead = r == 0
    if lead:
        os.makedirs(model_path, exist_ok=True)
        save_cfg_args(model_path, cfg)
    ckpt_path = os.path.join(model_path, SHARDED_CKPT_NAME)

    train_infos, test_infos = split_train_test(
        scene.cameras, cfg.model.eval, cfg.model.llffhold,
        explicit_test=scene.test_camera_uids)
    cams = [cam_mod.from_info(i, cfg.model.resolution) for i in train_infos]
    sizes = sorted({(c.width, c.height) for c in cams})
    if len(sizes) != 1:
        raise ValueError(f"intra-block path: one camera resolution per "
                         f"block, not {sizes}")
    w, h = sizes[0]
    test_cams = [c for c in (cam_mod.from_info(i, cfg.model.resolution)
                             for i in test_infos)
                 if (c.width, c.height) == (w, h)]

    generator = torch.Generator().manual_seed(cfg.seed)
    full = loop.init_state(scene, cfg, generator, dev)
    start_iter = 0
    if resume and os.path.exists(ckpt_path):
        full, start_iter = ckpt.load(ckpt_path, full)
        if log_fn and lead:
            log_fn(f"[sharded x{d}] resumed {ckpt_path} @ iter {start_iter}")
    else:
        full.params, full.alive = balance_for_sharding(full.params,
                                                       full.alive, d)
    state = shard_state(full, d, r)
    del full
    if r > 0:
        generator = torch.Generator().manual_seed(cfg.seed + r)

    background = torch.tensor(
        [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0],
        device=dev)
    gt_dev: Dict[int, torch.Tensor] = {}

    def gt_of(cam):
        buf = gt_dev.get(cam.uid)
        if buf is None:
            img = np.asarray(cam.gt_image)
            if img.dtype != np.uint8 and img.min() >= 0.0 and img.max() <= 1.0:
                img = np.round(img * 255.0).astype(np.uint8)
            buf = gt_dev.setdefault(cam.uid, torch.as_tensor(img, device=dev))
        return buf

    def eval_tests(st, sh_degree):
        l1s, psnrs = [], []
        with torch.no_grad():
            for cam in test_cams:
                viewmat, intrin = cam_mod.camera_tensors(cam, dev)
                img, _ = sharded_render(
                    st.params, st.alive, viewmat, intrin, (w, h), background,
                    sh_degree, max_per_tile=ocfg.tile_clamp(), device=dev)
                img = torch.clamp(img, 0.0, 1.0)[None]
                gt = torch.as_tensor(cam.gt_image, device=dev)[None]
                l1s.append(float(torch.abs(img - gt).mean()))
                psnrs.append(float(psnr(img, gt)[0]))
        return {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}

    logger = loop.TrainLogger(model_path) if lead else None
    rng = random.Random(cfg.seed + start_iter)
    stack = []
    for it in range(start_iter + 1, ocfg.iterations + 1):
        if not stack:
            stack = list(range(len(cams)))
            rng.shuffle(stack)
        cam = cams[stack.pop()]
        sh_degree = min(cfg.model.sh_degree, (it - 1) // 1000)
        viewmat, intrin = cam_mod.camera_tensors(cam, dev)
        state, metrics = train_step_impl(
            state, viewmat, intrin, gt_of(cam), cam.uid, background,
            scene.extent, ocfg=ocfg, image_size=(w, h), sh_degree=sh_degree,
            use_appearance=cfg.pipeline.use_appearance, render=sharded_render)
        # strict bounds, matching the reference cadence (train.py:140-152)
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
            n_alive = pdist.allreduce_int(int(state.alive.sum()), dev)
            load = pdist.allreduce_int(
                int(metrics["max_tile_load"]) > ocfg.tile_clamp(), dev)
            loss = float(metrics["loss"])
            if lead:
                logger.scalars(it, {"train_loss_patches/total_loss": loss,
                                    "total_points": n_alive})
                if log_fn:
                    log_fn(f"[sharded x{d}] iter {it:6d} loss {loss:.5f} "
                           f"alive {n_alive}")
                    if load:
                        log_fn(f"[warn] sharded iter {it}: per-tile "
                               f"saturation in {load} band(s) "
                               f"(max_per_tile={ocfg.max_per_tile})")
        if checkpoint_every and it % checkpoint_every == 0:
            whole = gather_state(state)
            if lead:
                tmp = ckpt_path + ".tmp"
                ckpt.save(tmp, whole, it)
                os.replace(tmp, ckpt_path)
            del whole
        if it in cfg.test_iterations and test_cams:
            m = eval_tests(state, sh_degree)
            if lead:
                logger.scalars(it, {"test/loss_viewpoint_l1": m["l1"],
                                    "test/loss_viewpoint_psnr": m["psnr"]})
                with open(os.path.join(model_path, f"eval_{it}.json"),
                          "w") as f:
                    json.dump(m, f)
                if log_fn:
                    log_fn(f"[sharded x{d}] [eval {it}] test l1 "
                           f"{m['l1']:.4f} psnr {m['psnr']:.2f}")

    whole = gather_state(state)
    if lead:
        loop.save_model(whole, model_path, ocfg.iterations, save_name)
        logger.close()
    return whole
