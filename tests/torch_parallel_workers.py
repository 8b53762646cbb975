"""Helpers of the port's multi-rank CPU tests (``tests/test_torch_fleet.py``,
``test_torch_distributed.py`` and ``test_torch_intra_block.py``): the
partitioned scene they train, and the
rank functions that ``pcp_tpu_torch.parallel.distributed.spawn`` runs in
new processes. Torch only, so a rank starts without importing JAX."""

from __future__ import annotations

import os

import numpy as np
import torch

PARTITION_FLAGS = ["--threshold", "40", "--expansion_distance", "10",
                   "--visible_rate", "0.05", "--no_outlier_removal",
                   "--no_plots", "--llffhold", "6"]
# auto_train's flags for the partitioned scene: 8 steps a block, one
# densify (at 6) and full-resolution views
BLOCK_ITERS = 8
TRAIN_FLAGS = ["--iterations", str(BLOCK_ITERS), "--capacity", "512",
               "--max_per_tile", "128", "--densify_from_iter", "3",
               "--densification_interval", "3", "--resolution", "1",
               "--device", "cpu"]
INTRA_CAPACITY = 128


def partitioned_scene(root: str) -> str:
    """``tests/test_fleet.py``'s scene (120 points, 8 cameras at 64x48)
    partitioned into 4 blocks of ~37 points under ``root``; returns the
    blocks' ``split_result/visible`` directory."""
    from tests.synthetic import write_synthetic_scene

    write_synthetic_scene(root, np.random.default_rng(11), n_points=120,
                          n_cams=8)
    return partition_scene(root)


def partition_scene(root: str) -> str:
    """``cli.partition`` of the scene at ``root`` with PARTITION_FLAGS;
    returns its ``split_result/visible`` directory."""
    from pcp_tpu_torch.cli import partition

    partition.main([root, *PARTITION_FLAGS, "--device", "cpu"])
    return os.path.join(root, "model", "split_result", "visible")


def block_plys(visible: str, iteration: int = BLOCK_ITERS) -> dict:
    """{block id: final PLY bytes or None} of every block under
    ``visible``."""
    out = {}
    for b in sorted(os.listdir(visible)):
        if not os.path.isdir(os.path.join(visible, b)):
            continue
        p = os.path.join(visible, b, f"partition_{b}", "output",
                         "point_cloud", f"iteration_{iteration}",
                         f"{b}_point_cloud.ply")
        out[b] = open(p, "rb").read() if os.path.exists(p) else None
    return out


def intra_cfg(capacity: int = INTRA_CAPACITY):
    from pcp_tpu_torch.train import config as tcfg

    return tcfg.TrainRunConfig(
        model=tcfg.ModelConfig(sh_degree=3, resolution=1),
        optim=tcfg.OptimConfig(capacity=capacity, max_per_tile=128),
        pipeline=tcfg.PipelineConfig(use_appearance=True))


def intra_state(scene_dir: str, d: int, capacity: int = INTRA_CAPACITY):
    """The block the intra-block tests train: the scene's points in
    ``capacity`` slots, seeded anisotropy, rotations and view-dependent
    colour (as ``tests/test_torch_train.py`` gives them), the appearance
    from seed 4, slots balanced for a d-way sharding. Returns (scene,
    cameras, whole state)."""
    from pcp_tpu_torch.parallel.intra_block import balance_for_sharding
    from pcp_tpu_torch.scene import cameras as tcam
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.loop import init_state

    scene = load_colmap_scene(scene_dir)
    cams = [tcam.from_info(i, 1) for i in scene.cameras]
    state = init_state(scene, intra_cfg(capacity),
                       torch.Generator().manual_seed(4), "cpu")
    rng = np.random.default_rng(12)
    n = int(state.alive.sum())
    with torch.no_grad():
        p = state.params
        p["scaling"][:n] += torch.from_numpy(
            rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32))
        p["rotation"][:n] = torch.from_numpy(
            rng.normal(size=(n, 4)).astype(np.float32))
        p["f_rest"][:n] = torch.from_numpy(rng.normal(
            0, 0.1, tuple(p["f_rest"][:n].shape)).astype(np.float32))
    state.params, state.alive = balance_for_sharding(state.params,
                                                     state.alive, d)
    return scene, cams, state


def gt_u8(cam) -> torch.Tensor:
    return torch.from_numpy(np.round(cam.gt_image * 255.0).astype(np.uint8))


def intra_rank(dev, scene_dir: str, out_path: str, steps: int) -> None:
    """One rank of the intra-block parity test: the sharded render of view
    0, then ``steps`` sharded train steps over views 0, 1, ...; rank 0
    saves the image, the losses and the whole state's params to
    ``out_path``."""
    from pcp_tpu_torch.parallel import distributed as pdist
    from pcp_tpu_torch.parallel.intra_block import (
        gather_state,
        shard_state,
        sharded_render,
    )
    from pcp_tpu_torch.scene import cameras as tcam
    from pcp_tpu_torch.train.step import train_step_impl

    d, r = pdist.world(), pdist.rank()
    scene, cams, full = intra_state(scene_dir, d)
    state = shard_state(full, d, r)
    bg = torch.zeros(3)
    ocfg = intra_cfg().optim
    size = (cams[0].width, cams[0].height)
    with torch.no_grad():
        vm, intr = tcam.camera_tensors(cams[0], dev)
        image, _ = sharded_render(state.params, state.alive, vm, intr, size,
                                  bg, 3, max_per_tile=128, device=dev)
    losses = []
    for i in range(steps):
        cam = cams[i % len(cams)]
        vm, intr = tcam.camera_tensors(cam, dev)
        state, m = train_step_impl(
            state, vm, intr, gt_u8(cam), cam.uid, bg, scene.extent,
            ocfg=ocfg, image_size=size, sh_degree=3, use_appearance=True,
            render=sharded_render)
        losses.append(float(m["loss"]))
    whole = gather_state(state)
    if r == 0:
        torch.save({"image": image, "losses": losses,
                    "params": whole.params, "alive": whole.alive,
                    "embeddings": whole.app["embeddings"]}, out_path)
