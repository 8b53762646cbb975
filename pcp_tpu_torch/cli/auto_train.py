"""Batch-train all partition blocks — ``python -m
pcp_tpu_torch.cli.auto_train --base_path <model>/split_result/visible
[--device cpu]``.

Counterpart of ``pcp_tpu/cli/auto_train.py`` (reference auto_train.py:6-57,
which trains the blocks one after another as subprocesses on one GPU).
Modes, as in the JAX CLI:

- the fleet (default): every block at once (``parallel.fleet``), on one
  card, or on ``--n_devices N`` cards with one rank each, each rank
  training its slice of the blocks; ``--device_data`` keeps each block's
  cameras and uint8 GT on the card, ``--share_appearance`` trains one
  appearance net for all blocks, ``--fleet_checkpoint_interval`` writes
  each block's rolling ``output/chkpnt_fleet.pth``, which
  ``--retry_failed`` resumes;
- ``--sequential``: one block after another through
  ``train.loop.train_scene`` (``--checkpoint_iterations`` writes each
  block's ``output/chkpnt<N>.pth``);
- ``--intra_block N``: one block after another, each sharded over N
  ranks, one card each (``parallel.intra_block``); it takes precedence
  over ``--sequential``.

``--distributed`` runs under torchrun (``python -m torch.distributed.run
--nproc_per_node N -m pcp_tpu_torch.cli.auto_train --distributed ...``):
each rank joins the group torchrun describes and trains its own slice of
the blocks (with ``--intra_block N``, N must be the group's size and every
block is sharded over it); without torchrun's environment it trains as
one process. On the CPU (``--device cpu``) ranks are gloo processes.

Every mode writes ``{id}_point_cloud.ply`` into each block's
output/point_cloud/iteration_<N>/ (PartitionScene naming,
scene/__init__.py:167) and keeps a locked ``train_status.json`` manifest
that ``--retry_failed`` reads and that several ranks update together.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time


def find_blocks(base_path: str):
    """[(block_id, block_colmap_dir)] under split_result/visible
    (auto_train.py:22-34 walk)."""
    out = []
    for sub in sorted(os.listdir(base_path)):
        root = os.path.join(base_path, sub)
        if not os.path.isdir(root):
            continue
        for d in sorted(os.listdir(root)):
            if d.startswith("partition_") and os.path.isdir(os.path.join(root, d)):
                out.append((sub, os.path.join(root, d)))
    return out


def mark(manifest_path: str, bid: str, **kw) -> None:
    """Update block ``bid``'s manifest entry: a locked read-modify-write
    and an atomic replace, so several processes may update disjoint block
    entries of the same manifest (the shared filesystem is the
    coordination layer, like the reference's subprocess hand-off)."""
    import fcntl

    with open(manifest_path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        manifest = {}
        if os.path.exists(manifest_path):
            try:
                with open(manifest_path) as f:
                    manifest = json.load(f)
            except json.JSONDecodeError:
                pass  # torn file from a pre-lock writer
        manifest[bid] = {**manifest.get(bid, {}), **kw, "ts": time.time()}
        tmp = f"{manifest_path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
        os.replace(tmp, manifest_path)


def _out_dir(block_dir: str) -> str:
    return os.path.join(block_dir, "output")


def _block_cfg(cfg, block_dir: str):
    bcfg = copy.deepcopy(cfg)
    bcfg.model.model_path = _out_dir(block_dir)
    return bcfg


def _train_each(blocks, cfg, manifest_path, train, lead=True) -> None:
    """``train(scene, bcfg, save_name)`` for every block in turn; a failed
    block is marked and the rest go on (auto_train.py:50-51)."""
    from pcp_tpu_torch.scene import load_colmap_scene

    for bid, block_dir in blocks:
        try:
            scene = load_colmap_scene(block_dir)
            if lead:
                mark(manifest_path, bid, status="running")
            train(scene, _block_cfg(cfg, block_dir), f"{bid}_point_cloud")
            if lead:
                mark(manifest_path, bid, status="done")
        except Exception as e:
            print(f"block {bid} FAILED: {e}")
            if lead:
                mark(manifest_path, bid, status="failed", error=str(e))


def run_sequential(device, blocks, cfg, manifest_path) -> None:
    from pcp_tpu_torch.train.loop import train_scene

    _train_each(blocks, cfg, manifest_path, lambda scene, bcfg, name:
                train_scene(scene, bcfg, save_name=name, device=device))


def run_intra_block(device, blocks, cfg, manifest_path) -> None:
    """Every block sharded over the joined group, this rank's part."""
    from pcp_tpu_torch.parallel import distributed as pdist
    from pcp_tpu_torch.parallel.intra_block import train_scene_sharded

    lead = pdist.rank() == 0
    _train_each(blocks, cfg, manifest_path, lambda scene, bcfg, name:
                train_scene_sharded(scene, bcfg, save_name=name,
                                    log_fn=print if lead else None,
                                    device=device), lead)


def run_fleet(device, blocks, cfg, manifest_path, device_data: bool,
              checkpoint_interval: int, resume: bool,
              seed_index: list) -> None:
    """This rank's slice of the fleet (all of it without a group);
    ``seed_index[k]`` is block k's index among all the scene's blocks."""
    from pcp_tpu_torch.parallel import distributed as pdist
    from pcp_tpu_torch.parallel.fleet import train_blocks_parallel
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.loop import save_model

    sl = pdist.local_block_slice(len(blocks), pdist.rank(), pdist.world())
    mine = blocks[sl]
    scenes = []
    for bid, block_dir in mine:
        scenes.append(load_colmap_scene(block_dir))
        mark(manifest_path, bid, status="running")
    print(f"fleet: {len(mine)} of {len(blocks)} blocks [{sl.start}:"
          f"{sl.stop}) on rank {pdist.rank()} of {pdist.world()} ({device})")
    states = train_blocks_parallel(
        scenes, cfg, seed=cfg.seed, device_data=device_data,
        block_dirs=[_out_dir(d) for _, d in mine],
        block_ids=[bid for bid, _ in mine],
        progress_fn=lambda bid, **kw: mark(manifest_path, bid, **kw),
        checkpoint_interval=checkpoint_interval, resume=resume,
        block_offset=sl.start, n_blocks=len(blocks),
        seed_index=seed_index[sl], device=device)
    for (bid, block_dir), state in zip(mine, states):
        save_model(state, _out_dir(block_dir), cfg.optim.iterations,
                   f"{bid}_point_cloud")
        mark(manifest_path, bid, status="done")
    print(f"fleet training complete: {len(mine)} blocks on rank "
          f"{pdist.rank()}")


def main(argv=None) -> None:
    from pcp_tpu_torch.cli.common import (
        add_device_arg,
        add_model_args,
        add_optim_args,
        add_pipeline_args,
        config_from_args,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base_path", required=True,
                   help="<model>/split_result/visible")
    p.add_argument("--sequential", action="store_true",
                   help="train the blocks one after another")
    p.add_argument("--intra_block", type=int, default=0, metavar="N",
                   help="train the blocks one after another, each sharded "
                        "over N ranks, one card each (for blocks beyond "
                        "one card's memory; parallel/intra_block.py)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="the fleet's cards, one rank each (default 1)")
    p.add_argument("--device_data", action="store_true",
                   help="keep each block's cameras and uint8 GT on the "
                        "card; the host sends only camera indices a step")
    p.add_argument("--retry_failed", action="store_true",
                   help="only (re)train blocks not marked done in the "
                        "manifest; the fleet also resumes each block from "
                        "its rolling chkpnt_fleet.pth")
    p.add_argument("--fleet_checkpoint_interval", type=int, default=2000,
                   help="the fleet's per-block rolling checkpoint cadence "
                        "(0 disables)")
    p.add_argument("--distributed", action="store_true",
                   help="under torchrun: join its process group (RANK, "
                        "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) "
                        "and train this rank's slice of the blocks")
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=[],
                   help="--sequential: write each block's "
                        "output/chkpnt<N>.pth at these iterations "
                        "(cli.train --start_checkpoint resumes one)")
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7_000, 30_000],
                   help="score each block at these iterations (the fleet: "
                        "up to 3 of its training views)")
    add_model_args(p)
    add_optim_args(p)
    add_pipeline_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.parallel import distributed as pdist

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    cfg.checkpoint_iterations = args.checkpoint_iterations
    cfg.test_iterations = args.test_iterations
    blocks = find_blocks(args.base_path)
    if not blocks:
        raise SystemExit(f"no partition_* blocks under {args.base_path}")

    joined = False
    if args.distributed:
        rank_dev = pdist.initialize(device)
        joined = rank_dev is not None
        if joined:
            device = rank_dev
            print(f"distributed: rank {dist.get_rank()} of "
                  f"{dist.get_world_size()} on {device}")
        else:
            print("distributed: no torchrun environment (RANK, WORLD_SIZE, "
                  "LOCAL_RANK, MASTER_ADDR, MASTER_PORT); one process")

    manifest_path = os.path.join(args.base_path, "train_status.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    seed_index = list(range(len(blocks)))
    if args.retry_failed:
        left = [i for i, (bid, _) in enumerate(blocks)
                if manifest.get(bid, {}).get("status") != "done"]
        blocks, seed_index = [blocks[i] for i in left], left
        print(f"retrying {len(blocks)} unfinished blocks")

    try:
        if args.sequential and not args.intra_block:
            if joined:
                blocks = blocks[pdist.local_block_slice(
                    len(blocks), dist.get_rank(), dist.get_world_size())]
            run_sequential(device, blocks, cfg, manifest_path)
            return
        if args.intra_block:
            run, n = run_intra_block, args.intra_block
            job = (blocks, cfg, manifest_path)
        else:
            run, n = run_fleet, args.n_devices or 1
            job = (blocks, cfg, manifest_path, args.device_data,
                   args.fleet_checkpoint_interval, args.retry_failed,
                   seed_index)
        if not joined and n > 1:
            if device.type == "cuda" and n > torch.cuda.device_count():
                raise SystemExit(f"{n} ranks need {n} cards; "
                                 f"{torch.cuda.device_count()} are visible")
            pdist.spawn(run, n, device, *job)
        elif run is run_intra_block:
            # a group even for one rank: the sharded step's collectives
            with pdist.group_of(device, n):
                run(device, *job)
        else:
            run(device, *job)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
