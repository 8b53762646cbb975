"""Batch-train all partition blocks — ``python -m
pcp_tpu_torch.cli.auto_train --base_path <model>/split_result/visible
--sequential [--device cpu]``.

Counterpart of ``pcp_tpu/cli/auto_train.py`` (reference auto_train.py:6-57,
which trains the blocks one after another as subprocesses on one GPU). The
sequential path trains every block in turn on the card through
``train.loop.train_scene``, writing ``{id}_point_cloud.ply`` into each
block's output/point_cloud/iteration_<N>/ (PartitionScene naming,
scene/__init__.py:167) and a locked ``train_status.json`` manifest that
``--retry_failed`` reads; ``--checkpoint_iterations`` writes each block's
``output/chkpnt<N>.pth``. The other flags are the JAX CLI's; its multi-device
modes (the default fleet, ``--intra_block``, ``--distributed``) wait for
ROADMAP A5 and exit with a message instead of training another way.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

MULTI_GPU = ("not ported yet (ROADMAP A5, multi-GPU): pass --sequential to "
             "train the blocks one after another on one card")


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
                   help="train the blocks one after another on one card "
                        "(the only mode ported so far)")
    p.add_argument("--intra_block", type=int, default=0, metavar="N",
                   help="shard each block over N cards (ROADMAP A5)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="the fleet's card count (ROADMAP A5)")
    p.add_argument("--device_data", action="store_true",
                   help="the fleet's device-resident camera banks "
                        "(ROADMAP A5)")
    p.add_argument("--retry_failed", action="store_true",
                   help="only (re)train blocks not marked done in the "
                        "manifest")
    p.add_argument("--fleet_checkpoint_interval", type=int, default=2000,
                   help="the fleet's rolling checkpoint cadence (ROADMAP A5)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host block slices (ROADMAP A5)")
    p.add_argument("--checkpoint_iterations", nargs="+", type=int,
                   default=[],
                   help="write each block's output/chkpnt<N>.pth at these "
                        "iterations (cli.train --start_checkpoint resumes "
                        "one)")
    add_model_args(p)
    add_optim_args(p)
    add_pipeline_args(p)
    add_device_arg(p)
    args = p.parse_args(argv)

    if args.intra_block:
        raise SystemExit(f"--intra_block is {MULTI_GPU}")
    if args.distributed:
        raise SystemExit(f"--distributed is {MULTI_GPU}")
    if not args.sequential:
        raise SystemExit(f"the fleet mode (no --sequential) is {MULTI_GPU}")

    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.loop import train_scene

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    cfg.checkpoint_iterations = args.checkpoint_iterations
    blocks = find_blocks(args.base_path)
    if not blocks:
        raise SystemExit(f"no partition_* blocks under {args.base_path}")

    manifest_path = os.path.join(args.base_path, "train_status.json")
    manifest = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    if args.retry_failed:
        blocks = [
            (bid, d) for bid, d in blocks
            if manifest.get(bid, {}).get("status") != "done"
        ]
        print(f"retrying {len(blocks)} unfinished blocks")

    def mark(bid, **kw):
        # locked read-modify-write + atomic replace: several processes may
        # update disjoint block entries of the same manifest (the shared
        # filesystem is the coordination layer, like the reference's
        # auto_train subprocess hand-off)
        import fcntl

        with open(manifest_path + ".lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            if os.path.exists(manifest_path):
                try:
                    with open(manifest_path) as f:
                        manifest.update({
                            k: v for k, v in json.load(f).items()
                            if k != bid
                        })
                except json.JSONDecodeError:
                    pass  # torn file from a pre-lock writer; keep our view
            manifest[bid] = {**manifest.get(bid, {}), **kw,
                             "ts": time.time()}
            tmp = f"{manifest_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=2)
            os.replace(tmp, manifest_path)

    for bid, block_dir in blocks:
        try:
            scene = load_colmap_scene(block_dir)
            bcfg = copy.deepcopy(cfg)
            bcfg.model.model_path = os.path.join(block_dir, "output")
            mark(bid, status="running")
            train_scene(scene, bcfg, save_name=f"{bid}_point_cloud",
                        device=device)
            mark(bid, status="done")
        except Exception as e:  # keep going like auto_train.py:50-51
            print(f"block {bid} FAILED: {e}")
            mark(bid, status="failed", error=str(e))


if __name__ == "__main__":
    main()
