"""Merge CLI — `python -m pcp_tpu_torch.cli.merge -m <model_dir>
[--device cpu]`.

Reference: seamless_merge(model_path, partition_point_cloud_dir)
(merge_partitions.py:111-170). Reads partition_data.pkl + per-block trained
PLYs, crops each block to its dynamic bounding box, concatenates, dedups,
writes <model_dir>/point_cloud.ply (the name Scene_Eval loads,
scene/__init__.py:218).

Counterpart of ``pcp_tpu/cli/merge.py``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--model_path", required=True,
                   help="dir containing partition_data.pkl")
    p.add_argument("--pc_dir", default=None,
                   help="dir of {id}_point_cloud.ply (default: collect from "
                        "split_result/visible/*/partition_*/output)")
    p.add_argument("--iteration", type=int, default=None,
                   help="training iteration to collect (default: latest)")
    p.add_argument("-o", "--output", default=None,
                   help="output PLY (default <model_path>/point_cloud.ply)")
    add_device_arg(p)
    args = p.parse_args(argv)

    from pcp_tpu_torch.device import resolve_device

    # the merge is host numpy; the flag keeps the port's device rule
    resolve_device(args.device)

    from pcp_tpu_torch.merge import seamless_merge
    from pcp_tpu_torch.partition.export import load_partition_data

    records = load_partition_data(
        os.path.join(args.model_path, "partition_data.pkl")
    )
    pc_dir = args.pc_dir or collect_block_plys(args.model_path, records,
                                               args.iteration)
    out = args.output or os.path.join(args.model_path, "point_cloud.ply")
    merged = seamless_merge(records, pc_dir, out)
    print(f"merged {len(merged['xyz'])} Gaussians -> {out}")
    return merged


def collect_block_plys(model_path: str, records, iteration=None) -> str:
    """Gather each block's trained PLY into one folder (the sever_code
    copyfile.py workflow, 代码说明.txt step 2). Scans
    split_result/visible/<id>/partition_<id>/output/point_cloud/."""
    import shutil

    from pcp_tpu_torch.utils.system import search_max_iteration

    dst = os.path.join(model_path, "merge_input")
    os.makedirs(dst, exist_ok=True)
    for rec in records:
        pid = rec.partition_id
        pc_root = os.path.join(
            model_path, "split_result", "visible", pid, f"partition_{pid}",
            "output", "point_cloud",
        )
        if not os.path.isdir(pc_root):
            print(f"[collect] no output for block {pid}, skipping")
            continue
        it = iteration or search_max_iteration(pc_root)
        src = os.path.join(pc_root, f"iteration_{it}", f"{pid}_point_cloud.ply")
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(dst, f"{pid}_point_cloud.ply"))
        else:
            print(f"[collect] missing {src}")
    return dst


if __name__ == "__main__":
    main()
