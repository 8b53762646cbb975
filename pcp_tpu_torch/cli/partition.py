"""Partition CLI — `python -m pcp_tpu_torch.cli.partition <sfm_path>
[--device cpu]`.

Reference: `python scene/ptgs/shen_partition_utils.py <sfm_path>`
(README.md:66-123). Outputs under `<sfm_path>/model/`:
split_result/visible/<id>/..., partition_data.pkl, plots, plus the held-out
`test/` COLMAP set.

Counterpart of ``pcp_tpu/cli/partition.py``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source_path", type=str)
    p.add_argument("--model_dir", type=str, default=None,
                   help="output dir (default <source_path>/model)")
    p.add_argument("--threshold", type=int, default=500_000,
                   help="points per block; 500k/200k/100k for 24/12/8 GB "
                        "tiers (README.md:90-99)")
    p.add_argument("--max_depth", type=int, default=10)
    p.add_argument("--expansion_distance", type=float, default=80.0)
    p.add_argument("--point_expand_ratio", type=float, default=0.10)
    p.add_argument("--visible_rate", type=float, default=None,
                   help="hull-area visibility threshold (default 0.45 for "
                        "bisect/quadtree, 0.25 for camera_grid — the two "
                        "reference generations' values)")
    p.add_argument("--partitioner",
                   choices=["bisect", "camera_grid", "quadtree"],
                   default="bisect",
                   help="bisect = live pipeline (shen_partition_utils.py); "
                        "camera_grid = VastGaussian m x n camera grid "
                        "(data_partition.py:35-557); quadtree = legacy "
                        "4-way splitter (shen_partition.py:40-788)")
    p.add_argument("--m_region", type=int, default=3)
    p.add_argument("--n_region", type=int, default=3)
    p.add_argument("--extend_rate", type=float, default=0.2)
    p.add_argument("--voxel_size", type=float, default=0.1)
    p.add_argument("--no_outlier_removal", action="store_true")
    p.add_argument("--no_plots", action="store_true")
    p.add_argument("--no_copy_images", action="store_true")
    p.add_argument("--llffhold", type=int, default=83)
    p.add_argument("--manhattan", action="store_true")
    p.add_argument("--platform", type=str, default="")
    p.add_argument("--pos", type=str, default="0 0 0")
    p.add_argument("--rot", type=str, default="0 0 0")
    add_device_arg(p)
    args = p.parse_args(argv)

    from pcp_tpu_torch.cli.common import man_trans_from_config
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.partition.pipeline import PartitionConfig, run_partition
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train.config import ModelConfig

    device = resolve_device(args.device)
    mc = ModelConfig(manhattan=args.manhattan, platform=args.platform,
                     pos=args.pos, rot=args.rot)
    scene = load_colmap_scene(
        args.source_path, man_trans=man_trans_from_config(mc),
        keep_point_ids=True,
    )
    model_dir = args.model_dir or os.path.join(args.source_path, "model")
    if args.visible_rate is None:
        args.visible_rate = 0.25 if args.partitioner == "camera_grid" else 0.45
    cfg = PartitionConfig(
        threshold=args.threshold,
        max_depth=args.max_depth,
        expansion_distance=args.expansion_distance,
        point_expand_ratio=args.point_expand_ratio,
        visible_rate=args.visible_rate,
        voxel_size=args.voxel_size,
        remove_outliers=not args.no_outlier_removal,
        make_plots=not args.no_plots,
        copy_images=not args.no_copy_images,
        llffhold=args.llffhold,
        partitioner=args.partitioner,
        m_region=args.m_region,
        n_region=args.n_region,
        extend_rate=args.extend_rate,
        device=str(device),
    )
    records = run_partition(scene, model_dir, cfg)
    for r in records:
        print(
            f"partition {r.partition_id}: {r.point_num} pts, "
            f"{len(r.camera_uids)} cameras"
        )
    print(f"wrote {len(records)} partitions under {model_dir}")
    return records


if __name__ == "__main__":
    main()
