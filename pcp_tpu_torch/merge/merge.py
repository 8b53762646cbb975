"""Cut & merge trained blocks into a single scene.

Reference behaviours reproduced:
- `seamless_merge` (merge_partitions.py:111-170): for each partition load its
  trained Gaussian PLY, crop to a *dynamic* bounding box — the original
  bisection cell, but unbounded on sides with no adjacent block — then concat
  all blocks and dedup Gaussians by exact xyz (np.unique), save one
  point_cloud.ply.
- `dynamic_bounding_box` (merge_partitions.py:10-57).
- `cut_partition` (cut_partition.py:50-139): crop one block to its origin box
  -> cutor_pcd.ply.
- server toolbox (scene/sever_code/): folder merge + X-midpoint split.

All host-side numpy (pure I/O-bound; SURVEY §7 step 7).

Counterpart of ``pcp_tpu/merge/merge.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from pcp_tpu_torch.io.ply import load_gaussian_ply, save_gaussian_ply
from pcp_tpu_torch.partition.density import find_adjacent
from pcp_tpu_torch.partition.types import Box2D, PartitionRecord


def dynamic_bounding_box(records: Sequence[PartitionRecord], i: int) -> Box2D:
    """Origin box of block i with sides that face no neighbour opened up
    (so boundary blocks keep their overhang Gaussians)."""
    boxes = [r.origin_box for r in records]
    me = boxes[i]
    adj = [boxes[j] for j in find_adjacent(boxes, i)]
    eps = 1e-9

    def has_side(pred) -> bool:
        return any(pred(b) for b in adj)

    return Box2D(
        me.xmin if has_side(lambda b: abs(b.xmax - me.xmin) < eps) else None,
        me.ymin if has_side(lambda b: abs(b.ymax - me.ymin) < eps) else None,
        me.xmax if has_side(lambda b: abs(b.xmin - me.xmax) < eps) else None,
        me.ymax if has_side(lambda b: abs(b.ymin - me.ymax) < eps) else None,
    )


def _crop(gauss: Dict[str, np.ndarray], box: Box2D) -> Dict[str, np.ndarray]:
    mask = box.contains(gauss["xyz"][:, :2])
    return {k: v[mask] for k, v in gauss.items()}


def _concat(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = parts[0].keys()
    return {k: np.concatenate([p[k] for p in parts], axis=0) for k in keys}


def _dedup_by_xyz(gauss: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """np.unique on xyz rows (merge_partitions.py:145-158)."""
    _, idx = np.unique(gauss["xyz"], axis=0, return_index=True)
    idx = np.sort(idx)
    return {k: v[idx] for k, v in gauss.items()}


def seamless_merge(
    records: Sequence[PartitionRecord],
    point_cloud_dir: str,
    out_path: str,
    ply_name_fmt: str = "{pid}_point_cloud.ply",
) -> Dict[str, np.ndarray]:
    """Merge trained block PLYs from ``point_cloud_dir`` into ``out_path``.

    Missing block PLYs are skipped with a warning (merge_partitions.py:
    127-129). Returns the merged arrays.
    """
    parts: List[Dict[str, np.ndarray]] = []
    for i, rec in enumerate(records):
        p = os.path.join(point_cloud_dir, ply_name_fmt.format(pid=rec.partition_id))
        if not os.path.exists(p):
            print(f"[merge] missing block PLY, skipping: {p}")
            continue
        gauss = load_gaussian_ply(p)
        box = dynamic_bounding_box(records, i)
        parts.append(_crop(gauss, box))
    if not parts:
        raise FileNotFoundError(f"no block PLYs found under {point_cloud_dir}")
    merged = _dedup_by_xyz(_concat(parts))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_gaussian_ply(
        out_path, merged["xyz"], merged["f_dc"], merged["f_rest"],
        merged["opacity"], merged["scaling"], merged["rotation"],
    )
    return merged


def cut_partition(
    ply_path: str,
    box: Box2D,
    out_path: Optional[str] = None,
    *,
    knn_prefilter: bool = False,
    min_neighbors: int = 10,
    radius: float = 0.1,
) -> Dict[str, np.ndarray]:
    """Crop a trained block to its (unexpanded) cell -> cutor_pcd.ply
    (cut_partition.py:59-83). ``knn_prefilter`` additionally drops isolated
    Gaussians first (the KDTree radius-count filter of ktree_point.py:50-89,
    min_neighbors=10, radius=0.1) via the grid-hash neighbour counter."""
    gauss = load_gaussian_ply(ply_path)
    if knn_prefilter:
        from pcp_tpu_torch.partition.points import radius_outlier_removal

        keep = radius_outlier_removal(
            gauss["xyz"], nb_points=min_neighbors, radius=radius
        )
        gauss = {k: v[keep] for k, v in gauss.items()}
    gauss = _crop(gauss, box)
    if out_path:
        save_gaussian_ply(
            out_path, gauss["xyz"], gauss["f_dc"], gauss["f_rest"],
            gauss["opacity"], gauss["scaling"], gauss["rotation"],
        )
    return gauss


def merge_ply_files(ply_dir: str, out_path: str) -> Dict[str, np.ndarray]:
    """Concat + dedup every .ply in a folder (sever_code/
    merge_partitions.py:54-106)."""
    parts = [
        load_gaussian_ply(os.path.join(ply_dir, f))
        for f in sorted(os.listdir(ply_dir))
        if f.endswith(".ply")
    ]
    if not parts:
        raise FileNotFoundError(f"no .ply files in {ply_dir}")
    merged = _dedup_by_xyz(_concat(parts))
    save_gaussian_ply(
        out_path, merged["xyz"], merged["f_dc"], merged["f_rest"],
        merged["opacity"], merged["scaling"], merged["rotation"],
    )
    return merged


def split_gaussians_by_x_midpoint(ply_path: str, out_dir: str) -> None:
    """Halve a Gaussian PLY at the bbox X midpoint (sever_code/
    split_GS.py:54-123) -> part1.ply / part2.ply."""
    gauss = load_gaussian_ply(ply_path)
    mid = 0.5 * (gauss["xyz"][:, 0].min() + gauss["xyz"][:, 0].max())
    os.makedirs(out_dir, exist_ok=True)
    for name, mask in (
        ("part1.ply", gauss["xyz"][:, 0] <= mid),
        ("part2.ply", gauss["xyz"][:, 0] > mid),
    ):
        g = {k: v[mask] for k, v in gauss.items()}
        save_gaussian_ply(
            os.path.join(out_dir, name), g["xyz"], g["f_dc"], g["f_rest"],
            g["opacity"], g["scaling"], g["rotation"],
        )
