"""Legacy quadtree partitioner family (numpy AABB redesign).

Reference: scene/ptgs/shen_partition.py:40-788 — the first-generation
partitioner the bisection pipeline superseded:

- ``quad_tree_partition`` (:40-83): recursive 4-way split at the bbox
  center until a region holds <= threshold points; child ids append the
  quadrant digit (0=SW, 1=SE, 2=NW, 3=NE).
- ``filter_partitions_by_point_count`` (:105-163): drop regions under
  ``min_threshold`` points, then regions under the MEAN count greedily
  merge with their smallest-count adjacent region (recursively,
  :84-103) unless the union would exceed ``threshold_value``.
- ``merge_partitions`` (:188-218): the union region; ids join as "a-b".
- ``expand_partitions`` (:232-274): buffer by diagonal * rate / 2.

Shapely polygons are replaced by ``Region`` = a list of axis-aligned
``Box2D`` cells (quadtree unions are exactly unions of cells), so the whole
module is numpy-only and picklable like the rest of pcp_tpu_torch.partition.

Counterpart of ``pcp_tpu/partition/quadtree.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pcp_tpu_torch.partition.types import Box2D

MIN_THRESHOLD = 10  # shen_partition.py:105 default


@dataclass
class Region:
    """A quadtree region: one or more non-overlapping AABB cells."""

    region_id: str
    boxes: List[Box2D]
    point_indices: np.ndarray
    point_num: int = 0
    extend_boxes: List[Box2D] = field(default_factory=list)
    extend_rate: float = 0.0

    def __post_init__(self):
        self.point_num = int(len(self.point_indices))

    def contains(self, xy: np.ndarray) -> np.ndarray:
        m = np.zeros(len(xy), bool)
        for b in self.boxes:
            m |= b.contains(xy)
        return m

    @property
    def bounds(self) -> Box2D:
        return Box2D(
            min(b.xmin for b in self.boxes),
            min(b.ymin for b in self.boxes),
            max(b.xmax for b in self.boxes),
            max(b.ymax for b in self.boxes),
        )


def _boxes_adjacent(a: Box2D, b: Box2D, eps: float = 1e-9) -> bool:
    if (abs(a.xmax - b.xmin) < eps or abs(a.xmin - b.xmax) < eps) and (
        min(a.ymax, b.ymax) - max(a.ymin, b.ymin) > eps
    ):
        return True
    return (abs(a.ymax - b.ymin) < eps or abs(a.ymin - b.ymax) < eps) and (
        min(a.xmax, b.xmax) - max(a.xmin, b.xmin) > eps
    )


def regions_adjacent(r1: Region, r2: Region) -> bool:
    """Shared-edge adjacency (find_adjacent_partitions,
    shen_partition.py:165-186): any cell pair shares an edge segment."""
    return any(
        _boxes_adjacent(a, b) for a in r1.boxes for b in r2.boxes
    )


def quad_tree_partition(
    xy: np.ndarray,
    threshold: int,
    bounds: Optional[Box2D] = None,
    max_depth: int = 12,
) -> List[Region]:
    """4-way recursive split (quad_tree_partition, shen_partition.py:40-83).

    ``xy``: (N, 2) point positions. Returns leaf Regions whose
    ``point_indices`` index into ``xy``.
    """
    if bounds is None:
        bounds = Box2D(float(xy[:, 0].min()), float(xy[:, 1].min()),
                       float(xy[:, 0].max()), float(xy[:, 1].max()))

    out: List[Region] = []

    def recurse(idx: np.ndarray, box: Box2D, depth: int, rid: str) -> None:
        if len(idx) <= threshold or depth >= max_depth:
            out.append(Region(rid, [box], idx))
            return
        xm = 0.5 * (box.xmin + box.xmax)
        ym = 0.5 * (box.ymin + box.ymax)
        sub = xy[idx]
        left = sub[:, 0] <= xm
        low = sub[:, 1] <= ym
        quads = [
            (left & low, Box2D(box.xmin, box.ymin, xm, ym)),      # 0 SW
            (~left & low, Box2D(xm, box.ymin, box.xmax, ym)),     # 1 SE
            (left & ~low, Box2D(box.xmin, ym, xm, box.ymax)),     # 2 NW
            (~left & ~low, Box2D(xm, ym, box.xmax, box.ymax)),    # 3 NE
        ]
        for q, (m, b) in enumerate(quads):
            recurse(idx[m], b, depth + 1, f"{rid}{q}")

    recurse(np.arange(len(xy)), bounds, 0, "")
    return out


def merge_regions(r1: Region, r2: Region) -> Region:
    """Union region, ids joined "a-b" (merge_partitions,
    shen_partition.py:188-218)."""
    return Region(
        f"{r1.region_id}-{r2.region_id}",
        r1.boxes + r2.boxes,
        np.concatenate([r1.point_indices, r2.point_indices]),
    )


def _smallest_adjacent(region: Region, pool: List[Region],
                       skip: set) -> Optional[Region]:
    adj = [
        r for r in pool
        if r.region_id not in skip
        and r.region_id != region.region_id
        and regions_adjacent(region, r)
    ]
    return min(adj, key=lambda r: r.point_num) if adj else None


def filter_regions_by_point_count(
    regions: List[Region],
    threshold_value: int,
    min_threshold: int = MIN_THRESHOLD,
) -> List[Region]:
    """Statistics-driven merge (filter_partitions_by_point_count,
    shen_partition.py:105-163): drop sub-min regions; regions under the
    mean count absorb their smallest adjacent region (repeatedly) unless
    the union would exceed ``threshold_value``."""
    regions = [r for r in regions if r.point_num >= min_threshold]
    if not regions:
        return []
    mean_size = float(np.mean([r.point_num for r in regions]))

    merged: List[Region] = []
    skip: set = set()
    for region in regions:
        if region.region_id in skip:
            continue
        if region.point_num < mean_size:
            skip.add(region.region_id)
            partner = _smallest_adjacent(region, regions, skip)
            if partner is None:
                merged.append(region)
                continue
            candidate = merge_regions(region, partner)
            if candidate.point_num > threshold_value:
                merged.append(region)  # keep unmerged (:155-158)
                continue
            skip.add(partner.region_id)
            # keep absorbing while still under the mean (recursive_merge,
            # shen_partition.py:84-103)
            while candidate.point_num < mean_size:
                nxt = _smallest_adjacent(candidate, regions, skip)
                if nxt is None:
                    break
                grown = merge_regions(candidate, nxt)
                if grown.point_num > threshold_value:
                    break
                skip.add(nxt.region_id)
                candidate = grown
            region = candidate
        merged.append(region)
    return merged


def expand_regions(
    regions: List[Region],
    xy: np.ndarray,
    base_expansion_rate: float = 0.2,
) -> List[Region]:
    """Buffer each region by diagonal * rate / 2 and re-extract its points
    (expand_partitions, shen_partition.py:232-274)."""
    out = []
    for region in regions:
        b = region.bounds
        diag = float(np.hypot(b.xmax - b.xmin, b.ymax - b.ymin))
        d = diag * base_expansion_rate / 2.0
        ext = [box.expand_abs(d) for box in region.boxes]
        m = np.zeros(len(xy), bool)
        for e in ext:
            m |= e.contains(xy)
        r = Region(region.region_id, region.boxes, np.flatnonzero(m))
        r.extend_boxes = ext
        r.extend_rate = base_expansion_rate
        out.append(r)
    return out
