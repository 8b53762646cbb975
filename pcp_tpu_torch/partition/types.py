"""Partition data model.

The reference models blocks with shapely Polygons inside NamedTuples
(shen_partation_densify.py:21-35 `Partition`, `CameraPose`). Every box in the
live pipeline is axis-aligned, so here boxes are a plain AABB dataclass
(numpy-only, picklable without shapely).

Counterpart of ``pcp_tpu/partition/types.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Box2D:
    """Axis-aligned XY box; ``None`` bounds mean unbounded on that side
    (merge's dynamic crop boxes, merge_partitions.py:10-57)."""

    xmin: Optional[float]
    ymin: Optional[float]
    xmax: Optional[float]
    ymax: Optional[float]

    def contains(self, xy: np.ndarray) -> np.ndarray:
        """(N, 2) -> (N,) bool mask; open on unbounded sides."""
        m = np.ones(len(xy), bool)
        if self.xmin is not None:
            m &= xy[:, 0] >= self.xmin
        if self.xmax is not None:
            m &= xy[:, 0] <= self.xmax
        if self.ymin is not None:
            m &= xy[:, 1] >= self.ymin
        if self.ymax is not None:
            m &= xy[:, 1] <= self.ymax
        return m

    def expand_abs(self, d: float) -> "Box2D":
        """Grow every bounded side by ``d`` world units (the +80 camera box,
        shen_partation_densify.py:183)."""
        return Box2D(
            None if self.xmin is None else self.xmin - d,
            None if self.ymin is None else self.ymin - d,
            None if self.xmax is None else self.xmax + d,
            None if self.ymax is None else self.ymax + d,
        )

    def expand_ratio(self, r: float) -> "Box2D":
        """Grow by a fraction of each side length (the +10% point box,
        shen_partation_densify.py:222)."""
        dx = (self.xmax - self.xmin) * r
        dy = (self.ymax - self.ymin) * r
        return Box2D(self.xmin - dx, self.ymin - dy, self.xmax + dx, self.ymax + dy)

    def as_array(self) -> np.ndarray:
        return np.array(
            [
                -np.inf if self.xmin is None else self.xmin,
                -np.inf if self.ymin is None else self.ymin,
                np.inf if self.xmax is None else self.xmax,
                np.inf if self.ymax is None else self.ymax,
            ]
        )

    @property
    def bounded(self) -> bool:
        return None not in (self.xmin, self.ymin, self.xmax, self.ymax)


@dataclass
class PartitionRecord:
    """One spatial block (Partition NamedTuple parity,
    shen_partation_densify.py:21-29). Points/cameras are stored as indices
    into the source SceneInfo arrays (compact, reproducible); the export
    layer materialises full COLMAP datasets from them."""

    partition_id: str
    origin_box: Box2D                 # bisection cell
    extend_box: Box2D                 # camera box (+80)
    point_box: Box2D                  # point extraction box (+10%)
    point_indices: np.ndarray         # indices into scene.points
    camera_uids: List[int] = field(default_factory=list)
    point_num: int = 0

    def __post_init__(self):
        self.point_num = int(len(self.point_indices))
