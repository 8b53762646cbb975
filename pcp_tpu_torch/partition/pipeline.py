"""Partition pipeline orchestrator (counterpart of
``pcp_tpu/partition/pipeline.py``).

Reference: shen_partition_utils.py:13-126 `ProgressiveDataPartitioning.
run_DataPartition` — outlier removal -> balanced bisection -> box expansion
-> camera assignment -> visibility filter -> export. Every stage is a
vectorized numpy or C++-native program on the host; the outlier screen runs
on ``PartitionConfig.device`` only when the native filter is missing and the
cloud holds more than 500k points (``points.radius_outlier_removal``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from pcp_tpu_torch.partition.density import balanced_bisection
from pcp_tpu_torch.partition.export import (
    export_partition,
    save_partition_data,
    save_test_cameras,
)
from pcp_tpu_torch.partition.points import radius_outlier_removal
from pcp_tpu_torch.partition.types import Box2D, PartitionRecord
from pcp_tpu_torch.partition.visibility import select_cameras_by_visibility
from pcp_tpu_torch.scene.dataset import SceneInfo, split_train_test

THRESHOLD_DEFAULT = 500_000       # 24 GB tier (README.md:91-97)
EXPANSION_DISTANCE = 80.0          # camera box (shen_partation_densify.py:183)
POINT_EXPAND_RATIO = 0.10          # point box (shen_partation_densify.py:222)
VOXEL_SIZE = 0.1                   # visibility downsample (:928)
OUTLIER_NB_POINTS = 5              # shen_partition_utils.py:28-55
OUTLIER_RADIUS = 1.0


@dataclass
class PartitionConfig:
    threshold: int = THRESHOLD_DEFAULT
    max_depth: int = 10
    expansion_distance: float = EXPANSION_DISTANCE
    point_expand_ratio: float = POINT_EXPAND_RATIO
    visible_rate: float = 0.45
    voxel_size: float = VOXEL_SIZE
    outlier_nb_points: int = OUTLIER_NB_POINTS
    outlier_radius: float = OUTLIER_RADIUS
    remove_outliers: bool = True
    llffhold: int = 83
    make_plots: bool = True
    copy_images: bool = True
    # partitioner family: "bisect" (live pipeline), "camera_grid"
    # (VastGaussian m x n grid, data_partition.py:35-557), "quadtree"
    # (first-generation 4-way splitter, shen_partition.py:40-788)
    partitioner: str = "bisect"
    m_region: int = 3                 # camera_grid knobs
    n_region: int = 3                 # (arguments/__init__.py:69-72)
    extend_rate: float = 0.2
    device: Optional[str] = None      # the outlier screen's; None = card


class ProgressiveDataPartitioning:
    """Same responsibility (and name) as the reference orchestrator class."""

    def __init__(self, scene: SceneInfo, model_path: str,
                 config: Optional[PartitionConfig] = None):
        self.scene = scene
        self.model_path = model_path
        self.cfg = config or PartitionConfig()
        self.records: List[PartitionRecord] = []

    # -- stages ------------------------------------------------------------

    def filter_points(self) -> np.ndarray:
        cfg = self.cfg
        pts = self.scene.points
        if not cfg.remove_outliers or len(pts) == 0:
            return np.arange(len(pts))
        keep = radius_outlier_removal(
            pts, nb_points=cfg.outlier_nb_points, radius=cfg.outlier_radius,
            device=cfg.device,
        )
        # Degenerate guard: if the filter would drop (almost) everything the
        # radius is mis-scaled for this scene; fall back to the full cloud.
        if keep.sum() < max(10, 0.01 * len(pts)):
            return np.arange(len(pts))
        return np.flatnonzero(keep)

    def run(self) -> List[PartitionRecord]:
        cfg = self.cfg
        scene = self.scene
        t0 = time.time()
        if cfg.partitioner == "camera_grid":
            # VastGaussian family: balanced camera grid + border refine +
            # airspace visibility, all inside run_camera_grid_partition.
            # The legacy reference path does NOT outlier-filter first
            # (data_partition.py:35-100) — kept faithful here.
            from pcp_tpu_torch.partition.camera_grid import (
                CameraGridConfig,
                run_camera_grid_partition,
            )

            records = run_camera_grid_partition(
                scene,
                CameraGridConfig(
                    m_region=cfg.m_region,
                    n_region=cfg.n_region,
                    extend_rate=cfg.extend_rate,
                    visible_rate=cfg.visible_rate,
                ),
            )
            self.records = records
            if cfg.make_plots:
                self.plot()
            print(
                f"camera-grid partitioned {len(scene.points)} pts -> "
                f"{len(records)} blocks in {time.time() - t0:.2f}s"
            )
            return records

        if cfg.remove_outliers and len(scene.points):
            from pcp_tpu_torch.partition.points import compact_by_mask

            keep = radius_outlier_removal(
                scene.points, nb_points=cfg.outlier_nb_points,
                radius=cfg.outlier_radius, device=cfg.device,
            )
            if keep.sum() < max(10, 0.01 * len(scene.points)):
                kept = np.arange(len(scene.points))
                pts = scene.points
            else:
                pts, kept = compact_by_mask(scene.points, keep)
        else:
            kept = np.arange(len(scene.points))
            pts = scene.points

        if cfg.partitioner == "quadtree":
            # first-generation 4-way splitter + statistics merge; its legacy
            # expansion is a diagonal*rate/2 buffer (shen_partition.py:
            # 232-274) applied to BOTH the camera and point boxes. Camera
            # assignment + visibility then reuse the live stages below.
            from pcp_tpu_torch.partition.quadtree import (
                filter_regions_by_point_count,
                quad_tree_partition,
            )

            regions = filter_regions_by_point_count(
                quad_tree_partition(pts[:, :2], cfg.threshold,
                                    max_depth=cfg.max_depth),
                cfg.threshold,
            )
            leaves = [
                (r.region_id or "root", r.point_indices, r.bounds)
                for r in regions
            ]
        else:
            leaves = balanced_bisection(pts[:, :2], cfg.threshold,
                                        cfg.max_depth)

        cam_xy = np.stack([c.center[:2] for c in scene.cameras]) if scene.cameras else np.zeros((0, 2))
        records: List[PartitionRecord] = []
        for pid, idx, box in leaves:
            if cfg.partitioner == "quadtree":
                diag = float(np.hypot(box.xmax - box.xmin,
                                      box.ymax - box.ymin))
                d = diag * cfg.extend_rate / 2.0
                extend_box = box.expand_abs(d)
                point_box = extend_box
            else:
                extend_box = box.expand_abs(cfg.expansion_distance)
                point_box = box.expand_ratio(cfg.point_expand_ratio)
            pmask = point_box.contains(pts[:, :2])
            point_indices = kept[np.flatnonzero(pmask)]

            # camera assignment: center inside extend_box
            # (assign_cameras_to_partitions, shen_partation_densify.py:362-408)
            cam_uids = [
                c.uid for c, inside in zip(scene.cameras, extend_box.contains(cam_xy))
                if inside
            ]
            records.append(
                PartitionRecord(
                    partition_id=pid,
                    origin_box=box,
                    extend_box=extend_box,
                    point_box=point_box,
                    point_indices=point_indices,
                    camera_uids=cam_uids,
                )
            )

        # visibility filter (shen_partation_densify.py:911-954). The
        # reference voxel-downsamples first purely to cut projection cost
        # (:928); select_cameras_by_visibility decimates to directional
        # hull support points internally, which subsumes that (and is
        # ~100x smaller), so no pre-downsample here.
        for rec in records:
            block_pts = scene.points[rec.point_indices]
            cands = [scene.cameras[u] for u in rec.camera_uids]
            rec.camera_uids = select_cameras_by_visibility(
                block_pts, cands, threshold=cfg.visible_rate
            )

        self.records = records
        if cfg.make_plots:
            self.plot()
        print(
            f"partitioned {len(pts)} pts -> {len(records)} blocks "
            f"in {time.time() - t0:.2f}s"
        )
        return records

    def export(self) -> str:
        """Write split_result/visible/<id>/... + partition_data.pkl +
        per-block camera name lists (partition_utils.py interop)."""
        visible_root = os.path.join(self.model_path, "split_result", "visible")
        os.makedirs(visible_root, exist_ok=True)
        for rec in self.records:
            export_partition(
                self.scene, rec, visible_root, copy_images=self.cfg.copy_images
            )
        save_partition_data(
            os.path.join(self.model_path, "partition_data.pkl"), self.records
        )
        from pcp_tpu_torch.partition.camera_lists import write_camera_lists

        write_camera_lists(
            self.scene, self.records, self.model_path, self.cfg.llffhold
        )
        return visible_root

    def plot(self) -> None:
        """partitions.png / expanded_partitions.png diagnostics
        (shen_partition_utils.py:83-92)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        os.makedirs(self.model_path, exist_ok=True)
        for name, attr in (("partitions", "origin_box"),
                           ("expanded_partitions", "extend_box")):
            fig, ax = plt.subplots(figsize=(8, 8))
            pts = self.scene.points
            step = max(1, len(pts) // 100_000)
            ax.scatter(pts[::step, 0], pts[::step, 1], s=0.2, c="gray", alpha=0.4)
            for rec in self.records:
                b: Box2D = getattr(rec, attr)
                ax.add_patch(
                    plt.Rectangle(
                        (b.xmin, b.ymin), b.xmax - b.xmin, b.ymax - b.ymin,
                        fill=False, edgecolor="red",
                    )
                )
                ax.text((b.xmin + b.xmax) / 2, (b.ymin + b.ymax) / 2,
                        rec.partition_id, fontsize=7, ha="center")
            ax.set_aspect("equal")
            fig.savefig(os.path.join(self.model_path, f"{name}.png"), dpi=120)
            plt.close(fig)


def run_partition(
    scene: SceneInfo,
    model_path: str,
    config: Optional[PartitionConfig] = None,
    export: bool = True,
    save_test: bool = True,
) -> List[PartitionRecord]:
    """One-call pipeline (the shen_partition_utils.py:102-126 script body)."""
    cfg = config or PartitionConfig()
    pdp = ProgressiveDataPartitioning(scene, model_path, cfg)
    records = pdp.run()
    if save_test:
        _, test_infos = split_train_test(scene.cameras, True, cfg.llffhold)
        if test_infos:
            save_test_cameras(
                scene, test_infos, os.path.dirname(model_path.rstrip("/")) or ".",
                copy_images=cfg.copy_images,
            )
    if export:
        pdp.export()
    return records
