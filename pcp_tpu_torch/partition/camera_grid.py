"""VastGaussian m x n camera-grid partitioner (the reference's second
partitioner family).

Reference: scene/ptgs/data_partition.py:35-557 `ProgressiveDataPartitioning`
(the *camera*-balanced grid, vs. the live point-balanced bisection in
pcp_tpu_torch.partition.density):

1. Camera_position_based_region_division (:220-274): sort camera centers
   along the primary axis into m balanced groups, each sorted along the
   secondary axis into n groups (ids "1_1".."m_n").
2. refine_ori_bbox_average (:115-178): snap adjacent group borders to the
   midpoint between neighbouring camera bboxes so the cells tile seamlessly.
3. Position_based_data_selection (:295-365): extend each cell by
   ``extend_rate`` (default 0.2) and extract the points inside.
4. Visibility_based_camera_selection (:427-557, airspace-aware): project the
   block's extended point-bbox 8 corner points into every *other* block's
   camera; if the corner hull covers >= ``visible_rate`` (default 0.25) of
   the image, append that camera — and the 3D points it observes (via its
   COLMAP point3D ids) — to the block.

Axes: the reference assumes a ground plane spanned by world x/z; this
framework uses x/y everywhere (matching the live bisection pipeline); pass
``axes=(0, 2)`` for x/z datasets.

Counterpart of ``pcp_tpu/partition/camera_grid.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from pcp_tpu_torch.partition.types import Box2D, PartitionRecord
from pcp_tpu_torch.partition.visibility import hull_area_ratio
from pcp_tpu_torch.scene.dataset import CameraInfo, SceneInfo


@dataclass
class CameraGridConfig:
    m_region: int = 3
    n_region: int = 3
    extend_rate: float = 0.2          # arguments/__init__.py:71
    visible_rate: float = 0.25        # arguments/__init__.py:72
    axes: Tuple[int, int] = (0, 1)


def _balanced_groups(order: np.ndarray, k: int) -> List[np.ndarray]:
    """Split sorted indices into k groups; remainder joins the last
    (data_partition.py:244-255)."""
    per = len(order) // k
    groups = [order[i * per:(i + 1) * per] for i in range(k)]
    groups[-1] = np.concatenate([groups[-1], order[k * per:]])
    return groups


def camera_region_division(
    centers_2d: np.ndarray, m: int, n: int
) -> Dict[str, np.ndarray]:
    """{"<i>_<j>": camera index array} balanced m (axis0) x n (axis1) grid."""
    out: Dict[str, np.ndarray] = {}
    by_x = np.argsort(centers_2d[:, 0], kind="stable")
    for i, gx in enumerate(_balanced_groups(by_x, m), start=1):
        by_y = gx[np.argsort(centers_2d[gx, 1], kind="stable")]
        for j, gy in enumerate(_balanced_groups(by_y, n), start=1):
            out[f"{i}_{j}"] = gy
    return out


def refine_boxes(
    groups: Dict[str, np.ndarray], centers_2d: np.ndarray, m: int, n: int
) -> Dict[str, Box2D]:
    """Seamless cell boxes: midpoint between adjacent camera bboxes
    (refine_ori_bbox_average, data_partition.py:115-178)."""
    bbox = {}
    for pid, idx in groups.items():
        xy = centers_2d[idx]
        bbox[pid] = [xy[:, 0].min(), xy[:, 0].max(), xy[:, 1].min(), xy[:, 1].max()]
    # secondary-axis borders within each column
    for i in range(1, m + 1):
        for j in range(1, n):
            a, b = bbox[f"{i}_{j}"], bbox[f"{i}_{j + 1}"]
            mid = 0.5 * (a[3] + b[2])
            a[3] = mid
            b[2] = mid
    # primary-axis borders between columns
    for i in range(1, m):
        left_max = max(bbox[f"{i}_{j}"][1] for j in range(1, n + 1))
        right_min = min(bbox[f"{i + 1}_{j}"][0] for j in range(1, n + 1))
        mid = 0.5 * (left_max + right_min)
        for j in range(1, n + 1):
            bbox[f"{i}_{j}"][1] = mid
            bbox[f"{i + 1}_{j}"][0] = mid
    return {
        pid: Box2D(b[0], b[2], b[1], b[3]) for pid, b in bbox.items()
    }


def _corner_points(points: np.ndarray) -> np.ndarray:
    """8 corners of the 3D bbox (get_8_corner_points,
    data_partition.py:368-382)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    return np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])]
    )


def _project_corners(cam: CameraInfo, pts: np.ndarray) -> np.ndarray:
    """Corner points -> image plane, +z in front (point_in_image,
    data_partition.py:385-424 with the 'fix bug' intrinsics)."""
    p_cam = pts @ cam.R.T + cam.t
    p_cam = p_cam[p_cam[:, 2] > 0]
    if len(p_cam) == 0:
        return np.zeros((0, 2))
    fx, fy = cam.focal()
    px = p_cam[:, 0] / p_cam[:, 2] * fx + cam.width / 2.0
    py = p_cam[:, 1] / p_cam[:, 2] * fy + cam.height / 2.0
    return np.stack([px, py], axis=-1)


def run_camera_grid_partition(
    scene: SceneInfo, cfg: CameraGridConfig = None
) -> List[PartitionRecord]:
    """Full camera-grid pipeline -> PartitionRecords (exportable with
    pcp_tpu_torch.partition.export like the bisection pipeline's)."""
    cfg = cfg or CameraGridConfig()
    ax = list(cfg.axes)
    centers = np.stack([c.center for c in scene.cameras])
    centers_2d = centers[:, ax]
    pts2d = scene.points[:, ax]

    groups = camera_region_division(centers_2d, cfg.m_region, cfg.n_region)
    boxes = refine_boxes(groups, centers_2d, cfg.m_region, cfg.n_region)

    records: List[PartitionRecord] = []
    for pid, cam_idx in groups.items():
        box = boxes[pid]
        extend = box.expand_ratio(cfg.extend_rate)
        pmask = extend.contains(pts2d)
        records.append(
            PartitionRecord(
                partition_id=pid,
                origin_box=box,
                extend_box=extend,
                point_box=extend,
                point_indices=np.flatnonzero(pmask),
                camera_uids=[scene.cameras[i].uid for i in cam_idx],
            )
        )

    # airspace-aware visibility: add other blocks' cameras (and their
    # observed points) that see this block's extended bbox corners
    # (Visibility_based_camera_selection, data_partition.py:427-557)
    id_to_row = None
    for rec in records:
        block_pts = scene.points[rec.point_indices]
        if len(block_pts) == 0:
            continue
        corners = _corner_points(block_pts)
        have = set(rec.camera_uids)
        extra_points: List[np.ndarray] = []
        for cam in scene.cameras:
            if cam.uid in have:
                continue
            pix = _project_corners(cam, corners)
            if len(pix) < 3:
                continue
            if hull_area_ratio(pix, cam.width, cam.height) >= cfg.visible_rate:
                rec.camera_uids.append(cam.uid)
                if cam.point3d_ids is not None and len(cam.point3d_ids):
                    if id_to_row is None:
                        id_to_row = _point_id_index(scene)
                    rows = id_to_row.get_rows(cam.point3d_ids)
                    if len(rows):
                        extra_points.append(rows)
        if extra_points:
            rec.point_indices = np.union1d(
                rec.point_indices, np.concatenate(extra_points)
            )
            rec.point_num = int(len(rec.point_indices))
    return records


class _point_id_index:
    """COLMAP point3D id -> row index in scene.points (built lazily).

    The exporter stores points3D with ids 1..N in row order
    (Points3D.from_arrays), and load_colmap_scene preserves row order, so
    for scenes loaded through this framework id == row + 1; for foreign
    scenes a real mapping would need the raw Points3D ids, which SceneInfo
    does not keep — fall back to the identity-off-by-one and drop misses.
    """

    def __init__(self, scene: SceneInfo):
        self.n = len(scene.points)

    def get_rows(self, ids: np.ndarray) -> np.ndarray:
        rows = np.asarray(ids, np.int64) - 1
        return rows[(rows >= 0) & (rows < self.n)]
