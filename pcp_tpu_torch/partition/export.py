"""Per-block dataset export: each partition becomes a self-contained COLMAP
dataset + a pickled PartitionRecord, in the reference's on-disk layout
(save_partition.py:19-207; README.md:114-123):

    <model>/split_result/visible/<id>/
        partition_<id>.pkl
        partition_<id>/
            images/<copied camera images>
            sparse/0/{cameras,images,points3D}.bin

plus the held-out test set at <out>/test/{images/, sparse/0/} —
save_test_cameras (save_partition.py:170-207).

Counterpart of ``pcp_tpu/partition/export.py``.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Iterable, List, Sequence

import numpy as np

from pcp_tpu_torch.io import colmap
from pcp_tpu_torch.partition.types import PartitionRecord
from pcp_tpu_torch.scene.dataset import CameraInfo, SceneInfo
from pcp_tpu_torch.utils.graphics import rotmat_to_qvec


def _images_dict(infos: Sequence[CameraInfo], true_camera_ids: bool) -> dict:
    """CameraInfo -> COLMAP Image records (rot->quat like
    save_partition.py:109-121; empty 2D tracks). With ``true_camera_ids``
    each image keeps its original intrinsic id, so multi-rig/multi-lens
    captures round-trip exactly."""
    out = {}
    for i, info in enumerate(infos, start=1):
        cam_id = (
            info.camera_id
            if true_camera_ids and info.camera_id is not None
            else 1
        )
        out[i] = colmap.Image(
            i,
            rotmat_to_qvec(info.R),
            np.asarray(info.t, np.float64),
            cam_id,
            info.image_name,
            xys=np.zeros((0, 2)),
            point3D_ids=np.zeros((0,), np.int64),
        )
    return out


def _cameras_dict(infos: Sequence[CameraInfo], intrinsics: dict = None) -> dict:
    """The block's cameras.bin content. With a global intrinsics table we
    copy it wholesale into every block — copy_cameras_to_partitions
    (save_partition.py:150-168) — preserving every model/focal. Without one
    (synthetic scenes), fall back to a single PINHOLE built from the first
    view's FoVs."""
    if intrinsics:
        return dict(intrinsics)
    info = infos[0]
    fx, fy = info.focal()
    return {
        1: colmap.Camera(
            1, "PINHOLE", info.width, info.height,
            np.array([fx, fy, info.width / 2.0, info.height / 2.0]),
        )
    }


def _copy_images(infos: Iterable[CameraInfo], dst_dir: str) -> None:
    os.makedirs(dst_dir, exist_ok=True)
    for info in infos:
        if info.image_path and os.path.exists(info.image_path):
            dst = os.path.join(dst_dir, info.image_name)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if not os.path.exists(dst):
                shutil.copyfile(info.image_path, dst)


def _write_colmap_dataset(
    out_dir: str,
    infos: Sequence[CameraInfo],
    xyz: np.ndarray,
    rgb01: np.ndarray,
    copy_images: bool = True,
    intrinsics: dict = None,
) -> None:
    if not infos:
        return
    sparse = os.path.join(out_dir, "sparse", "0")
    pts = colmap.Points3D.from_arrays(xyz, (np.clip(rgb01, 0, 1) * 255).astype(np.uint8))
    colmap.write_model(
        _cameras_dict(infos, intrinsics),
        _images_dict(infos, true_camera_ids=bool(intrinsics)),
        pts, sparse, ext=".bin",
    )
    if copy_images:
        _copy_images(infos, os.path.join(out_dir, "images"))


def export_partition(
    scene: SceneInfo,
    record: PartitionRecord,
    visible_root: str,
    copy_images: bool = True,
) -> str:
    """Write one block under <visible_root>/<id>/ (save_partition_data)."""
    pid = record.partition_id
    block_root = os.path.join(visible_root, pid)
    block_dir = os.path.join(block_root, f"partition_{pid}")
    os.makedirs(block_dir, exist_ok=True)

    infos = [scene.cameras[u] for u in record.camera_uids]
    xyz = scene.points[record.point_indices]
    rgb = scene.colors[record.point_indices]
    _write_colmap_dataset(
        block_dir, infos, xyz, rgb, copy_images,
        intrinsics=getattr(scene, "intrinsics", None),
    )

    with open(os.path.join(block_root, f"partition_{pid}.pkl"), "wb") as f:
        pickle.dump(record, f)
    return block_dir


def save_test_cameras(
    scene: SceneInfo,
    test_infos: Sequence[CameraInfo],
    out_root: str,
    copy_images: bool = True,
) -> None:
    """Held-out views as a COLMAP dataset at <out_root>/test/
    (save_test_cameras, save_partition.py:170-207)."""
    _write_colmap_dataset(
        os.path.join(out_root, "test"), list(test_infos),
        scene.points, scene.colors, copy_images,
        intrinsics=getattr(scene, "intrinsics", None),
    )


def save_partition_data(path: str, records: List[PartitionRecord]) -> None:
    """model/partition_data.pkl (shen_partition_utils.py:94-101)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(records, f)


def load_partition_data(path: str) -> List[PartitionRecord]:
    with open(path, "rb") as f:
        return pickle.load(f)
