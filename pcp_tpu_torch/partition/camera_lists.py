"""Per-block camera name lists — utils/partition_utils.py parity.

The reference's legacy training glue writes `{partition_id}_camera.txt`
(one image name per line) per block plus global train/test name lists, and
PartitionScene's ColmapVast reader consumes them (partition_utils.py:13-61,
dataset_readers.py:317-353). This framework's primary hand-off is the
self-contained per-block COLMAP dataset, but the lists are kept for
interop with reference tooling.

Counterpart of ``pcp_tpu/partition/camera_lists.py``.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from pcp_tpu_torch.partition.types import PartitionRecord
from pcp_tpu_torch.scene.dataset import CameraInfo, SceneInfo, split_train_test


def write_camera_lists(
    scene: SceneInfo,
    records: Sequence[PartitionRecord],
    out_dir: str,
    llffhold: int = 83,
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for rec in records:
        with open(os.path.join(out_dir, f"{rec.partition_id}_camera.txt"), "w") as f:
            for uid in rec.camera_uids:
                f.write(scene.cameras[uid].image_name + "\n")
    train, test = split_train_test(scene.cameras, True, llffhold)
    for name, infos in (("train_cameras.txt", train), ("test_cameras.txt", test)):
        with open(os.path.join(out_dir, name), "w") as f:
            for info in infos:
                f.write(info.image_name + "\n")


def read_cam_list(path: str) -> List[str]:
    """read_camList (partition_utils.py:51-61)."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def filter_cameras_by_list(
    cameras: Sequence[CameraInfo], names: Sequence[str]
) -> List[CameraInfo]:
    wanted = set(names)
    return [c for c in cameras if c.image_name in wanted]
