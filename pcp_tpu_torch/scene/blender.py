"""Blender / NeRF-synthetic scene reader (`transforms_{train,test}.json`).

Counterpart of readNerfSyntheticInfo + readCamerasFromTransforms
(dataset_readers.py:446-520, registered as sceneLoadTypeCallbacks["Blender"]
:527). Semantics preserved:

- `camera_angle_x` gives FoVx; FoVy follows from the image aspect.
- `transform_matrix` is camera-to-world in OpenGL/Blender axes (Y up,
  Z back); flipped to COLMAP (Y down, Z forward) then inverted to w2c.
- RGBA ground truth is alpha-composited over the white/black background at
  load time (handled lazily by scene.cameras via CameraInfo.alpha_bg).
- With eval off, test frames fold into the train set.
- Without a points3d.ply, a random 100k-point cloud in [-1.3, 1.3]^3 with
  near-black SH-derived colors seeds the Gaussians, and is persisted so
  reruns are stable.

Counterpart of ``pcp_tpu/scene/blender.py``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from pcp_tpu_torch.io.ply import fetch_point_cloud, store_point_cloud
from pcp_tpu_torch.scene.dataset import CameraInfo, SceneInfo, nerfpp_extent
from pcp_tpu_torch.utils.graphics import focal2fov, fov2focal


def _read_transforms(
    path: str, transforms_file: str, bg: np.ndarray, extension: str,
    uid_start: int,
) -> List[CameraInfo]:
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = float(contents["camera_angle_x"])

    infos: List[CameraInfo] = []
    for idx, frame in enumerate(contents["frames"]):
        rel = frame["file_path"]
        image_path = os.path.join(path, rel + extension)
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1.0          # OpenGL -> COLMAP camera axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3]
        t = w2c[:3, 3]

        w, h = _image_size(image_path, frame)
        fovy = focal2fov(fov2focal(fovx, w), h)
        infos.append(
            CameraInfo(
                uid=uid_start + idx,
                image_id=uid_start + idx + 1,
                R=R,
                t=t,
                fovx=fovx,
                fovy=fovy,
                width=w,
                height=h,
                image_name=os.path.basename(rel) + extension,
                image_path=image_path,
                alpha_bg=bg,
            )
        )
    return infos


def _image_size(image_path: str, frame: dict) -> Tuple[int, int]:
    if os.path.exists(image_path):
        from PIL import Image as PILImage

        with PILImage.open(image_path) as im:
            return im.size
    # headless fixtures may specify size in the frame record
    return int(frame.get("w", 800)), int(frame.get("h", 800))


def load_blender_scene(
    path: str,
    white_background: bool = False,
    eval_split: bool = True,
    extension: str = ".png",
    num_random_points: int = 100_000,
    seed: Optional[int] = None,
) -> SceneInfo:
    """Read a NeRF-synthetic dataset rooted at ``path``."""
    bg = np.array([1.0, 1.0, 1.0] if white_background else [0.0, 0.0, 0.0],
                  np.float32)
    train = _read_transforms(path, "transforms_train.json", bg, extension, 0)
    test: List[CameraInfo] = []
    test_path = os.path.join(path, "transforms_test.json")
    if os.path.exists(test_path):
        test = _read_transforms(
            path, "transforms_test.json", bg, extension, len(train)
        )

    cameras = train + test
    test_uids = [c.uid for c in test] if eval_split else []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # no SfM points for synthetic scenes: random init inside the Blender
        # scene bounds (readNerfSyntheticInfo, dataset_readers.py:500-511)
        rng = np.random.default_rng(seed)
        xyz = (rng.random((num_random_points, 3)) * 2.6 - 1.3).astype(np.float32)
        # reference draws random SH coefficients then converts: SH2RGB of
        # U(0, 1/255) — near-gray values just above 0.5
        shs = rng.random((num_random_points, 3)).astype(np.float32) / 255.0
        colors = np.clip(shs * 0.28209479177387814 + 0.5, 0.0, 1.0)
        try:
            store_point_cloud(ply_path, xyz, (colors * 255).astype(np.uint8))
        except OSError:
            pass  # read-only dataset dir: keep the in-memory cloud
    else:
        pc = fetch_point_cloud(ply_path)
        xyz, colors = pc[0].astype(np.float32), pc[1].astype(np.float32)

    extent = nerfpp_extent(
        np.stack([c.center for c in train]) if train else np.zeros((0, 3))
    )
    return SceneInfo(
        cameras=cameras,
        points=xyz,
        colors=colors,
        extent=extent,
        ply_path=ply_path,
        test_camera_uids=test_uids,
    )


def is_blender_scene(path: str) -> bool:
    return os.path.exists(os.path.join(path, "transforms_train.json"))
