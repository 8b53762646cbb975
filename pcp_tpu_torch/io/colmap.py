"""COLMAP sparse-model I/O (binary + text), struct-of-arrays, pure numpy.

Covers the same surface as the reference's scene/colmap_loader.py:195-340
(readers) and scene/ptgs/read_write_model.py (writers): cameras / images /
points3D in both .bin and .txt encodings, full camera-model table, and
round-trip fidelity (including 2D feature tracks) so blocks exported by this
framework are valid COLMAP datasets consumable by reference tooling.

Layout notes (COLMAP on-disk format, little-endian):
- cameras.bin : u64 n; per cam: i32 id, i32 model_id, u64 w, u64 h, f64 params[]
- images.bin  : u64 n; per img: i32 id, f64 q[4], f64 t[3], i32 cam_id,
                name\\0, u64 n2d, (f64 x, f64 y, i64 p3d_id) * n2d
- points3D.bin: u64 n; per pt: i64 id, f64 xyz[3], u8 rgb[3], f64 err,
                u64 track_len, (i32 image_id, i32 point2D_idx) * track_len
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Camera models (colmap_loader.py:63-80 table)
# ---------------------------------------------------------------------------

CAMERA_MODEL_IDS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_NAMES = {name: (mid, n) for mid, (name, n) in CAMERA_MODEL_IDS.items()}


@dataclass
class Camera:
    """One COLMAP intrinsic."""

    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (num_params,) float64

    @property
    def focal(self) -> tuple:
        """(fx, fy) for the pinhole family."""
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            return float(self.params[0]), float(self.params[0])
        return float(self.params[0]), float(self.params[1])


@dataclass
class Image:
    """One registered COLMAP image (extrinsic + 2D features)."""

    id: int
    qvec: np.ndarray  # (4,) [w,x,y,z]
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))


@dataclass
class Points3D:
    """All 3D points as struct-of-arrays (vectorized, unlike the reference's
    per-point dicts)."""

    ids: np.ndarray          # (N,) int64
    xyz: np.ndarray          # (N, 3) float64
    rgb: np.ndarray          # (N, 3) uint8
    error: np.ndarray        # (N,) float64
    track_lengths: np.ndarray  # (N,) int64
    track_image_ids: np.ndarray  # (sum(track_lengths),) int32
    track_point2D_idxs: np.ndarray  # (sum(track_lengths),) int32

    def __len__(self):
        return len(self.ids)

    @property
    def track_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.track_lengths)])

    def select(self, mask_or_idx) -> "Points3D":
        """Subset points (tracks carried along) — used by the block exporter."""
        idx = np.flatnonzero(mask_or_idx) if np.asarray(mask_or_idx).dtype == bool else np.asarray(mask_or_idx)
        offs = self.track_offsets
        spans = [np.arange(offs[i], offs[i + 1]) for i in idx]
        flat = np.concatenate(spans) if spans else np.zeros((0,), np.int64)
        return Points3D(
            ids=self.ids[idx],
            xyz=self.xyz[idx],
            rgb=self.rgb[idx],
            error=self.error[idx],
            track_lengths=self.track_lengths[idx],
            track_image_ids=self.track_image_ids[flat],
            track_point2D_idxs=self.track_point2D_idxs[flat],
        )

    @staticmethod
    def from_arrays(xyz, rgb, ids=None, error=None) -> "Points3D":
        n = len(xyz)
        return Points3D(
            ids=np.arange(1, n + 1, dtype=np.int64) if ids is None else np.asarray(ids, np.int64),
            xyz=np.asarray(xyz, np.float64),
            rgb=np.asarray(rgb, np.uint8),
            error=np.zeros(n) if error is None else np.asarray(error, np.float64),
            track_lengths=np.zeros(n, np.int64),
            track_image_ids=np.zeros(0, np.int32),
            track_point2D_idxs=np.zeros(0, np.int32),
        )


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def read_cameras_binary(path: str) -> Dict[int, Camera]:
    """colmap_loader.py:285-311 semantics."""
    cameras: Dict[int, Camera] = {}
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(n):
        cam_id, model_id, w, h = struct.unpack_from("<iiQQ", data, off)
        off += 24
        name, num_params = CAMERA_MODEL_IDS[model_id]
        params = np.frombuffer(data, dtype="<f8", count=num_params, offset=off).copy()
        off += 8 * num_params
        cameras[cam_id] = Camera(cam_id, name, int(w), int(h), params)
    return cameras


def write_cameras_binary(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, num_params = CAMERA_MODEL_NAMES[cam.model]
            assert len(cam.params) == num_params, (cam.model, len(cam.params))
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras: Dict[int, Camera] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            model = elems[1]
            cameras[cam_id] = Camera(
                cam_id, model, int(elems[2]), int(elems[3]),
                np.array(elems[4:], dtype=np.float64),
            )
    return cameras


def write_cameras_text(cameras: Dict[int, Camera], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cameras)}\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


# ---------------------------------------------------------------------------
# images
# ---------------------------------------------------------------------------

_POINT2D_DTYPE = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])


def read_images_binary(path: str) -> Dict[int, Image]:
    """colmap_loader.py:195-248 semantics (keeps 2D features + point3D ids)."""
    images: Dict[int, Image] = {}
    with open(path, "rb") as f:
        data = f.read()
    try:
        from pcp_tpu_torch.io.colmap_fast import read_images_binary_native

        fast = read_images_binary_native(data)
    except Exception:
        fast = None
    if fast is not None:
        ids, qvec, tvec, cam_ids, names, n2d, xys, p3d = fast
        offs = np.concatenate([[0], np.cumsum(n2d)]).astype(np.int64)
        for i in range(len(ids)):
            s, e = offs[i], offs[i + 1]
            images[int(ids[i])] = Image(
                int(ids[i]), qvec[i].copy(), tvec[i].copy(), int(cam_ids[i]),
                names[i], xys[s:e].copy(), p3d[s:e].copy(),
            )
        return images
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(n):
        vals = struct.unpack_from("<idddddddi", data, off)
        off += 64
        img_id, camera_id = vals[0], vals[8]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (n2d,) = struct.unpack_from("<Q", data, off)
        off += 8
        rec = np.frombuffer(data, dtype=_POINT2D_DTYPE, count=n2d, offset=off)
        off += 24 * n2d
        xys = np.stack([rec["x"], rec["y"]], axis=-1) if n2d else np.zeros((0, 2))
        p3d = rec["id"].copy() if n2d else np.zeros((0,), np.int64)
        images[img_id] = Image(img_id, qvec, tvec, camera_id, name, xys, p3d)
    return images


def write_images_binary(images: Dict[int, Image], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n2d = len(im.xys)
            f.write(struct.pack("<Q", n2d))
            if n2d:
                rec = np.empty(n2d, dtype=_POINT2D_DTYPE)
                rec["x"] = im.xys[:, 0]
                rec["y"] = im.xys[:, 1]
                rec["id"] = np.asarray(im.point3D_ids, np.int64)
                f.write(rec.tobytes())


def read_images_text(path: str) -> Dict[int, Image]:
    images: Dict[int, Image] = {}
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for i in range(0, len(lines), 2):
        elems = lines[i].split()
        img_id = int(elems[0])
        qvec = np.array(elems[1:5], dtype=np.float64)
        tvec = np.array(elems[5:8], dtype=np.float64)
        camera_id = int(elems[8])
        name = elems[9]
        feats = lines[i + 1].split() if i + 1 < len(lines) else []
        arr = np.array(feats, dtype=np.float64).reshape(-1, 3) if feats else np.zeros((0, 3))
        images[img_id] = Image(
            img_id, qvec, tvec, camera_id, name,
            arr[:, :2], arr[:, 2].astype(np.int64),
        )
    return images


def write_images_text(images: Dict[int, Image], path: str) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(images)}\n")
        for im in images.values():
            head = [im.id, *im.qvec, *im.tvec, im.camera_id, im.name]
            f.write(" ".join(map(str, head)) + "\n")
            feats = []
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                feats += [str(x), str(y), str(int(pid))]
            f.write(" ".join(feats) + "\n")


# ---------------------------------------------------------------------------
# points3D
# ---------------------------------------------------------------------------

def read_points3D_binary(path: str) -> Points3D:
    """colmap_loader.py:250-283 semantics, struct-of-arrays + tracks.

    Uses the native C++ codec (pcp_tpu_torch.native) when built; pure-Python
    fallback below is byte-identical."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        from pcp_tpu_torch.io.colmap_fast import read_points3d_binary_native

        fast = read_points3d_binary_native(data)
    except Exception:
        fast = None
    if fast is not None:
        ids, xyz, rgb, err, tlen, t_img, t_idx = fast
        return Points3D(ids, xyz, rgb, err, tlen, t_img, t_idx)
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    tlen = np.empty(n, np.int64)
    t_img: list = []
    t_idx: list = []
    unpack = struct.unpack_from
    for i in range(n):
        pid, x, y, z, r, g, b, e, tl = unpack("<qdddBBBdQ", data, off)
        off += 43 + 8
        ids[i] = pid
        xyz[i] = (x, y, z)
        rgb[i] = (r, g, b)
        err[i] = e
        tlen[i] = tl
        if tl:
            track = np.frombuffer(data, dtype="<i4", count=2 * tl, offset=off).reshape(tl, 2)
            t_img.append(track[:, 0].copy())
            t_idx.append(track[:, 1].copy())
            off += 8 * tl
    return Points3D(
        ids, xyz, rgb, err, tlen,
        np.concatenate(t_img) if t_img else np.zeros(0, np.int32),
        np.concatenate(t_idx) if t_idx else np.zeros(0, np.int32),
    )


def write_points3D_binary(pts: Points3D, path: str) -> None:
    try:
        from pcp_tpu_torch.io.colmap_fast import write_points3d_binary_native

        blob = write_points3d_binary_native(
            pts.ids, pts.xyz, pts.rgb, pts.error, pts.track_lengths,
            pts.track_image_ids, pts.track_point2D_idxs,
        )
    except Exception:
        blob = None
    if blob is not None:
        with open(path, "wb") as f:
            f.write(blob)
        return
    offs = pts.track_offsets
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i in range(len(pts)):
            f.write(struct.pack(
                "<qdddBBBdQ",
                int(pts.ids[i]), *pts.xyz[i],
                int(pts.rgb[i, 0]), int(pts.rgb[i, 1]), int(pts.rgb[i, 2]),
                float(pts.error[i]), int(pts.track_lengths[i]),
            ))
            tl = int(pts.track_lengths[i])
            if tl:
                track = np.empty((tl, 2), dtype="<i4")
                track[:, 0] = pts.track_image_ids[offs[i]:offs[i] + tl]
                track[:, 1] = pts.track_point2D_idxs[offs[i]:offs[i] + tl]
                f.write(track.tobytes())


def read_points3D_text(path: str) -> Points3D:
    ids, xyz, rgb, err, tlen, t_img, t_idx = [], [], [], [], [], [], []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            ids.append(int(e[0]))
            xyz.append([float(v) for v in e[1:4]])
            rgb.append([int(v) for v in e[4:7]])
            err.append(float(e[7]))
            track = np.array(e[8:], dtype=np.int64).reshape(-1, 2)
            tlen.append(len(track))
            t_img.append(track[:, 0].astype(np.int32))
            t_idx.append(track[:, 1].astype(np.int32))
    return Points3D(
        np.array(ids, np.int64),
        np.array(xyz, np.float64).reshape(-1, 3),
        np.array(rgb, np.uint8).reshape(-1, 3),
        np.array(err, np.float64),
        np.array(tlen, np.int64),
        np.concatenate(t_img) if t_img else np.zeros(0, np.int32),
        np.concatenate(t_idx) if t_idx else np.zeros(0, np.int32),
    )


def write_points3D_text(pts: Points3D, path: str) -> None:
    offs = pts.track_offsets
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(pts)}\n")
        for i in range(len(pts)):
            tl = int(pts.track_lengths[i])
            track = []
            for j in range(offs[i], offs[i] + tl):
                track += [str(int(pts.track_image_ids[j])), str(int(pts.track_point2D_idxs[j]))]
            f.write(
                f"{int(pts.ids[i])} {pts.xyz[i,0]} {pts.xyz[i,1]} {pts.xyz[i,2]} "
                f"{int(pts.rgb[i,0])} {int(pts.rgb[i,1])} {int(pts.rgb[i,2])} "
                f"{pts.error[i]} " + " ".join(track) + "\n"
            )


# ---------------------------------------------------------------------------
# model-level helpers
# ---------------------------------------------------------------------------

def _detect(path: str, stem: str) -> Optional[str]:
    for ext in (".bin", ".txt"):
        p = os.path.join(path, stem + ext)
        if os.path.exists(p):
            return p
    return None


def read_model(path: str):
    """Read a sparse model dir (auto .bin/.txt) -> (cameras, images, points3D).

    Mirrors the reference's bin-first-then-txt fallback
    (dataset_readers.py:269-285)."""
    cam_p, img_p, pts_p = _detect(path, "cameras"), _detect(path, "images"), _detect(path, "points3D")
    if cam_p is None or img_p is None or pts_p is None:
        raise FileNotFoundError(f"no COLMAP model found under {path}")
    cameras = read_cameras_binary(cam_p) if cam_p.endswith(".bin") else read_cameras_text(cam_p)
    images = read_images_binary(img_p) if img_p.endswith(".bin") else read_images_text(img_p)
    points = read_points3D_binary(pts_p) if pts_p.endswith(".bin") else read_points3D_text(pts_p)
    return cameras, images, points


def write_model(cameras, images, points, path: str, ext: str = ".bin") -> None:
    os.makedirs(path, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, os.path.join(path, "cameras.bin"))
        write_images_binary(images, os.path.join(path, "images.bin"))
        write_points3D_binary(points, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cameras, os.path.join(path, "cameras.txt"))
        write_images_text(images, os.path.join(path, "images.txt"))
        write_points3D_text(points, os.path.join(path, "points3D.txt"))
