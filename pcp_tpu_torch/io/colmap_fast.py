"""ctypes fast paths for COLMAP binary I/O through the port's native codec
(counterpart of ``pcp_tpu/io/colmap_fast.py``).

Same bytes as the pure-Python readers and writer in
``pcp_tpu_torch.io.colmap``, without its per-record Python loops.
Every entry returns None when the native library is unavailable, so
colmap.py falls back to pure Python.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np


def _lib():
    from pcp_tpu_torch.native import load_library

    return load_library()


def _u8(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr(arr: np.ndarray, t):
    return arr.ctypes.data_as(ctypes.POINTER(t))


def read_points3d_binary_native(data: bytes):
    lib = _lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    n = ctypes.c_uint64()
    tt = ctypes.c_uint64()
    if lib.colmap_points3d_count(_u8(buf), len(data),
                                 ctypes.byref(n), ctypes.byref(tt)) != 0:
        return None
    n, tt = n.value, tt.value
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty(n, np.float64)
    tlen = np.empty(n, np.uint64)
    t_img = np.empty(tt, np.int32)
    t_idx = np.empty(tt, np.int32)
    rc = lib.colmap_points3d_parse(
        _u8(buf), len(data),
        _ptr(ids, ctypes.c_int64), _ptr(xyz, ctypes.c_double),
        _ptr(rgb, ctypes.c_uint8), _ptr(err, ctypes.c_double),
        _ptr(tlen, ctypes.c_uint64),
        _ptr(t_img, ctypes.c_int32), _ptr(t_idx, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return ids, xyz, rgb, err, tlen.astype(np.int64), t_img, t_idx


def write_points3d_binary_native(ids, xyz, rgb, err, tlen, t_img, t_idx) -> Optional[bytes]:
    lib = _lib()
    if lib is None:
        return None
    n = len(ids)
    total_track = int(tlen.sum())
    size = lib.colmap_points3d_size(n, total_track)
    out = np.empty(size, np.uint8)
    ids = np.ascontiguousarray(ids, np.int64)
    xyz = np.ascontiguousarray(xyz, np.float64)
    rgb = np.ascontiguousarray(rgb, np.uint8)
    err = np.ascontiguousarray(err, np.float64)
    tlen_u = np.ascontiguousarray(tlen, np.uint64)
    t_img = np.ascontiguousarray(t_img, np.int32)
    t_idx = np.ascontiguousarray(t_idx, np.int32)
    rc = lib.colmap_points3d_write(
        _u8(out), size, n,
        _ptr(ids, ctypes.c_int64), _ptr(xyz, ctypes.c_double),
        _ptr(rgb, ctypes.c_uint8), _ptr(err, ctypes.c_double),
        _ptr(tlen_u, ctypes.c_uint64),
        _ptr(t_img, ctypes.c_int32), _ptr(t_idx, ctypes.c_int32),
    )
    return out.tobytes() if rc == 0 else None


def read_images_binary_native(data: bytes):
    """Returns (ids, qvec, tvec, camera_ids, names list, n2d, xys, p3d) or
    None."""
    lib = _lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    n = ctypes.c_uint64()
    p2d = ctypes.c_uint64()
    nb = ctypes.c_uint64()
    if lib.colmap_images_count(_u8(buf), len(data), ctypes.byref(n),
                               ctypes.byref(p2d), ctypes.byref(nb)) != 0:
        return None
    n, p2d, nb = n.value, p2d.value, nb.value
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    names_buf = np.empty(nb, np.uint8)
    n2d = np.empty(n, np.uint64)
    xys = np.empty((p2d, 2), np.float64)
    p3d = np.empty(p2d, np.int64)
    rc = lib.colmap_images_parse(
        _u8(buf), len(data),
        _ptr(ids, ctypes.c_int32), _ptr(qvec, ctypes.c_double),
        _ptr(tvec, ctypes.c_double), _ptr(cam_ids, ctypes.c_int32),
        _u8(names_buf), _ptr(n2d, ctypes.c_uint64),
        _ptr(xys, ctypes.c_double), _ptr(p3d, ctypes.c_int64),
    )
    if rc != 0:
        return None
    names = names_buf.tobytes().split(b"\x00")[:n]
    return (ids, qvec, tvec, cam_ids,
            [s.decode("utf-8") for s in names], n2d.astype(np.int64), xys, p3d)
