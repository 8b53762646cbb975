"""Lazy ``g++`` build + ctypes loader of the host C++ libraries (counterpart
of ``pcp_tpu/native/build.py``).

Each library is built at first use into
``pcp_tpu_torch/_build/native/lib<name>-<hash>.so``; the hash covers the
source, so a fresh checkout always compiles from the checked-in source and
never trusts a stale binary. The build writes a temporary file and renames
it, so processes that build at once never load a torn library. Without a
working ``g++`` the loaders warn once and return ``None``: the callers fall
back to pure Python or numpy (host code; the card is not involved).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Callable, Dict, Optional

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parent / "_build" / "native"

_LOCK = threading.Lock()
_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path(name: str) -> Path:
    digest = hashlib.sha256((_SRC_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _load(name: str, configure: Callable[[ctypes.CDLL], None],
          fallback: str) -> Optional[ctypes.CDLL]:
    """Build (once per process) and load ``<name>.cpp``; None if no
    working toolchain."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        _LIBS[name] = None
        so = library_path(name)
        try:
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     str(_SRC_DIR / f"{name}.cpp"), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            configure(lib)
            _LIBS[name] = lib
        except (OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"native {name} unavailable ({e}); falling back "
                          f"to {fallback}")
        return _LIBS[name]


def _configure_codec(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.colmap_points3d_count.restype = ctypes.c_int
    lib.colmap_points3d_count.argtypes = [u8p, ctypes.c_uint64, u64p, u64p]
    lib.colmap_points3d_parse.restype = ctypes.c_int
    lib.colmap_points3d_size.restype = ctypes.c_uint64
    lib.colmap_points3d_size.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.colmap_points3d_write.restype = ctypes.c_int
    lib.colmap_images_count.restype = ctypes.c_int
    lib.colmap_images_count.argtypes = [u8p, ctypes.c_uint64, u64p, u64p,
                                        u64p]
    lib.colmap_images_parse.restype = ctypes.c_int


def _configure_points(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.radius_outlier_filter.restype = ctypes.c_int
    lib.radius_outlier_filter.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float, u8p]
    lib.compact_points.restype = ctypes.c_int64
    lib.compact_points.argtypes = [f32p, u8p, ctypes.c_int64, f32p, i64p]
    lib.bisect_xy.restype = ctypes.c_int
    lib.bisect_xy.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, i64p, i64p,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        f32p, ctypes.c_int]


def load_library() -> Optional[ctypes.CDLL]:
    """The COLMAP binary codec (``colmap_codec.cpp``), or None."""
    return _load("colmap_codec", _configure_codec, "pure Python")


def load_points_library() -> Optional[ctypes.CDLL]:
    """The point-cloud ops (``points_native.cpp``), or None."""
    return _load("points_native", _configure_points, "numpy")
