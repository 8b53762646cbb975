"""SIBR-compatible viewer socket server (counterpart of
``pcp_tpu/viewer/network_gui.py``; gaussian_renderer/network_gui.py:24-86).

A non-blocking TCP listener (default 127.0.0.1:6009) speaking the original
3DGS viewer protocol: a little-endian ``<I`` length, then a JSON camera
message in; raw (H, W, 3) uint8 RGB bytes, a 4-byte little-endian length
and an ASCII verify string out. The train loop polls it before each step
(``train.loop.poll_viewer``; train.py:67-84).

Message in (JSON): resolution_x/y, fov_y, fov_x, z_near, z_far,
view_matrix (16 floats), view_projection_matrix (16), and the optional
train (default true), keep_alive (true), scaling_modifier (1.0),
shs_python and rot_scale_python (false). The Y and Z columns of the view
matrix and the Y column of the projection are negated
(network_gui.py:55-64). A zero resolution gives no camera and keeps the
connection; input that is not a length-prefixed UTF-8 JSON message closes
it. This module is host code: the render is the loop's.
"""

from __future__ import annotations

import json
import socket
import struct
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class ViewerCamera:
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray   # (4, 4) f32
    full_proj_transform: np.ndarray    # (4, 4) f32
    do_training: bool
    keep_alive: bool
    scaling_modifier: float
    shs_python: bool
    rot_scale_python: bool


class NetworkGUI:
    """Non-blocking accept, then one blocking connection at a time."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        """True while a viewer is connected; accepts a waiting one."""
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
        except OSError:         # none waiting (BlockingIOError) or closed
            return False
        self.conn.settimeout(None)
        return True

    def _read_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            b = self.conn.recv(n - got)
            if not b:
                raise ConnectionError("viewer disconnected")
            chunks.append(b)
            got += len(b)
        return b"".join(chunks)

    def receive(self) -> Optional[ViewerCamera]:
        """One camera message; None for a zero resolution or for malformed
        input, which also closes the connection."""
        try:
            (length,) = struct.unpack("<I", self._read_exact(4))
            msg = json.loads(self._read_exact(length).decode("utf-8"))
        except (OSError, ValueError, struct.error):
            self.close_conn()
            return None
        try:
            w = msg["resolution_x"]
            h = msg["resolution_y"]
            if w == 0 or h == 0:
                return None
            wvt = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
            fpt = np.array(msg["view_projection_matrix"],
                           np.float32).reshape(4, 4)
            wvt[:, 1] = -wvt[:, 1]
            wvt[:, 2] = -wvt[:, 2]
            fpt[:, 1] = -fpt[:, 1]
            return ViewerCamera(
                width=w, height=h,
                fovx=msg["fov_x"], fovy=msg["fov_y"],
                znear=msg["z_near"], zfar=msg["z_far"],
                world_view_transform=wvt, full_proj_transform=fpt,
                do_training=bool(msg.get("train", True)),
                keep_alive=bool(msg.get("keep_alive", True)),
                scaling_modifier=float(msg.get("scaling_modifier", 1.0)),
                shs_python=bool(msg.get("shs_python", False)),
                rot_scale_python=bool(msg.get("rot_scale_python", False)),
            )
        except KeyError:
            traceback.print_exc()
            return None

    def send(self, image_u8: Optional[np.ndarray], verify: str) -> None:
        """Raw RGB bytes, then the verify string's length (4 bytes, little
        endian) and the string (network_gui.py:66-72). A failed send closes
        the connection."""
        if self.conn is None:
            return
        try:
            if image_u8 is not None:
                self.conn.sendall(np.ascontiguousarray(image_u8).tobytes())
            self.conn.sendall(len(verify).to_bytes(4, "little"))
            self.conn.sendall(verify.encode("ascii"))
        except OSError:
            self.close_conn()

    def close_conn(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.close_conn()
        self.listener.close()
