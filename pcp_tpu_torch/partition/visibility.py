"""Visibility-based camera selection: batched projection + hull-area ratio.

Reference: shen_partation_densify.py:410-539, 890-954. For each block, the
voxel-downsampled block cloud is projected into every assigned camera; the
camera is kept iff area(convex hull of projections ∩ image rect) / image
area >= 0.45 (:930). The reference does this with a 48-thread pool issuing
one torch CUDA matmul per camera; here one batched einsum projects the cloud
into all cameras at once, and the per-camera hulls (tiny work) run on host
via scipy.

Note: the reference's live "in front of camera" test uses the +Y axis
(points_camera[:, 1] > 0, shen_partation_densify.py:447) — a dataset-specific
hack (SURVEY §2.5 defect 5; the legacy copy uses +Z, shen_partition.py:501).
We use the geometrically correct +Z.

Counterpart of ``pcp_tpu/partition/visibility.py``.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

from pcp_tpu_torch.scene.dataset import CameraInfo

VISIBLE_RATE_THRESHOLD = 0.45  # shen_partation_densify.py:930


def project_points_batched(
    points: np.ndarray,          # (N, 3)
    Rs: np.ndarray,              # (K, 3, 3) world->cam
    ts: np.ndarray,              # (K, 3)
    fx: np.ndarray, fy: np.ndarray, cx: np.ndarray, cy: np.ndarray,  # (K,)
) -> Tuple[np.ndarray, np.ndarray]:
    """All points into all cameras at once.

    Returns (pix (K, N, 2), in_front (K, N) bool).
    """
    p_cam = np.einsum("kij,nj->kni", Rs, points) + ts[:, None, :]
    z = p_cam[..., 2]
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    px = p_cam[..., 0] / zs * fx[:, None] + cx[:, None]
    py = p_cam[..., 1] / zs * fy[:, None] + cy[:, None]
    return np.stack([px, py], axis=-1), in_front


def _clip_poly_halfplane(poly: np.ndarray, a: float, b: float, c: float) -> np.ndarray:
    """Sutherland–Hodgman clip of polygon (M, 2) to ax + by <= c."""
    if len(poly) == 0:
        return poly
    d = poly @ np.array([a, b]) - c
    out = []
    m = len(poly)
    for i in range(m):
        j = (i + 1) % m
        pi, pj = poly[i], poly[j]
        di, dj = d[i], d[j]
        if di <= 0:
            out.append(pi)
            if dj > 0:
                out.append(pi + (pj - pi) * (di / (di - dj)))
        elif dj <= 0:
            out.append(pi + (pj - pi) * (di / (di - dj)))
    return np.asarray(out) if out else np.zeros((0, 2))


def _poly_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def hull_area_ratio(pix: np.ndarray, width: float, height: float,
                    ordered: bool = False) -> float:
    """area(convexhull(pix) ∩ [0,W]x[0,H]) / (W*H) — run_graham_scan
    semantics (graham_scan.py:31-105).

    ``ordered=True``: the points are hull support points in angular
    direction order, i.e. already a convex polygon traversal — skip the
    qhull call, a fixed overhead per camera."""
    if len(pix) <= 3:
        return 0.0
    if ordered:
        poly = pix
    else:
        from scipy.spatial import ConvexHull, QhullError

        try:
            hull = ConvexHull(pix)
        except QhullError:
            return 0.0
        poly = pix[hull.vertices]
    for a, b, c in ((-1, 0, 0), (1, 0, width), (0, -1, 0), (0, 1, height)):
        poly = _clip_poly_halfplane(poly, a, b, c)
        if len(poly) == 0:
            return 0.0
    return _poly_area(poly) / (width * height)


def _support_points(pix: np.ndarray, front: np.ndarray, k_dirs: int = 72):
    """Per-camera convex-hull support points in ``k_dirs`` directions.

    The hull of the support set equals the true hull up to an inscribed-
    polygon error of O((2 pi / K)^2) (< 0.4% area at K = 72), and reduces
    the per-camera hull from |cloud| points to <= K — the step that made
    exact ConvexHulls over 10^5-point projections the partitioner's
    bottleneck. Vectorized: one masked argmax over points per direction.

    pix (C, N, 2), front (C, N) -> (C, K, 2) support coordinates and a
    (C,) count of in-front points.
    """
    c, n, _ = pix.shape
    ang = np.linspace(0.0, 2.0 * np.pi, k_dirs, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=1)  # (K, 2)
    neg = np.float32(-1e30)
    out = np.empty((c, k_dirs, 2), np.float32)
    px = np.where(front, pix[..., 0], 0.0).astype(np.float32)
    py = np.where(front, pix[..., 1], 0.0).astype(np.float32)
    for j in range(k_dirs):
        score = px * dirs[j, 0] + py * dirs[j, 1]
        score = np.where(front, score, neg)
        idx = np.argmax(score, axis=1)                    # (C,)
        rows = np.arange(c)
        out[:, j, 0] = px[rows, idx]
        out[:, j, 1] = py[rows, idx]
    return out, front.sum(axis=1)


def _pow2(n: int) -> int:
    return 1 << max(4, (n - 1).bit_length())


@functools.lru_cache(maxsize=2)
def _fib_sphere(k: int) -> np.ndarray:
    """(k, 3) roughly-uniform unit directions (Fibonacci sphere)."""
    i = np.arange(k, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / k)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
         np.cos(phi)], axis=1,
    ).astype(np.float32)


def _support_decimate_3d(points: np.ndarray, k_dirs: int = 128,
                         max_scan: int = 65536) -> np.ndarray:
    """Unique 3-D directional support points (approximate hull vertices).

    The (N, K) score matrix is the cost, so directions scan a strided
    <=``max_scan`` subsample; the
    six exact per-axis extremes of the FULL cloud are appended so the
    bounding box stays tight regardless of the stride."""
    sub = points[:: max(1, len(points) // max_scan)]
    dirs = _fib_sphere(k_dirs)
    scores = sub.astype(np.float32) @ dirs.T           # (n_sub, K)
    idx = np.unique(np.argmax(scores, axis=0))
    axis_ext = np.concatenate(
        [points[points.argmin(axis=0)], points[points.argmax(axis=0)]]
    )
    return np.concatenate([sub[idx], axis_ext])




def select_cameras_by_visibility(
    block_points: np.ndarray,
    cameras: Sequence[CameraInfo],
    threshold: float = VISIBLE_RATE_THRESHOLD,
    cam_batch: int = 128,
) -> List[int]:
    """Filter ``cameras`` to those that see >= threshold of the image area
    covered by the block's hull (visibility_based_camera_selection,
    shen_partation_densify.py:911-954). Returns kept camera uids."""
    if len(cameras) == 0 or len(block_points) < 4:
        return []
    Rs = np.stack([c.R for c in cameras]).astype(np.float32)
    ts = np.stack([c.t for c in cameras]).astype(np.float32)
    focals = np.array([c.focal() for c in cameras], np.float32)
    cxs = np.array([c.width / 2.0 for c in cameras], np.float32)
    cys = np.array([c.height / 2.0 for c in cameras], np.float32)
    block_points = np.ascontiguousarray(block_points, np.float32)

    # Reduce the cloud to ~10^2 directional support points of its 3-D hull:
    # a perspective projection maps a convex polytope to the hull of its
    # vertex projections (all-in-front case), so per-camera hull areas only
    # need extreme points, not the 10^5-point cloud. 128 Fibonacci-sphere
    # directions bound the hull within a sub-percent area error; cameras
    # with support points behind the near plane get a slightly conservative
    # area (masked) — those sit inside the block and pass the threshold
    # anyway. This spares full-cloud scans per camera and subsumes the
    # reference's voxel-downsample-before-projecting speed hack
    # (shen_partation_densify.py:928).
    if len(block_points) > 1024:
        block_points = _support_decimate_3d(block_points)

    kept: List[int] = []
    for s in range(0, len(cameras), cam_batch):
        sl = slice(s, min(s + cam_batch, len(cameras)))
        pix, front = project_points_batched(
            block_points, Rs[sl], ts[sl],
            focals[sl, 0], focals[sl, 1], cxs[sl], cys[sl],
        )
        support, n_front = _support_points(pix, front)
        # vectorized bbox pre-reject: the support bbox OVERestimates the
        # hull, so bbox∩rect below threshold certainly rejects
        bx0 = np.maximum(support[..., 0].min(axis=1), 0.0)
        by0 = np.maximum(support[..., 1].min(axis=1), 0.0)
        ws = np.array([c.width for c in cameras[sl]], np.float32)
        hs = np.array([c.height for c in cameras[sl]], np.float32)
        bx1 = np.minimum(support[..., 0].max(axis=1), ws)
        by1 = np.minimum(support[..., 1].max(axis=1), hs)
        bbox_ratio = (
            np.maximum(bx1 - bx0, 0.0) * np.maximum(by1 - by0, 0.0)
        ) / (ws * hs)
        for k, cam in enumerate(cameras[sl]):
            if n_front[k] <= 3 or bbox_ratio[k] < threshold:
                continue
            if hull_area_ratio(support[k], cam.width, cam.height,
                               ordered=True) >= threshold:
                kept.append(cam.uid)
    return kept
