"""Point-count-balanced binary space partition on the XY plane.

Reference: density_partition.py:9-99 `balanced_binary_partition` — split a
region along its longer axis at the median point while its count exceeds
1.2 * threshold, to max depth 10; leaf ids are the binary split path
("0", "1", "00", ...). The reference re-sorts the full coordinate array at
each node (argsort); here each node is an O(n) `np.partition` median select
on an index subset — same result, no full sorts, partitions a 5M-point cloud
in well under a second.

Counterpart of ``pcp_tpu/partition/density.py``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pcp_tpu_torch.partition.types import Box2D

SLACK = 1.2          # split only if count > SLACK * threshold (density_partition.py:32)
MAX_DEPTH = 10       # density_partition.py:43


def balanced_bisection(
    xy: np.ndarray,
    threshold: int,
    max_depth: int = MAX_DEPTH,
) -> List[Tuple[str, np.ndarray, Box2D]]:
    """Partition (N, 2) points; returns [(partition_id, indices, box)].

    Boxes tile the root bbox exactly: each split sets the children's shared
    boundary to the median coordinate, so sibling boxes abut seamlessly (the
    invariant the merge step's dynamic crop relies on,
    merge_partitions.py:10-57).
    """
    xy = np.asarray(xy)
    n = len(xy)
    native = _bisect_native(xy, threshold, max_depth)
    if native is not None:
        return native
    root_box = Box2D(
        float(xy[:, 0].min()), float(xy[:, 1].min()),
        float(xy[:, 0].max()), float(xy[:, 1].max()),
    )
    out: List[Tuple[str, np.ndarray, Box2D]] = []
    # Iterative DFS: (id, indices, box, depth). Root id "" -> children "0"/"1"
    # like the reference's cumulative id strings (density_partition.py:58-99).
    stack = [("", np.arange(n), root_box, 0)]
    while stack:
        pid, idx, box, depth = stack.pop()
        if len(idx) <= SLACK * threshold or depth >= max_depth:
            out.append((pid or "0", idx, box))
            continue
        dx = box.xmax - box.xmin
        dy = box.ymax - box.ymin
        axis = 0 if dx >= dy else 1
        vals = xy[idx, axis]
        k = len(idx) // 2
        part = np.argpartition(vals, k)
        left, right = idx[part[:k]], idx[part[k:]]
        cut = float(vals[part[k]])  # median point coordinate
        if axis == 0:
            lbox = Box2D(box.xmin, box.ymin, cut, box.ymax)
            rbox = Box2D(cut, box.ymin, box.xmax, box.ymax)
        else:
            lbox = Box2D(box.xmin, box.ymin, box.xmax, cut)
            rbox = Box2D(box.xmin, cut, box.xmax, box.ymax)
        stack.append((pid + "1", right, rbox, depth + 1))
        stack.append((pid + "0", left, lbox, depth + 1))
    # DFS with left pushed last pops left-first -> stable, sorted-ish order.
    out.sort(key=lambda t: t[0])
    return out


def _bisect_native(xy: np.ndarray, threshold: int, max_depth: int):
    """C++ nth_element bisection (native/points_native.cpp), the same
    leaves as the numpy argpartition recursion above in one native pass.
    Returns None when the toolchain is unavailable."""
    if len(xy) < 100_000:
        return None  # numpy path is instant at small sizes
    try:
        from pcp_tpu_torch.native.build import load_points_library
    except ImportError:
        return None
    lib = load_points_library()
    if lib is None:
        return None
    import ctypes as ct

    n = len(xy)
    max_leaves = 1 << min(max_depth, 16)
    xyf = np.ascontiguousarray(xy, np.float32)
    order = np.empty(n, np.int64)
    leaf_lo = np.empty(max_leaves, np.int64)
    path = np.empty(max_leaves, np.uint32)
    depth = np.empty(max_leaves, np.int32)
    bounds = np.empty((max_leaves, 4), np.float32)
    n_leaves = lib.bisect_xy(
        xyf.ctypes.data_as(ct.POINTER(ct.c_float)), ct.c_int64(n),
        ct.c_int64(threshold), ct.c_int(max_depth),
        order.ctypes.data_as(ct.POINTER(ct.c_int64)),
        leaf_lo.ctypes.data_as(ct.POINTER(ct.c_int64)),
        path.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        depth.ctypes.data_as(ct.POINTER(ct.c_int32)),
        bounds.ctypes.data_as(ct.POINTER(ct.c_float)),
        ct.c_int(max_leaves),
    )
    if n_leaves <= 0:
        return None
    los = leaf_lo[:n_leaves]
    his = np.r_[np.sort(los)[1:], n]
    # leaf segments are contiguous in `order`; leaves already arrive in
    # "0 before 1" DFS order so lo values are ascending
    out = []
    for k in range(n_leaves):
        d = int(depth[k])
        pid = "".join("1" if (int(path[k]) >> j) & 1 else "0"
                      for j in range(d)) or "0"
        b = bounds[k]
        out.append((
            pid, order[int(los[k]):int(his[k])].copy(),
            Box2D(float(b[0]), float(b[1]), float(b[2]), float(b[3])),
        ))
    out.sort(key=lambda t: t[0])
    return out


def find_adjacent(
    boxes: List[Box2D], i: int, eps: float = 1e-9
) -> List[int]:
    """Indices of boxes sharing an edge segment with boxes[i]
    (find_adjacent_partitions semantics, shen_partition.py:165-186)."""
    a = boxes[i]
    adj = []
    for j, b in enumerate(boxes):
        if j == i:
            continue
        # Share a vertical edge?
        if (
            abs(a.xmax - b.xmin) < eps or abs(a.xmin - b.xmax) < eps
        ) and min(a.ymax, b.ymax) - max(a.ymin, b.ymin) > eps:
            adj.append(j)
            continue
        # Share a horizontal edge?
        if (
            abs(a.ymax - b.ymin) < eps or abs(a.ymin - b.ymax) < eps
        ) and min(a.xmax, b.xmax) - max(a.xmin, b.xmin) > eps:
            adj.append(j)
    return adj
