"""Point-cloud hygiene ops: radius outlier removal and voxel downsampling.

Replace the reference's open3d calls (shen_partition_utils.py:28-55
`remove_outliers` with nb_points=5, radius=1.0) and the Python-dict voxel
loop (shen_partation_densify.py:541-614 `downsample_point_cloud`,
voxel_size=0.1) with vectorized numpy grid hashing — the dict loop is the
partitioner's top hot spot in the reference (SURVEY §3.1).

Counterpart of ``pcp_tpu/partition/points.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device


def _cell_ids(q: np.ndarray) -> np.ndarray:
    """Unique int64 id per 3D integer cell (collision-free by construction:
    coordinates are shifted non-negative and packed in 21-bit fields)."""
    q = q - q.min(axis=0)
    assert q.max() < (1 << 21), "grid too fine for 21-bit packing"
    return (q[:, 0].astype(np.int64) << 42) | (q[:, 1].astype(np.int64) << 21) | q[:, 2].astype(np.int64)


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     colors: np.ndarray = None):
    """Centroid per occupied voxel (open3d voxel_down_sample semantics).

    Returns points (M, 3) [and colors (M, 3) if given].
    """
    q = np.floor(points / voxel_size).astype(np.int64)
    ids = _cell_ids(q)
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    starts = np.flatnonzero(np.r_[True, ids_s[1:] != ids_s[:-1]])
    counts = np.diff(np.r_[starts, len(ids_s)])
    sums = np.add.reduceat(points[order], starts, axis=0)
    out_pts = sums / counts[:, None]
    if colors is None:
        return out_pts
    csums = np.add.reduceat(colors[order], starts, axis=0)
    return out_pts, csums / counts[:, None]


def _neighborhood_cell_counts(ids: np.ndarray, dims: np.ndarray,
                              counts_per_point: bool = True):
    """Per-point (or per-unique-cell) total occupancy of the 27-cell
    neighbourhood, fully vectorized: one np.unique + 27 searchsorted passes
    over the UNIQUE cells (not the points)."""
    uniq, inv, cnt = np.unique(ids, return_inverse=True, return_counts=True)
    strides = np.array([dims[1] * dims[2], dims[2], 1], np.int64)
    total = np.zeros(len(uniq), np.int64)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                off = ox * strides[0] + oy * strides[1] + oz * strides[2]
                pos = np.searchsorted(uniq, uniq + off)
                pos_c = np.clip(pos, 0, len(uniq) - 1)
                hit = uniq[pos_c] == uniq + off
                total += np.where(hit, cnt[pos_c], 0)
    return (total[inv] if counts_per_point else total), uniq, inv, cnt


def _grid_screen(points: np.ndarray, nb_points: int, radius: float,
                 device: DeviceLike = None):
    """Dense-grid neighbour-count bounds on ``device`` (counterpart of
    ``pcp_tpu/partition/points.py`` ``_grid_screen_tpu``): returns
    (certain_in, certain_out) bool masks, or None when the grid would
    exceed 2^28 cells (~1 GB of int32).

    One r/4 occupancy grid (``torch.bincount``, no weights: integer counts,
    exact in any order and allowed under deterministic algorithms) and a
    3-D integral image (three int32 cumsums); per-point box counts are
    8-corner gathers:
    - inner box |d| <= 1 (3^3 cells of side r/4): two points in cells with
      per-axis offset <= 1 are at most 2*(r/4)*sqrt(3) = 0.87r apart
      -> count >= nb+1 certainly keeps the point;
    - outer box |d| <= 5: every point within r lies inside (min distance of
      a |d| = 6 cell is 5 * r/4 > r) -> count < nb+1 certainly removes it.
    """
    s = radius / 4.0
    q = np.floor(points / s).astype(np.int64)
    q -= q.min(axis=0)
    dims = q.max(axis=0) + 1
    n_cells = int(np.prod(dims.astype(np.int64)))
    if n_cells > (1 << 28):  # ~1 GB grid: the host path takes it
        return None
    dev = resolve_device(device)
    dx, dy, dz = (int(d) for d in dims)
    qt = torch.as_tensor(q, device=dev)
    flat = (qt[:, 0] * dy + qt[:, 1]) * dz + qt[:, 2]
    # integral image: I[a,b,c] = count of cells [0..a) x [0..b) x [0..c);
    # int32 throughout (torch.cumsum promotes ints to int64 unless told)
    integ = torch.zeros((dx + 1, dy + 1, dz + 1), dtype=torch.int32,
                        device=dev)
    integ[1:, 1:, 1:] = torch.bincount(flat, minlength=n_cells).reshape(
        dx, dy, dz)
    for axis in range(3):
        integ = torch.cumsum(integ, axis, dtype=torch.int32)
    integ = integ.reshape(-1)
    hi_lim = torch.tensor([dx, dy, dz], device=dev)

    def box_count(reach: int) -> torch.Tensor:
        lo = torch.clamp(qt - reach, min=0)
        hi = torch.minimum(qt + reach + 1, hi_lim)

        def corner(a, b, c):
            return integ[(a * (dy + 1) + b) * (dz + 1) + c]

        a0, b0, c0 = lo.unbind(1)
        a1, b1, c1 = hi.unbind(1)
        return (corner(a1, b1, c1) - corner(a0, b1, c1)
                - corner(a1, b0, c1) - corner(a1, b1, c0)
                + corner(a0, b0, c1) + corner(a0, b1, c0)
                + corner(a1, b0, c0) - corner(a0, b0, c0))

    inner = box_count(1).cpu().numpy()
    outer = box_count(5).cpu().numpy()
    return inner - 1 >= nb_points, outer - 1 < nb_points


def _radius_outlier_native(points: np.ndarray, nb_points: int,
                           radius: float):
    """C++ grid-hash + early-exit filter (native/points_native.cpp): the
    primary path, exact. Returns None if the toolchain is missing."""
    try:
        from pcp_tpu_torch.native.build import load_points_library
    except ImportError:
        return None
    lib = load_points_library()
    if lib is None:
        return None
    import ctypes as ct

    pts = np.ascontiguousarray(points, np.float32)
    keep = np.zeros(len(pts), np.uint8)
    rc = lib.radius_outlier_filter(
        pts.ctypes.data_as(ct.POINTER(ct.c_float)),
        ct.c_int64(len(pts)),
        ct.c_int32(nb_points),
        ct.c_float(radius),
        keep.ctypes.data_as(ct.POINTER(ct.c_uint8)),
    )
    if rc != 0:
        return None
    return keep.astype(bool)


def compact_by_mask(points: np.ndarray, mask: np.ndarray):
    """(points[mask], flatnonzero(mask)) in one native pass in place of
    numpy's fancy indexing."""
    try:
        from pcp_tpu_torch.native.build import load_points_library

        lib = load_points_library()
    except ImportError:
        lib = None
    if lib is None:
        idx = np.flatnonzero(mask)
        return points[idx], idx
    import ctypes as ct

    pts = np.ascontiguousarray(points, np.float32)
    m = int(mask.sum())
    out = np.empty((m, 3), np.float32)
    idx = np.empty(m, np.int64)
    lib.compact_points(
        pts.ctypes.data_as(ct.POINTER(ct.c_float)),
        np.ascontiguousarray(mask, np.uint8).ctypes.data_as(
            ct.POINTER(ct.c_uint8)),
        ct.c_int64(len(pts)),
        out.ctypes.data_as(ct.POINTER(ct.c_float)),
        idx.ctypes.data_as(ct.POINTER(ct.c_int64)),
    )
    return out, idx


def radius_outlier_removal(
    points: np.ndarray, nb_points: int = 5, radius: float = 1.0,
    device: DeviceLike = None,
) -> np.ndarray:
    """Keep points having >= nb_points neighbours within ``radius``
    (open3d remove_radius_outlier semantics; self excluded). Returns a bool
    keep-mask. EXACT at every size.

    Large clouds use a two-grid screen that resolves almost every point in
    O(N) vectorized passes, in place of the brute kNN/tree path:

    1. coarse cells of side ``radius``: if the 27-cell neighbourhood holds
       fewer than nb_points+1 points, the point is certainly an outlier
       (every neighbour within r lives in those cells);
    2. fine cells of side ``radius``/4: if the 27-cell fine neighbourhood
       (max inter-point gap 0.87r < r) holds >= nb_points+1 points, the
       point certainly has enough neighbours;
    3. the (few) unresolved points get exact distance counts from a
       cKDTree built ONLY on the points in their coarse neighbourhoods.

    Dispatch: the native C++ filter first; without it, clouds above 500k
    points take their screens from ``_grid_screen`` on ``device`` (the
    card unless ``"cpu"``), and on the CPU from the host grids below, as
    JAX's CPU backend does.
    """
    n = len(points)
    native = _radius_outlier_native(points, nb_points, radius)
    if native is not None:
        return native
    if n > 500_000:
        r = float(radius)
        screens = (None if resolve_device(device).type == "cpu"
                   else _grid_screen(points, nb_points, r, device))
        if screens is not None:
            certain_in, certain_out = screens
        else:
            # host fallback: sparse 27-cell bounds via sorted unique cells
            q = np.floor(points / r).astype(np.int64)
            q -= q.min(axis=0)
            dims = q.max(axis=0) + 2
            ids = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
            nbhd, uniq, inv, cnt = _neighborhood_cell_counts(ids, dims)
            certain_out = nbhd - 1 < nb_points

            # fine screen: side r/4 — ANY two points in a 27-cell
            # neighbourhood of an r/4 grid are within r (max gap =
            # sqrt(3) * 2 * r/4 < r), so a 27-cell count >= nb+1 certainly
            # keeps the point.
            rf = r / 4.0
            qf = np.floor(points / rf).astype(np.int64)
            qf -= qf.min(axis=0)
            dimsf = qf.max(axis=0) + 2
            idsf = (qf[:, 0] * dimsf[1] + qf[:, 1]) * dimsf[2] + qf[:, 2]
            nbhdf, _, _, _ = _neighborhood_cell_counts(idsf, dimsf)
            certain_in = nbhdf - 1 >= nb_points

        keep = certain_in & ~certain_out
        unresolved = ~certain_in & ~certain_out
        if unresolved.any():
            # exact pass over the unresolved minority: tree over candidate
            # points (those sharing a coarse neighbourhood with them)
            q = np.floor(points / r).astype(np.int64)
            q -= q.min(axis=0)
            dims = q.max(axis=0) + 2
            ids = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
            un_cells = np.unique(ids[unresolved])
            strides = np.array([dims[1] * dims[2], dims[2], 1], np.int64)
            offs = np.array([
                ox * strides[0] + oy * strides[1] + oz * strides[2]
                for ox in (-1, 0, 1) for oy in (-1, 0, 1) for oz in (-1, 0, 1)
            ], np.int64)
            cand_cells = np.unique(un_cells[:, None] + offs[None, :])
            pos = np.searchsorted(cand_cells, ids)
            pos = np.clip(pos, 0, len(cand_cells) - 1)
            cand_mask = cand_cells[pos] == ids
            from scipy.spatial import cKDTree

            cand_pts = points[cand_mask].astype(np.float64)
            tree = cKDTree(cand_pts)
            nbh = tree.query_ball_point(
                points[unresolved].astype(np.float64), r,
                return_length=True, workers=-1,
            )
            keep[unresolved] = nbh - 1 >= nb_points  # self included in nbh
        return keep
    try:
        from scipy.spatial import cKDTree

        pts = np.ascontiguousarray(points, np.float64)
        tree = cKDTree(pts)
        k = min(nb_points + 1, n)  # +1: query returns the point itself first
        dist, _ = tree.query(pts, k=k, workers=-1)
        if k < nb_points + 1:
            return np.zeros(n, bool)
        return dist[:, -1] <= radius
    except ImportError:
        pass
    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    q = np.floor(points / radius).astype(np.int64)
    qmin = q.min(axis=0)
    q = q - qmin
    dims = q.max(axis=0) + 1
    ids = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
    order = np.argsort(ids, kind="stable")
    ids_s = ids[order]
    starts = np.flatnonzero(np.r_[True, ids_s[1:] != ids_s[:-1]])
    uniq = ids_s[starts]
    bounds = np.r_[starts, n]
    cell_of = {int(c): k for k, c in enumerate(uniq)}

    r2 = radius * radius
    counts = np.zeros(n, np.int64)
    pts_s = points[order]
    # For each occupied cell, gather candidates from the 27-neighbourhood
    # once and count pairwise hits (cells hold few points; the quadratic
    # term is local).
    for k in range(len(uniq)):
        c = int(uniq[k])
        cz = c % dims[2]
        cy = (c // dims[2]) % dims[1]
        cx = c // (dims[1] * dims[2])
        cand = []
        for ox in (-1, 0, 1):
            x = cx + ox
            if not 0 <= x < dims[0]:
                continue
            for oy in (-1, 0, 1):
                y = cy + oy
                if not 0 <= y < dims[1]:
                    continue
                for oz in (-1, 0, 1):
                    z = cz + oz
                    if not 0 <= z < dims[2]:
                        continue
                    cc = (x * dims[1] + y) * dims[2] + z
                    j = cell_of.get(int(cc))
                    if j is not None:
                        cand.append(np.arange(bounds[j], bounds[j + 1]))
        cand = np.concatenate(cand)
        mine = np.arange(bounds[k], bounds[k + 1])
        d2 = ((pts_s[mine, None, :] - pts_s[None, cand, :]) ** 2).sum(-1)
        counts[mine] = (d2 <= r2).sum(axis=1) - 1  # exclude self
    keep = np.zeros(n, bool)
    keep[order] = counts >= nb_points
    return keep
