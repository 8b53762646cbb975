"""The port's native host libraries (``pcp_tpu_torch/native``) against the
JAX package's: the COLMAP codec writes the same bytes as JAX's codec and as
the port's pure-Python path, on the cases of ``tests/test_colmap_io.py``;
the points filter keeps the same points as JAX's and as a brute-force
count; the ``nth_element`` bisection gives the same leaves. Without ``g++``
the loaders warn and the callers fall back to Python."""

import numpy as np
import pytest

from pcp_tpu.io import colmap as jcolmap
from pcp_tpu.partition import density as jdensity
from pcp_tpu.partition import points as jpoints
from pcp_tpu_torch.io import colmap as tcolmap
from pcp_tpu_torch.io import colmap_fast
from pcp_tpu_torch.native import build, load_library, load_points_library
from pcp_tpu_torch.partition import density as tdensity
from pcp_tpu_torch.partition import points as tpoints


def _model(mod, rng, n_pts=500):
    """Cameras, images with 2D tracks and -1 ids, points with tracks, in
    package ``mod``'s types (``make_model`` of tests/test_colmap_io.py at a
    larger point count)."""
    cameras = {
        1: mod.Camera(1, "PINHOLE", 1920, 1080,
                      np.array([1000.0, 990.0, 960.0, 540.0])),
        2: mod.Camera(2, "SIMPLE_PINHOLE", 640, 480,
                      np.array([500.0, 320.0, 240.0])),
    }
    images = {}
    for i in range(1, 6):
        q = rng.normal(size=4)
        n2d = int(rng.integers(0, 6))
        images[i] = mod.Image(
            id=i, qvec=q / np.linalg.norm(q), tvec=rng.normal(size=3),
            camera_id=1 + i % 2, name=f"img_{i:03d}.jpg",
            xys=rng.uniform(0, 640, size=(n2d, 2)),
            point3D_ids=rng.integers(-1, 50, size=n2d).astype(np.int64))
    tlen = rng.integers(0, 6, size=n_pts).astype(np.int64)
    total = int(tlen.sum())
    points = mod.Points3D(
        ids=rng.integers(1, 10**6, n_pts).astype(np.int64),
        xyz=rng.normal(size=(n_pts, 3)) * 10,
        rgb=rng.integers(0, 256, size=(n_pts, 3)).astype(np.uint8),
        error=rng.uniform(0, 2, size=n_pts),
        track_lengths=tlen,
        track_image_ids=rng.integers(1, 50, size=total).astype(np.int32),
        track_point2D_idxs=rng.integers(0, 1000, size=total).astype(np.int32),
    )
    return cameras, images, points


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_libraries_build_here():
    assert load_library() is not None and load_points_library() is not None
    for name in ("colmap_codec", "points_native"):
        assert build.library_path(name).exists()
        assert build.library_path(name).parent == build.BUILD_DIR


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_codec_bytes_equal_jax_and_python(tmp_path, monkeypatch, ext):
    j_dir, t_dir, py_dir = (tmp_path / n for n in ("jax", "port", "python"))
    jcolmap.write_model(*_model(jcolmap, np.random.default_rng(0)),
                        str(j_dir), ext=ext)
    model = _model(tcolmap, np.random.default_rng(0))
    tcolmap.write_model(*model, str(t_dir), ext=ext)
    with monkeypatch.context() as m:
        m.setattr(colmap_fast, "_lib", lambda: None)
        tcolmap.write_model(*model, str(py_dir), ext=ext)
        from_python = tcolmap.read_model(str(t_dir))
    assert _files(t_dir) == _files(j_dir) == _files(py_dir)

    native = tcolmap.read_model(str(j_dir))
    back = jcolmap.read_model(str(j_dir))
    for got in (native, from_python):
        cams, imgs, pts = got
        assert set(cams) == set(back[0]) and set(imgs) == set(back[1])
        for k in imgs:
            assert imgs[k].name == back[1][k].name
            np.testing.assert_array_equal(imgs[k].qvec, back[1][k].qvec)
            np.testing.assert_array_equal(imgs[k].xys, back[1][k].xys)
            np.testing.assert_array_equal(imgs[k].point3D_ids,
                                          back[1][k].point3D_ids)
        for f in ("ids", "xyz", "rgb", "error", "track_lengths",
                  "track_image_ids", "track_point2D_idxs"):
            np.testing.assert_array_equal(getattr(pts, f),
                                          getattr(back[2], f), err_msg=f)


def test_native_blob_equals_python_blob(tmp_path, monkeypatch):
    _, _, pts = _model(tcolmap, np.random.default_rng(1))
    blob = colmap_fast.write_points3d_binary_native(
        pts.ids, pts.xyz, pts.rgb, pts.error, pts.track_lengths,
        pts.track_image_ids, pts.track_point2D_idxs)
    monkeypatch.setattr(colmap_fast, "_lib", lambda: None)
    p = tmp_path / "points3D.bin"
    tcolmap.write_points3D_binary(pts, str(p))
    assert blob is not None and p.read_bytes() == blob


def _cloud(rng):
    """Clusters on a ground plane plus sparse outliers above it."""
    centers = rng.uniform(0, 20, (30, 3)) * [1, 1, 0.1]
    pts = centers[rng.integers(0, 30, 3000)] + rng.normal(0, 0.4, (3000, 3))
    noise = rng.uniform(-5, 25, (300, 3))
    return np.concatenate([pts, noise]).astype(np.float32)


def _brute_keep(points, nb, radius):
    d2 = ((points[:, None, :].astype(np.float64)
           - points[None, :, :]) ** 2).sum(-1)
    return (d2 <= radius * radius).sum(1) - 1 >= nb


def test_points_filter_matches_jax_and_brute_force():
    pts = _cloud(np.random.default_rng(2))
    keep = tpoints._radius_outlier_native(pts, 5, 1.0)
    assert keep is not None
    np.testing.assert_array_equal(keep, jpoints._radius_outlier_native(
        pts, 5, 1.0))
    np.testing.assert_array_equal(keep, _brute_keep(pts, 5, 1.0))
    assert 0 < keep.sum() < len(pts)
    np.testing.assert_array_equal(
        tpoints.radius_outlier_removal(pts, 5, 1.0, device="cpu"), keep)
    out, idx = tpoints.compact_by_mask(pts, keep)
    j_out, j_idx = jpoints.compact_by_mask(pts, keep)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(out, j_out)


def test_native_bisection_matches_jax():
    rng = np.random.default_rng(3)
    xy = rng.normal(size=(120_000, 2)) * [40.0, 15.0]
    leaves = tdensity._bisect_native(xy, 20_000, 10)
    j_leaves = jdensity._bisect_native(xy, 20_000, 10)
    assert leaves is not None and len(leaves) == len(j_leaves) > 2
    for (pid, idx, box), (j_pid, j_idx, j_box) in zip(leaves, j_leaves):
        assert pid == j_pid
        np.testing.assert_array_equal(box.as_array(), j_box.as_array())
        np.testing.assert_array_equal(idx, j_idx)


def test_without_gpp_the_codec_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path))          # no g++ on it
    with pytest.warns(UserWarning, match="falling back to pure Python"):
        assert load_library() is None
    with pytest.warns(UserWarning, match="falling back to numpy"):
        assert load_points_library() is None
    model = _model(tcolmap, np.random.default_rng(4), n_pts=20)
    tcolmap.write_model(*model, str(tmp_path / "m"), ext=".bin")
    _, _, pts = tcolmap.read_model(str(tmp_path / "m"))
    np.testing.assert_array_equal(pts.ids, model[2].ids)
    pts_xyz = _cloud(np.random.default_rng(5))[:400]
    np.testing.assert_array_equal(
        tpoints.radius_outlier_removal(pts_xyz, 5, 1.0, device="cpu"),
        _brute_keep(pts_xyz, 5, 1.0))
