"""The port's partition package against the JAX package's on the same
inputs: the cases of ``tests/test_partition.py``, ``tests/test_quadtree.py``
and ``tests/test_export_intrinsics.py`` run through both, and their outputs
must be equal: the bisection boxes and indices, the outlier masks, the grid
screen, the visibility selections, the camera-grid and quadtree regions,
every exported file's bytes and the records' fields (fields, not pickle
bytes: a pickle names its class's module)."""

import os
from pathlib import Path

import jax
import numpy as np
import pytest

from pcp_tpu import partition as jpart
from pcp_tpu.partition import camera_grid as jgrid
from pcp_tpu.partition import points as jpoints
from pcp_tpu.partition import quadtree as jquad
from pcp_tpu.partition.pipeline import PartitionConfig as JConfig
from pcp_tpu.partition.pipeline import run_partition as j_run
from pcp_tpu.scene import load_colmap_scene as j_load
from pcp_tpu_torch import partition as tpart
from pcp_tpu_torch.partition import camera_grid as tgrid
from pcp_tpu_torch.partition import points as tpoints
from pcp_tpu_torch.partition import quadtree as tquad
from pcp_tpu_torch.partition.export import load_partition_data
from pcp_tpu_torch.partition.pipeline import PartitionConfig as TConfig
from pcp_tpu_torch.partition.pipeline import run_partition as t_run
from pcp_tpu_torch.scene import load_colmap_scene as t_load


def _box(b):
    return (b.xmin, b.ymin, b.xmax, b.ymax)


def _same_leaves(a, b):
    assert [pid for pid, _, _ in a] == [pid for pid, _, _ in b]
    for (_, ia, ba), (_, ib, bb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        assert _box(ba) == _box(bb)


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.partition_id == rb.partition_id
        for f in ("origin_box", "extend_box", "point_box"):
            assert _box(getattr(ra, f)) == _box(getattr(rb, f)), f
        np.testing.assert_array_equal(ra.point_indices, rb.point_indices)
        assert list(ra.camera_uids) == list(rb.camera_uids)
        assert ra.point_num == rb.point_num


def _tree(root: Path, skip=(".pkl", ".png")):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix not in skip}


@pytest.mark.parametrize("threshold,depth", [(600, 10), (1, 3)])
def test_bisection_matches(rng, threshold, depth):
    xy = rng.normal(size=(5000, 2)).astype(np.float32) * [10, 3]
    _same_leaves(tpart.balanced_bisection(xy, threshold, depth),
                 jpart.balanced_bisection(xy, threshold, depth))


def test_find_adjacent_matches():
    from pcp_tpu.partition.density import find_adjacent as j_adj
    from pcp_tpu_torch.partition.density import find_adjacent as t_adj

    coords = [(0, 0, 1, 1), (1, 0, 2, 1), (0, 1, 2, 2), (5, 5, 6, 6)]
    t_boxes = [tpart.Box2D(*c) for c in coords]
    j_boxes = [jpart.Box2D(*c) for c in coords]
    for i in range(4):
        assert t_adj(t_boxes, i) == j_adj(j_boxes, i)
    assert t_adj(t_boxes, 0) == [1, 2]


def test_outliers_and_voxels_match(rng):
    pts = rng.uniform(0, 5, size=(300, 3))
    keep = tpart.radius_outlier_removal(pts, nb_points=4, radius=0.8,
                                        device="cpu")
    np.testing.assert_array_equal(
        keep, jpart.radius_outlier_removal(pts, nb_points=4, radius=0.8))
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(keep, (d2 <= 0.8 ** 2).sum(1) - 1 >= 4)
    np.testing.assert_array_equal(tpart.voxel_downsample(pts, 0.5),
                                  jpart.voxel_downsample(pts, 0.5))


def test_hull_ratio_matches():
    w, h = 100.0, 50.0
    for poly in ([[0, 0], [100, 0], [100, 50], [0, 50], [50, 25]],
                 [[0, 0], [50, 0], [50, 50], [0, 50]],
                 [[200, 200], [300, 200], [300, 300], [200, 300]],
                 [[-100, -100], [300, -100], [300, 300], [-100, 300]]):
        p = np.asarray(poly, float)
        assert tpart.hull_area_ratio(p, w, h) == jpart.hull_area_ratio(p, w, h)


def _ground_cloud(rng, n=6000):
    pts = np.stack([rng.uniform(-15, 15, n), rng.uniform(-15, 15, n),
                    rng.normal(0, 0.5, n)], -1)
    noise = rng.uniform(-20, 20, (200, 3))
    return np.concatenate([pts, noise]).astype(np.float32)


def test_grid_screen_matches_jax(rng, monkeypatch):
    """``_grid_screen`` on the CPU device against JAX's dense-grid screen
    (forced past its CPU-backend early return) on the same points: equal
    masks, and each bound true against a brute-force count."""
    pts = _ground_cloud(rng)
    inner, outer = tpoints._grid_screen(pts, 5, 1.0, "cpu")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    j_inner, j_outer = jpoints._grid_screen_tpu(pts, 5, 1.0)
    np.testing.assert_array_equal(inner, j_inner)
    np.testing.assert_array_equal(outer, j_outer)
    exact = tpoints._radius_outlier_native(pts, 5, 1.0)
    assert inner.any() and outer.any()
    assert exact[inner].all() and not exact[outer].any()


def test_grid_screen_dispatch_needs_the_card(monkeypatch):
    """Without the native filter a >500k cloud takes its screen from the
    card: no device means the card, which raises here; ``"cpu"`` takes
    the host screens."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    pts = np.zeros((500_001, 3), np.float32)
    monkeypatch.setattr(tpoints, "_radius_outlier_native",
                        lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpoints.radius_outlier_removal(pts, 5, 1.0)
    called = []
    monkeypatch.setattr(tpoints, "_grid_screen",
                        lambda *a: called.append(a) or None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpart.radius_outlier_removal(pts, 5, 1.0, device="cuda")
    assert not called


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from tests.synthetic import write_synthetic_scene

    d = tmp_path_factory.mktemp("pscene")
    write_synthetic_scene(str(d), np.random.default_rng(7), n_points=400,
                          n_cams=12)
    return str(d)


@pytest.mark.parametrize("partitioner,kw", [
    ("bisect", dict(threshold=100, remove_outliers=False)),
    ("bisect", dict(threshold=100, remove_outliers=True, outlier_radius=0.4,
                    outlier_nb_points=3)),
    ("quadtree", dict(threshold=120, remove_outliers=False)),
])
def test_run_partition_writes_the_same_files(synth, tmp_path, partitioner,
                                             kw):
    args = dict(expansion_distance=10.0, point_expand_ratio=0.1,
                visible_rate=0.05, voxel_size=0.05, make_plots=False,
                llffhold=4, partitioner=partitioner, **kw)
    j_root, t_root = tmp_path / "j", tmp_path / "t"
    j_recs = j_run(j_load(synth), str(j_root / "model"), JConfig(**args))
    t_recs = t_run(t_load(synth), str(t_root / "model"),
                   TConfig(device="cpu", **args))
    assert len(t_recs) >= 2
    _same_records(t_recs, j_recs)
    t_files = _tree(t_root)
    assert t_files == _tree(j_root)
    assert any(f.endswith("points3D.bin") for f in t_files)
    assert "test/sparse/0/images.bin" in t_files
    _same_records(load_partition_data(str(t_root / "model" /
                                          "partition_data.pkl")), j_recs)
    one = t_recs[0].partition_id
    with open(t_root / "model" / "split_result" / "visible" / one /
              f"partition_{one}.pkl", "rb") as f:
        import pickle

        rec = pickle.load(f)
    assert type(rec).__module__ == "pcp_tpu_torch.partition.types"


def test_visibility_selection_matches(synth):
    t_scene, j_scene = t_load(synth), j_load(synth)
    for sl in (slice(0, 150), slice(100, 400)):
        assert tpart.select_cameras_by_visibility(
            t_scene.points[sl], t_scene.cameras, 0.2) == \
            jpart.select_cameras_by_visibility(
                j_scene.points[sl], j_scene.cameras, 0.2)


@pytest.mark.parametrize("rate", [0.01, 0.99])
def test_camera_grid_matches(synth, rate):
    t_scene = t_load(synth, keep_point_ids=True)
    j_scene = j_load(synth, keep_point_ids=True)
    _same_records(
        tgrid.run_camera_grid_partition(
            t_scene, tgrid.CameraGridConfig(2, 2, visible_rate=rate)),
        jgrid.run_camera_grid_partition(
            j_scene, jgrid.CameraGridConfig(2, 2, visible_rate=rate)))
    centers = np.stack([c.center for c in t_scene.cameras])[:, :2]
    t_boxes = tgrid.refine_boxes(tgrid.camera_region_division(centers, 2, 2),
                                 centers, 2, 2)
    j_boxes = jgrid.refine_boxes(jgrid.camera_region_division(centers, 2, 2),
                                 centers, 2, 2)
    assert {k: _box(b) for k, b in t_boxes.items()} == \
        {k: _box(b) for k, b in j_boxes.items()}


def _regions(rs):
    return [(r.region_id, [_box(b) for b in r.boxes],
             r.point_indices.tolist(), [_box(b) for b in r.extend_boxes])
            for r in rs]


def test_quadtree_matches(rng):
    xy = rng.uniform(-10, 10, size=(5000, 2)).astype(np.float32)
    t_leaves = tquad.quad_tree_partition(xy, threshold=600)
    j_leaves = jquad.quad_tree_partition(xy, threshold=600)
    assert _regions(t_leaves) == _regions(j_leaves)
    t_f = tquad.filter_regions_by_point_count(t_leaves, 900)
    j_f = jquad.filter_regions_by_point_count(j_leaves, 900)
    assert _regions(t_f) == _regions(j_f) and len(t_f) < len(t_leaves)
    assert _regions(tquad.expand_regions(t_f, xy, 0.2)) == \
        _regions(jquad.expand_regions(j_f, xy, 0.2))
    a = tquad.Region("0", [tpart.Box2D(0, 0, 1, 1)], np.arange(5))
    b = tquad.Region("1", [tpart.Box2D(1, 0, 2, 1)], np.arange(5, 8))
    assert tquad.regions_adjacent(a, b)
    m = tquad.merge_regions(a, b)
    assert m.region_id == "0-1" and m.point_num == 8


def test_export_keeps_both_intrinsics_as_jax(tmp_path):
    """tests/test_export_intrinsics.py's scene (two PINHOLE intrinsics, ids
    1 and 7) exported by both packages: the same block bytes."""
    from pcp_tpu.io import colmap as jcolmap
    from pcp_tpu.partition.export import export_partition as j_export
    from pcp_tpu.utils.graphics import rotmat_to_qvec
    from pcp_tpu_torch.partition.export import export_partition as t_export

    rng = np.random.default_rng(0)
    src = tmp_path / "src"
    cams = {1: jcolmap.Camera(1, "PINHOLE", 64, 48,
                              np.array([80.0, 82.0, 32.0, 24.0])),
            7: jcolmap.Camera(7, "PINHOLE", 128, 96,
                              np.array([200.0, 195.0, 64.0, 48.0]))}
    imgs = {i + 1: jcolmap.Image(i + 1, rotmat_to_qvec(np.eye(3)),
                                 np.array([0.1 * i, 0.0, 2.0 + i]),
                                 1 if i % 2 == 0 else 7, f"im{i}.jpg")
            for i in range(6)}
    pts = jcolmap.Points3D.from_arrays(
        rng.uniform(-1, 1, (50, 3)),
        rng.integers(0, 255, (50, 3)).astype(np.uint8))
    jcolmap.write_model(cams, imgs, pts, str(src / "sparse" / "0"),
                        ext=".bin")
    outs = {}
    for tag, load, box_t, rec_t, export in (
            ("j", j_load, jpart.Box2D, jpart.PartitionRecord, j_export),
            ("t", t_load, tpart.Box2D, tpart.PartitionRecord, t_export)):
        scene = load(str(src))
        box = box_t(-10, -10, 10, 10)
        rec = rec_t(partition_id="0", origin_box=box, extend_box=box,
                    point_box=box, point_indices=np.arange(len(scene.points)),
                    camera_uids=list(range(len(scene.cameras))))
        block = export(scene, rec, str(tmp_path / tag / "visible"),
                       copy_images=False)
        outs[tag] = _tree(Path(block))
    assert outs["t"] == outs["j"]
    from pcp_tpu_torch.io import colmap as tcolmap

    bcams, bimgs, _ = tcolmap.read_model(
        str(tmp_path / "t" / "visible" / "0" / "partition_0" / "sparse" /
            "0"))
    assert set(bcams) == {1, 7}
    assert {im.name: im.camera_id for im in bimgs.values()} == {
        im.name: im.camera_id for im in imgs.values()}


def test_camera_lists_match(synth, tmp_path):
    from pcp_tpu.partition.camera_lists import write_camera_lists as j_write
    from pcp_tpu_torch.partition.camera_lists import (
        read_cam_list,
        write_camera_lists,
    )

    t_scene, j_scene = t_load(synth), j_load(synth)
    args = dict(threshold=150, visible_rate=0.05, expansion_distance=10.0,
                remove_outliers=False, make_plots=False)
    t_recs = t_run(t_scene, str(tmp_path / "tm"), TConfig(device="cpu",
                                                          **args),
                   export=False, save_test=False)
    j_recs = j_run(j_scene, str(tmp_path / "jm"), JConfig(**args),
                   export=False, save_test=False)
    write_camera_lists(t_scene, t_recs, str(tmp_path / "t"), 4)
    j_write(j_scene, j_recs, str(tmp_path / "j"), 4)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    names = read_cam_list(str(tmp_path / "t" / "test_cameras.txt"))
    assert len(names) == 3 and os.path.exists(
        tmp_path / "t" / f"{t_recs[0].partition_id}_camera.txt")
