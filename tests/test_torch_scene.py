"""The port's scene layer against the JAX package's: the Blender reader
(``scene/blender.py``) with its explicit test split, ``load_scene``'s
dataset sniffing, and the Scene / PartitionScene / SceneEval wrappers, on
the cases of ``tests/test_scene_wrappers.py`` and ``tests/test_blender.py``:
equal cameras, ``cameras.json``, ``input.ply`` bytes, train/test splits and
PLY names. Then ``cli.train --device cpu`` trains a Blender scene, which the
port's CLI could not before it called ``load_scene``."""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from pcp_tpu import scene as jscene
from pcp_tpu.models import GaussianConfig as JGCfg
from pcp_tpu.scene import cameras as jcam
from pcp_tpu.scene import wrappers as jwrap
from pcp_tpu_torch import scene as tscene
from pcp_tpu_torch.models.gaussians import GaussianConfig as TGCfg
from pcp_tpu_torch.scene import cameras as tcam
from pcp_tpu_torch.scene import wrappers as twrap
from tests.synthetic import write_synthetic_scene
from tests.test_blender import _write_blender_fixture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # The suite runs in parallel workers, and a multithreaded CPU torch then
    # oversubscribes the cores (a step of these small scenes waits on idle
    # threads); one thread runs them about as fast as eight do alone.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    """The fixture's frames only: each test loads a copy, since the readers
    persist their random init (points3d.ply) into the scene's directory."""
    root = tmp_path_factory.mktemp("blender")
    _write_blender_fixture(root, np.random.default_rng(3))
    return root


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("wscene")
    write_synthetic_scene(str(d), np.random.default_rng(13), n_points=100,
                          n_cams=6)
    return str(d)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _same_cameras(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        for f in ("uid", "image_id", "fovx", "fovy", "width", "height",
                  "image_name"):
            assert getattr(ca, f) == getattr(cb, f), f
        np.testing.assert_array_equal(ca.R, cb.R)
        np.testing.assert_array_equal(ca.t, cb.t)
        np.testing.assert_array_equal(ca.alpha_bg, cb.alpha_bg)


@pytest.mark.parametrize("eval_split", [True, False])
def test_blender_scene_matches(blender_dir, tmp_path, eval_split):
    # each package draws and persists its own random init in its own copy
    j_dir = _copy(blender_dir, tmp_path / "j")
    t_dir = _copy(blender_dir, tmp_path / "t")
    j = jscene.load_blender_scene(j_dir, eval_split=eval_split, seed=0,
                                  num_random_points=500)
    t = tscene.load_blender_scene(t_dir, eval_split=eval_split, seed=0,
                                  num_random_points=500)
    _same_cameras(t.cameras, j.cameras)
    assert t.test_camera_uids == j.test_camera_uids
    assert len(t.test_camera_uids) == (2 if eval_split else 0)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.extent == j.extent
    assert (tmp_path / "t" / "points3d.ply").read_bytes() == \
        (tmp_path / "j" / "points3d.ply").read_bytes()
    for explicit in (True, False):
        t_split = tscene.split_train_test(
            t.cameras, True, 3, explicit_test=t.test_camera_uids
            if explicit else None)
        j_split = jscene.split_train_test(
            j.cameras, True, 3, explicit_test=j.test_camera_uids
            if explicit else None)
        for ts, js in zip(t_split, j_split):
            assert [c.uid for c in ts] == [c.uid for c in js]


def test_blender_gt_composites_as_jax(blender_dir, tmp_path):
    src = _copy(blender_dir, tmp_path / "src")
    j = jscene.load_blender_scene(src, white_background=True,
                                  num_random_points=10)
    t = tscene.load_blender_scene(src, white_background=True,
                                  num_random_points=10)
    jc = jcam.from_info(j.cameras[0], 1)
    tc = tcam.from_info(t.cameras[0], 1)
    assert tc.gt_image.shape == (48, 64, 3)
    np.testing.assert_array_equal(tc.gt_image, jc.gt_image)
    np.testing.assert_array_equal(tc.viewmat, jc.viewmat)
    for c in t.cameras:
        np.testing.assert_allclose(np.linalg.norm(c.center[:2]), 5.0,
                                   atol=1e-5)


def test_load_scene_sniffs_like_jax(blender_dir, synth, tmp_path):
    src = _copy(blender_dir, tmp_path / "src")
    t = tscene.load_scene(src, eval_split=True)
    assert t.test_camera_uids == jscene.load_scene(
        src, eval_split=True).test_camera_uids
    assert len(t.test_camera_uids) == 2
    c = tscene.load_scene(synth)
    assert not c.test_camera_uids and len(c.cameras) == 6
    assert set(tscene.scene_load_callbacks) == {"Colmap", "Blender"}


def test_scene_wrapper_matches(synth, tmp_path):
    kw = dict(resolution=1, eval=True, llffhold=3)
    j = jwrap.Scene(synth, str(tmp_path / "j"), **kw)
    t = twrap.Scene(synth, str(tmp_path / "t"), **kw)
    for name in ("cameras.json", "input.ply"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
    assert len(json.loads((tmp_path / "t" / "cameras.json").read_text())) == 6
    assert [c.image_name for c in t.train_cameras] == \
        [c.image_name for c in j.train_cameras]          # same shuffle
    assert [c.image_name for c in t.test_cameras] == \
        [c.image_name for c in j.test_cameras]
    assert len(t.test_cameras) == 2 and t.cameras_extent == j.cameras_extent

    params, alive = t.create_gaussians(TGCfg(capacity=128), "cpu")
    t.save(params, alive, 30)
    j_params, j_alive = j.create_gaussians(JGCfg(capacity=128))
    j.save(j_params, j_alive, 30)
    ply = os.path.join("point_cloud", "iteration_30", "point_cloud_1.ply")
    assert os.path.exists(tmp_path / "t" / ply)
    np.testing.assert_allclose(
        params["xyz"][alive].numpy(),
        np.asarray(j_params["xyz"])[np.asarray(j_alive)], rtol=1e-6)
    again = twrap.Scene(synth, str(tmp_path / "t"), resolution=1,
                        load_iteration=-1)
    assert again.loaded_iter == 30
    p2, a2 = again.create_gaussians(TGCfg(capacity=128), "cpu")
    assert (p2["xyz"][a2] == params["xyz"][alive]).all()


def test_partition_scene_and_eval_names(synth, tmp_path):
    ps = twrap.PartitionScene("07", synth, str(tmp_path / "pm"), resolution=1)
    jps = jwrap.PartitionScene("07", synth, str(tmp_path / "jpm"),
                               resolution=1)
    assert ps.ply_path(5).replace(str(tmp_path / "pm"), "") == \
        jps.ply_path(5).replace(str(tmp_path / "jpm"), "")
    params, alive = ps.create_gaussians(TGCfg(capacity=128), "cpu")
    ps.save(params, alive, 5)
    assert (tmp_path / "pm" / "point_cloud" / "iteration_5" /
            "07_point_cloud.ply").exists()

    from pcp_tpu_torch.models.gaussians import save_gaussians_ply

    save_gaussians_ply(str(tmp_path / "pm" / "point_cloud.ply"), params,
                       alive)
    ev = twrap.SceneEval(synth, str(tmp_path / "pm"), resolution=1,
                         llffhold=3)
    assert ev.ply == str(tmp_path / "pm" / "point_cloud.ply")
    p, a = ev.load_gaussians(device="cpu")
    assert int(a.sum()) == int(alive.sum())
    assert [c.image_name for c in ev.test_cameras] == [
        c.image_name for c in jwrap.SceneEval(
            synth, str(tmp_path / "pm"), resolution=1,
            llffhold=3).test_cameras]


def test_cli_train_trains_a_blender_scene(blender_dir, tmp_path,
                                          monkeypatch):
    from pcp_tpu_torch.cli import train
    from pcp_tpu_torch.train import loop

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))
    src = _copy(blender_dir, tmp_path / "src")
    out = tmp_path / "out"
    state = train.main([
        "-s", src, "-m", str(out), "--device", "cpu", "--eval",
        "--resolution", "1", "--sh_degree", "1", "--iterations", "20",
        "--capacity", "512", "--max_per_tile", "64", "--densify_from_iter",
        "1000", "--no_appearance", "--save_iterations", "20",
        "--test_iterations", "20", "--quiet", "-w"])
    assert (out / "point_cloud" / "iteration_20" / "point_cloud.ply").exists()
    assert state.opt_g["count"] == 20 and int(state.alive.sum()) == 512
    m = json.loads((out / "eval_20.json").read_text())
    assert np.isfinite(m["psnr"])
