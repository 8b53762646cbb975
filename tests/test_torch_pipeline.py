"""The reference workflow through the port's CLIs on the CPU, on
``tests/test_full_pipeline.py``'s scene (300 points, 12 cameras at 64x48):

(a) ``cli.partition --device cpu`` writes the same blocks, points, camera
    lists and held-out set as JAX's ``cli.partition`` with the same flags;
(b) ``partition -> auto_train --sequential -> merge -> render -> metrics``
    with ``--device cpu`` and that test's flags marks every block done,
    writes the merged PLY and two rendered views, and scores them above
    the JAX test's own thresholds (PSNR > 14, SSIM > 0.3);
(c) auto_train's other modes (the fleet, ``--intra_block 2`` over two gloo
    ranks, ``--distributed`` without torchrun's environment) train every
    block of the partitioned scene on the CPU and write its PLY.

Also the two small host CLIs: ``convert``'s COLMAP commands and its exit
when the binary is missing, and ``light``'s low-light lists, against JAX's.
"""

import functools
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

PARTITION_FLAGS = ["--threshold", "80", "--expansion_distance", "10",
                   "--visible_rate", "0.05", "--no_outlier_removal",
                   "--no_plots", "--llffhold", "6"]


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
def pipeline_dir(tmp_path_factory):
    from tests.synthetic import write_synthetic_scene

    d = tmp_path_factory.mktemp("pipe")
    write_synthetic_scene(str(d), np.random.default_rng(5), n_points=300,
                          n_cams=12, W=64, H=48)
    return str(d)


@pytest.fixture(autouse=True)
def _jsonl_only(monkeypatch):
    # the JSONL log only: importing TensorBoard costs a minute here
    from pcp_tpu_torch.train import loop

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix != ".pkl"}


def test_partition_cli_matches_jax(pipeline_dir, tmp_path):
    from pcp_tpu.cli import partition as j_partition
    from pcp_tpu_torch.cli import partition as t_partition

    j_partition.main([pipeline_dir, "--model_dir", str(tmp_path / "j" /
                                                      "model"),
                      *PARTITION_FLAGS])
    records = t_partition.main([pipeline_dir, "--model_dir",
                                str(tmp_path / "t" / "model"),
                                *PARTITION_FLAGS, "--device", "cpu"])
    t_files = _tree(tmp_path / "t")
    assert t_files == _tree(tmp_path / "j")
    blocks = sorted(os.listdir(tmp_path / "t" / "model" / "split_result" /
                               "visible"))
    assert len(blocks) >= 2 and blocks == sorted(
        r.partition_id for r in records)
    assert f"model/{blocks[0]}_camera.txt" in t_files
    assert "test/sparse/0/points3D.bin" in t_files
    assert any(k.endswith("/images.bin") and "/partition_" in k
               for k in t_files)


def test_pipeline_on_the_cpu(pipeline_dir, tmp_path, capsys):
    from pcp_tpu_torch.cli import auto_train, merge, metrics, partition, render

    scene = tmp_path / "scene"
    shutil.copytree(pipeline_dir, scene)
    model_dir = scene / "model"
    cpu = ["--device", "cpu"]

    partition.main([str(scene), *PARTITION_FLAGS, *cpu])
    visible = model_dir / "split_result" / "visible"
    blocks = sorted(os.listdir(visible))
    assert len(blocks) >= 2
    assert (scene / "test" / "sparse" / "0").is_dir()

    auto_train.main([
        "--base_path", str(visible), "--sequential", "--iterations", "80",
        "--capacity", "512", "--max_per_tile", "128",
        "--densify_from_iter", "30", "--densification_interval", "30",
        "--densify_until_iter", "70", "--resolution", "1", *cpu])
    manifest = json.loads((visible / "train_status.json").read_text())
    assert sorted(manifest) == blocks
    assert all(v["status"] == "done" for v in manifest.values()), manifest
    for b in blocks:
        assert (visible / b / f"partition_{b}" / "output" / "point_cloud" /
                "iteration_80" / f"{b}_point_cloud.ply").exists()
    # --retry_failed retrains only the blocks the manifest does not mark done
    auto_train.main(["--base_path", str(visible), "--sequential",
                     "--retry_failed", *cpu])
    assert json.loads((visible / "train_status.json").read_text()) == manifest
    assert "retrying 0 unfinished blocks" in capsys.readouterr().out

    merged = merge.main(["-m", str(model_dir), *cpu])
    assert (model_dir / "point_cloud.ply").exists()
    assert len(merged["xyz"]) > 300            # the blocks densified

    render.main(["-s", str(scene), "-m", str(model_dir), "--resolution", "1",
                 "--llffhold", "6", *cpu])
    method_dir = model_dir / "test" / "ours_merged"
    assert len(os.listdir(method_dir / "renders")) == 2   # 12 cams / 6

    metrics.main(["-m", str(model_dir), *cpu])
    results = json.loads((method_dir / "results.json").read_text())
    assert results["PSNR"] > 14.0, results
    assert results["SSIM"] > 0.3, results
    assert len(json.loads((method_dir / "per_view.json").read_text())) == 2
    assert (method_dir / "renders_cc").is_dir()


@pytest.mark.parametrize("flags", [[], ["--sequential", "--intra_block", "2"],
                                   ["--sequential", "--distributed"]])
def test_auto_train_multi_gpu_modes_train(pipeline_dir, tmp_path, flags,
                                          monkeypatch):
    from pcp_tpu_torch.cli import auto_train, partition
    from pcp_tpu_torch.parallel import distributed as pdist
    from pcp_tpu_torch.parallel.distributed import TORCHRUN_ENV

    monkeypatch.setattr(pdist, "JOIN_TIMEOUT_S", 120)
    monkeypatch.setenv("PCP_TENSORBOARD", "0")   # the spawned ranks' logs
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    scene = tmp_path / "scene"
    shutil.copytree(pipeline_dir, scene)
    partition.main([str(scene), *PARTITION_FLAGS, "--device", "cpu"])
    visible = scene / "model" / "split_result" / "visible"
    blocks = sorted(os.listdir(visible))
    auto_train.main(["--base_path", str(visible), *flags, "--iterations",
                     "4", "--capacity", "512", "--max_per_tile", "128",
                     "--densify_from_iter", "2", "--densification_interval",
                     "2", "--resolution", "1", "--device", "cpu"])
    manifest = json.loads((visible / "train_status.json").read_text())
    assert sorted(manifest) == blocks and len(blocks) >= 2
    assert all(v["status"] == "done" for v in manifest.values()), manifest
    for b in blocks:
        out = visible / b / f"partition_{b}" / "output"
        assert (out / "point_cloud" / "iteration_4" /
                f"{b}_point_cloud.ply").exists()


def test_new_clis_default_to_the_card(tmp_path):
    from pcp_tpu_torch.cli import auto_train, merge, partition

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for main, argv in ((partition.main, [str(tmp_path)]),
                       (merge.main, ["-m", str(tmp_path)]),
                       (auto_train.main, ["--base_path", str(tmp_path),
                                          "--sequential"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_convert_commands_match_jax(tmp_path, monkeypatch):
    from pcp_tpu.cli import convert as j_convert
    from pcp_tpu_torch.cli import convert as t_convert

    argv = ["-s", str(tmp_path), "--colmap_executable", "bin/colmap",
            "--no_gpu"]
    ran = {}
    for tag, mod in (("j", j_convert), ("t", t_convert)):
        cmds = ran[tag] = []
        monkeypatch.setattr(mod.subprocess, "call",
                            lambda cmd, shell: cmds.append(cmd) or 0)
        (tmp_path / "sparse").mkdir(exist_ok=True)
        mod.main(argv + (["--device", "cpu"] if tag == "t" else []))
    assert ran["t"] == ran["j"] and len(ran["t"]) == 4
    assert ran["t"][0].startswith("bin/colmap feature_extractor")
    assert "--SiftExtraction.use_gpu 0" in ran["t"][0]


def test_convert_exits_without_colmap(tmp_path):
    from pcp_tpu_torch.cli import convert

    with pytest.raises(SystemExit) as e:
        convert.main(["-s", str(tmp_path), "--colmap_executable",
                      str(tmp_path / "no_colmap"), "--device", "cpu"])
    assert e.value.code == 127


def test_light_matches_jax(tmp_path):
    from PIL import Image as PILImage

    from pcp_tpu.cli import light as j_light
    from pcp_tpu_torch.cli import light as t_light

    rng = np.random.default_rng(0)
    for i, level in enumerate([20, 200, 190, 210, 180, 15]):
        img = np.clip(rng.normal(level, 10, (16, 16, 3)), 0, 255)
        PILImage.fromarray(img.astype(np.uint8)).save(tmp_path / f"{i}.png")
    j_out = j_light.analyze_directory(str(tmp_path))
    j_lists = {t: (tmp_path / f"low_light_images_{t}.txt").read_text()
               for t in ("gray", "hsv")}
    t_light.main([str(tmp_path), "--device", "cpu"])
    assert t_light.analyze_directory(str(tmp_path)) == j_out
    for t in ("gray", "hsv"):
        assert (tmp_path / f"low_light_images_{t}.txt").read_text() == \
            j_lists[t]
    assert sorted(j_out["gray"][1]) == ["0.png", "5.png"]
