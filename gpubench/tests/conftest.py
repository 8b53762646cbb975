"""Tests of the benchmark harness: ``python -m pytest gpubench/tests`` from
the root of the repository. Tests marked ``cuda`` need a CUDA card and skip
without one; they decide so inside the test."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_config(name: str) -> dict:
    """A configuration file shrunk to a test's size: 64x48 views, a few
    hundred Gaussians, a dozen cameras; the schedule and rates as given."""
    cfg = json.loads((ROOT / "gpubench" / "configs" / f"{name}.json")
                     .read_text())
    # densify every 10 iterations, so that the tail's check steps follow
    # the window closely
    cfg.update(width=64, height=48, fx=40.0, densification_interval=10)
    cfg["block"].update(capacity=1024, live=600, fine_sigma=0.5,
                        coarse_sigma=1.0)
    cfg["block"]["rig"].update(ring_cameras=12, hold=4)
    if "scene" in cfg:
        cfg["scene"].update(capacity=900, live=900, fine_sigma=0.5,
                            coarse_sigma=1.5)
        cfg["scene"]["rig"].update(ring_cameras=8, grid_cameras=8, hold=4)
    return cfg


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and gpubench/) whose
    configurations are shrunk by ``tiny_config`` and whose windows are a
    few steps; the limits are the cells' own."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        (tmp_path / c["file"]).write_text(json.dumps(tiny_config(c["name"])))
    for t in (tmp_path / "gpubench" / "traffic").glob("*.json"):
        d = json.loads(t.read_text())
        d.update(max_window_steps=2, max_window_views=4, profile_offset=1)
        t.write_text(json.dumps(d))
    return tmp_path
