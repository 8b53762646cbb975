"""``pcp_tpu_torch.tools.quality_scale_run`` end to end on the CPU, shrunk.

The full run of the ref500k preset spans several machines: a variant
whose run is cut resumes from its newest ``chkpnt<N>.pth``, and a variant
trained and scored in a run of its own is merged into the artifact the
earlier run wrote. Here the preset's scene, partition, both variants and
the eval run at 64x40 with a few thousand points: the densify variant is
cut right after a checkpoint and resumed, the artifact records where, and
a second eval that finds only the control's output keeps the first eval's
densify row.
"""

import functools
import importlib
import json
import math
import shutil

import pytest
import torch

from pcp_tpu_torch.tools import quality_scale_run as t_qsr

TINY = dict(W=64, H=40, FX=42.5, FY=42.5, N_SFM=8000, N_FINE=1300,
            N_COARSE=700, N_CAMS_RING=16, N_CAMS_GRID=9, THRESHOLD=500,
            CAPACITY=2048, CAPACITY_CONTROL=1024, LLFFHOLD=4,
            CHECKPOINT_EVERY=4)
ITERS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # parallel test workers: a multithreaded CPU torch oversubscribes them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def qsr(monkeypatch):
    """The tool at its default preset, shrunk; the JSONL log only (no
    TensorBoard import), no oracle views."""
    from pcp_tpu_torch.train import loop

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))
    monkeypatch.delenv("PCP_QSR_PRESET", raising=False)
    monkeypatch.setenv("PCP_ORACLE_VIEWS", "0")
    mod = importlib.reload(t_qsr)
    for k, v in TINY.items():
        monkeypatch.setattr(mod, k, v)
    yield mod
    importlib.reload(t_qsr)


class Cut(Exception):
    pass


def test_a_cut_variant_resumes_and_the_artifact_says_where(qsr, tmp_path,
                                                           monkeypatch):
    from pcp_tpu_torch.train import checkpoint as ckpt

    root, art = str(tmp_path / "root"), str(tmp_path / "art.json")

    def run(*args):
        return qsr.main(["--root", root, "--iters", str(ITERS), "--out", art,
                         "--device", "cpu", *args])

    for ph in ("scene", "partition"):
        assert run("--phase", ph) is None
    # the first run is cut just after its checkpoint at 8
    save = ckpt.save

    def save_then_cut(path, state, it):
        save(path, state, it)
        if it == 8:
            raise Cut

    monkeypatch.setattr(ckpt, "save", save_then_cut)
    with pytest.raises(Cut):
        run("--phase", "train")
    monkeypatch.setattr(ckpt, "save", save)
    block = qsr.pick_block(root)
    dens = tmp_path / "root" / "model" / "split_result" / "visible" / block \
        / f"partition_{block}" / "output_densify"
    assert sorted(p.name for p in dens.glob("chkpnt*.pth")) \
        == ["chkpnt4.pth", "chkpnt8.pth"]
    assert not (dens / "point_cloud" / f"iteration_{ITERS}").exists()

    run("--phase", "train")
    first = run("--phase", "eval")
    assert [r["variant"] for r in first["runs"]] == ["densify"]
    row = first["runs"][0]
    assert row["resumed_from"] == [8] and row["iterations"] == ITERS
    assert row["card"] is None
    assert math.isfinite(row["PSNR"]) and math.isfinite(row["SSIM"])
    assert (dens / "point_cloud" / f"iteration_{ITERS}").is_dir()
    assert set(first["phase_seconds"]) == {"scene", "partition", "eval"}

    # the control in a run of its own, on a copy of the scene without the
    # densify variant's output: the artifact keeps the first run's row
    shutil.rmtree(dens)
    run("--phase", "control")
    both = run("--phase", "eval")
    assert json.loads(open(art).read()) == both
    assert [r["variant"] for r in both["runs"]] \
        == ["densify", "no_densify_control"]
    assert both["runs"][0] == row
    ctl = both["runs"][1]
    assert ctl["resumed_from"] == [] and ctl["iterations"] == ITERS
    assert ctl["max_alive"] <= TINY["CAPACITY_CONTROL"]
    assert both["earlier_phase_seconds"] == first["phase_seconds"]
