"""The comparison that decides ``correct``: it passes on the port and fails
on a broken timed path.

A run of each cell at a test's size (``tiny_root``) goes through the whole
harness but the look for a card, on the CPU, with the port's plain paths;
then again with one fault planted underneath the timed path: a training
step that returns its state unchanged, the loss over half of the image,
one tile of the render zeroed where it is produced, and a step that goes
wrong only after set-up's check steps, which the check steps after the
window see. (One card, so no exchange between cards to leave out.) On the card, the control, the
reference in TF32 in the port's place, fails the cells' limits.
"""

import json
import time

import numpy as np
import pytest
import torch

from gpubench import compare, control, harness

TRAIN_CELLS = ("ref500k.block_train", "ref100k.block_train")
RENDER_CELL = "ref500k.scene_render"


def run(root, cell, seed=20240611):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return harness.run_cell(bench, cell, seed, 60.0, False, "cpu",
                            time.perf_counter(), root)


def failed(result):
    return [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", TRAIN_CELLS + (RENDER_CELL,))
def test_port_passes(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["metrics"]["setup_s"]["value"] > 0


def _unchanged(monkeypatch, after=0):
    """Every training step from call ``after`` on returns its state
    unchanged."""
    from pcp_tpu_torch.train import step

    real = step.train_step_impl
    calls = [0]

    def unchanged(state, *a, **kw):
        calls[0] += 1
        if calls[0] <= after:
            return real(state, *a, **kw)
        keep = {k: v.clone() for k, v in state.params.items()}
        moments = [(t, t.clone()) for opt in (state.opt_g, state.opt_a)
                   for part in ("mu", "nu") for g in opt[part].values()
                   for t in g]
        app = [(p, p.detach().clone()) for p in state.app["net"].parameters()]
        app.append((state.app["embeddings"],
                    state.app["embeddings"].clone()))
        state, m = real(state, *a, **kw)
        with torch.no_grad():
            for k, v in keep.items():
                state.params[k].copy_(v)
            for t, v in moments + app:
                t.copy_(v)
        return state, m

    monkeypatch.setattr(step, "train_step_impl", unchanged)


def _half(monkeypatch):
    from pcp_tpu_torch.train import step

    real = step.photometric_loss

    def half(image, gt, *a, **kw):
        h = image.shape[0] // 2
        return real(image[:h], gt[:h], *a, **kw)

    monkeypatch.setattr(step, "photometric_loss", half)


def _tile(monkeypatch):
    from pcp_tpu_torch.train import step

    real = step.render_gaussians

    def tile(*a, **kw):
        image, aux = real(*a, **kw)
        return control.zero_tile(image), aux

    monkeypatch.setattr(step, "render_gaussians", tile)


def _unchanged_after_setup(monkeypatch):
    """A step that goes wrong only once set-up's check steps have run, as a
    path that changes after its first calls would."""
    traffic = json.loads((harness.ROOT / "gpubench" / "traffic"
                          / "block_train.json").read_text())
    _unchanged(monkeypatch, after=int(traffic["check_steps"]))


@pytest.mark.parametrize("fault", [_unchanged, _half, _tile,
                                   _unchanged_after_setup])
def test_a_broken_training_step_is_not_correct(tiny_root, monkeypatch,
                                                fault):
    fault(monkeypatch)
    r = run(tiny_root, TRAIN_CELLS[0])
    assert not r["correct"], r["checks"]
    assert failed(r)


def test_a_broken_render_is_not_correct(tiny_root, monkeypatch):
    from pcp_tpu_torch.eval import render_batch

    real = render_batch.render_view

    def tile(*a, **kw):
        img, stats = real(*a, **kw)
        return control.zero_tile(torch.as_tensor(img)).numpy(), stats

    monkeypatch.setattr(render_batch, "render_view", tile)
    r = run(tiny_root, RENDER_CELL)
    assert not r["correct"], r["checks"]


def test_gaps():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert compare.leaf_gap(dict(ref), ref) == 0.0
    # a leaf far under the median is measured against the median
    assert compare.leaf_gap(dict(ref, c=1e-3), ref) == pytest.approx(1e-3)
    assert compare.negligible(ref) == {"c"}
    assert compare.leaf_gap(dict(ref, c=5.0), ref, {"c"}) == 0.0
    a = np.zeros((4, 4, 3), np.float32)
    assert compare.image_gaps(a, a + 0.5) == {"max": 0.5, "mean": 0.5}
    j = compare.judge({"x": 1.0, "y": float("nan")},
                      {"x": 1.0, "y": 1.0, "z": 1.0})
    assert [c["ok"] for c in j] == [True, False, False]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", TRAIN_CELLS + (RENDER_CELL,))
def test_tf32_control_is_not_correct(card, cell):
    """At the cell's own size: a few seconds a seed on the card."""
    spec = harness.cell_spec(harness.load_json(harness.ROOT
                                               / "BENCHMARK.json"), cell)
    for seed in (11, 12, 13):
        r = control.readings(spec, seed, "control", card)
        checks = compare.judge(r, spec["limits"])
        assert not all(c["ok"] for c in checks), r
