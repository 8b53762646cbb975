"""What the benchmark may import, and that it finds its pieces by name.

- No module under ``gpubench/`` imports JAX, Flax, optax or the JAX package
  ``pcp_tpu`` (compared by whole top-level name: the port, ``pcp_tpu_torch``,
  is another), and the plain reference imports nothing of the port.
- ``BENCHMARK.json`` keeps the contract's shape, and every cell, metric and
  configuration it names has its files.
- A new configuration, cell and per-layer metric, added as new files and
  entries in a copy, are found by name with no other file edited.
"""

import ast
import hashlib
import json
import re
import shutil
import sys
import types
from pathlib import Path

import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gpubench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pcp_tpu")
MODULES = sorted(str(p.relative_to(ROOT)) for p in BENCH.rglob("*.py")
                 if "_cache" not in p.parts)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            yield node.args[0].value


def test_matcher_compares_whole_top_level_names():
    top = lambda m: m.split(".")[0]  # noqa: E731
    assert top("pcp_tpu.ops") in FORBIDDEN
    assert top("pcp_tpu_torch.ops") not in FORBIDDEN
    assert top("jax.numpy") in FORBIDDEN


@pytest.mark.parametrize("rel", MODULES)
def test_module_imports_no_jax(rel):
    tree = ast.parse((ROOT / rel).read_text())
    bad = [m for m in imported(tree) if m.split(".")[0] in FORBIDDEN]
    if rel.startswith("gpubench/reference/"):
        bad += [m for m in imported(tree)
                if m.split(".")[0] == "pcp_tpu_torch"]
    assert not bad, f"{rel} imports {bad}"


def test_benchmark_json_keeps_its_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpubench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "gpubench/")
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in b["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in cells:
        assert any(harness.applies(m, cell) for m in b["per_layer"])
        assert sum(harness.applies(m, cell) for m in b["end_to_end"]) >= 2


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and "_cache" not in p.parts}


def test_new_pieces_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = _digests(tmp_path / "gpubench")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())

    # a configuration, a cell on it, and a per-layer metric: new files
    cfg = json.loads((BENCH / "configs" / "ref100k.json").read_text())
    cfg["block"]["live"] = 200_000
    (tmp_path / "gpubench/configs/ref100k_dense.json").write_text(
        json.dumps(cfg))
    (tmp_path / "gpubench/limits/ref100k_dense.block_train.json").write_text(
        (BENCH / "limits" / "ref100k.block_train.json").read_text())
    (tmp_path / "gpubench/metrics/pairs_per_step.train.py").write_text(
        "def read(trace):\n"
        "    if trace.get('kind') != 'train':\n        return None\n"
        "    return sum(c['pairs'] for c in trace['counts'])"
        " / len(trace['counts'])\n")
    bench["configs"].append(dict(bench["configs"][1], name="ref100k_dense",
                                 file="gpubench/configs/ref100k_dense.json"))
    bench["workloads"].append(dict(bench["workloads"][1],
                                   name="ref100k_dense.block_train",
                                   config="ref100k_dense"))
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="pairs_per_step.train", unit="pairs",
                                   workloads=["ref100k_dense.block_train"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(tmp_path / "gpubench")
    assert {k: v for k, v in after.items() if k in before} == before
    spec = harness.cell_spec(bench, "ref100k_dense.block_train", tmp_path)
    assert spec["config"]["block"]["live"] == 200_000
    assert spec["traffic"]["kind"] == "train"
    read = harness.metric_reader("pairs_per_step.train", tmp_path)
    assert read({"kind": "train", "counts": [{"pairs": 4}, {"pairs": 6}]}) == 5
    assert read({"kind": "render"}) is None
    with pytest.raises(harness.CellError):
        harness.cell_spec(bench, "no.such_cell", tmp_path)


def test_run_refuses_when_jax_is_loaded(monkeypatch):
    assert "pcp_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pcp_tpu", types.ModuleType("pcp_tpu"))
    monkeypatch.setitem(sys.modules, "pcp_tpu_torch_x",
                        types.ModuleType("pcp_tpu_torch_x"))
    assert harness.forbidden_modules() == ["pcp_tpu"]
