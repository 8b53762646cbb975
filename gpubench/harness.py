"""The benchmark's driver: finds a cell and everything it needs by name,
runs it, and prints the result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its
configuration is the file that the configuration's entry names; its
traffic mix is ``gpubench/traffic/<traffic>.json``, whose ``kind`` names
the module under ``gpubench/drivers`` that generates it; the limits of the
numbers that decide ``correct`` are ``gpubench/limits/<cell>.json``; each
per-layer metric is read by ``gpubench/metrics/<metric>.py``. A new cell,
configuration, traffic mix of a known kind or per-layer metric is new
files and ``BENCHMARK.json`` entries, and no edit.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; then ``checks``, each compared number with its limit, which
also end standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules no run may hold once its window has closed: JAX and the
# JAX package (the port, pcp_tpu_torch, is another top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pcp_tpu")


class CellError(Exception):
    """The cell cannot run here."""


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    """The cell ``name`` with its configuration, traffic mix and limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bench_dir = root / "gpubench"
    return {
        "cell": cell,
        "config": load_json(root / configs[cell["config"]]["file"]),
        "traffic": load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(bench_dir / "limits" / f"{name}.json"),
    }


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, root: Path = ROOT):
    """``read(trace) -> float | None`` of ``gpubench/metrics/<name>.py``."""
    path = root / "gpubench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: Dict, name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             root: Path = ROOT) -> Dict:
    """Run a cell and build its result (without the module check)."""
    spec = cell_spec(bench, name, root)
    kind = spec["traffic"]["kind"]
    driver = importlib.import_module(f"gpubench.drivers.{kind}")
    out = driver.run(spec["config"], spec["traffic"], seed, seconds, traced,
                     device, t_start)
    from gpubench import compare

    checks = compare.judge(out["values"], spec["limits"])
    metrics = {}
    if traced:
        for m in bench["per_layer"]:
            if applies(m, name):
                v = metric_reader(m["name"], root)(out["trace"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
    result = {
        "correct": all(c["ok"] for c in checks) and out["failed"] == 0,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if traced:
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["wall_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["notes"] = dict(out.get("notes", {}), not_compared={
        k: v for k, v in out["values"].items() if k not in spec["limits"]})
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def main(argv: Optional[List[str]] = None,
         t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # fp32 as the configurations state it, for the reference too (the
    # port's entry points switch TF32 off themselves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    leaked = forbidden_modules()
    if leaked:
        print(f"the run loaded {', '.join(leaked)}; no result",
              file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"]}
    print(f"notes: {json.dumps(result.pop('notes'))}", file=sys.stderr)
    result = {k: result[k] for k in ("correct", "attempted", "failed",
                                     "metrics", "device", "breakdown",
                                     "checks") if k in result}
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
