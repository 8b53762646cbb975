"""Reduction of a ``torch.profiler`` run to what the per-layer metrics read.

The port marks its stages with ``record_function`` ranges (``STAGES``);
each range's device time is the time of the kernels launched under it. The
profiler does not tie a ctypes launch to the range around it, so the
port's own kernels join their stage by symbol name (``OWN_KERNELS``). What
no range holds is autograd's backward of preprocess, the appearance net and
the loss, and the few operations outside any range: ``REST``, the device
operations' summed time less the ranges. The arithmetic is that of the port's
``tools/profile_stages.stage_split``, kept here so that the yardstick does
not move with the program.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType

STAGES = ("preprocess", "binning", "composite_fwd", "appearance + loss",
          "composite_bwd", "segment_sum", "densify stats + adam")
REST = "rest"
OWN_KERNELS = {"composite_fwd": "composite_fwd_kernel",
               "composite_bwd": "composite_bwd_kernel",
               "segment_sum": "segsum_"}
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def device_events(prof) -> list:
    """The profiler's averages of every kernel, copy and fill it saw on the
    card; range annotations are not device work."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def stage_split(prof, rows: List[Tuple[str, float]]) -> Dict[str, float]:
    """Device ms of each range of STAGES over the profiled run (``rows``:
    (kernel, ms) of every device event), and REST."""
    stages = dict.fromkeys(STAGES, 0.0)
    held = {k: set() for k in STAGES}

    def kernels_under(e):
        return {k.name for k in e.kernels}.union(
            *(kernels_under(c) for c in e.cpu_children))

    for e in prof.events():
        if e.key in stages and e.device_type == DeviceType.CPU:
            stages[e.key] += e.device_time_total / 1e3
            held[e.key] |= kernels_under(e)
    for stage, symbol in OWN_KERNELS.items():
        if not any(symbol in name for name in held[stage]):
            stages[stage] += sum(ms for key, ms in rows if symbol in key)
    stages[REST] = sum(ms for _, ms in rows) - sum(stages.values())
    return stages


def _intervals(prof):
    """(device intervals, host events) in microseconds: every kernel, copy
    and fill on the card, and every host event with its name."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((tr.start, tr.end))
        elif e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.key))
    return sorted(dev), sorted(host)


def busy_union(dev) -> float:
    """Microseconds in which at least one of the sorted device intervals
    ``dev`` ran: operations that overlap count once."""
    total, end = 0.0, float("-inf")
    for s, e in dev:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def idle_gaps(prof) -> Dict[str, float]:
    """Seconds the card sat idle between two of its operations, by the
    innermost host event running at the middle of each gap (the host's
    work the card waited on)."""
    dev, host = _intervals(prof)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    end = dev[0][1] if dev else 0.0
    for s, e in dev:
        if s > end:
            mid = 0.5 * (s + end)
            name = "(no host event)"
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 4000, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            out[name] = out.get(name, 0.0) + (s - end) / 1e6
        end = max(end, e)
    return out


def reduce(prof, steps: int, wall_s: float) -> Dict:
    """Per step: each stage's device ms, REST, device busy ms and launches;
    over the profiled run: device busy and wall seconds, the top device
    operations and the longest idle gaps (both in seconds). Device busy is
    the time in which any operation ran (the union of their intervals);
    the stages and REST split the sum of the operations' own times."""
    events = device_events(prof)
    rows = [(e.key, e.self_device_time_total / 1e3) for e in events]
    busy_ms = busy_union(_intervals(prof)[0]) / 1e3
    split = stage_split(prof, rows)
    top = sorted(rows, key=lambda r: -r[1])[:10]
    gaps = sorted(idle_gaps(prof).items(), key=lambda r: -r[1])[:10]
    return {
        "steps": steps,
        "stage_ms": {k: v / steps for k, v in split.items()},
        "busy_ms": busy_ms / steps,
        "busy_s": busy_ms / 1e3,
        "wall_s": wall_s,
        "launches": sum(e.count for e in events) / steps,
        "device_ops": [[k[:120], ms / 1e3] for k, ms in top],
        "idle_gaps": [[k[:120], s] for k, s in gaps],
    }


def merge(parts: List[Dict]) -> Dict:
    """One reduction from several profiled runs of one step or view each:
    per-step means, sums of seconds, the top lists merged."""
    steps = sum(p["steps"] for p in parts)
    keys = parts[0]["stage_ms"].keys()

    def top(field):
        acc: Dict[str, float] = {}
        for p in parts:
            for k, v in p[field]:
                acc[k] = acc.get(k, 0.0) + v
        return [[k, v] for k, v in sorted(acc.items(), key=lambda r: -r[1])
                [:10]]

    return {
        "steps": steps,
        "stage_ms": {k: sum(p["stage_ms"][k] * p["steps"] for p in parts)
                     / steps for k in keys},
        "busy_ms": sum(p["busy_ms"] * p["steps"] for p in parts) / steps,
        "busy_s": sum(p["busy_s"] for p in parts),
        "wall_s": sum(p["wall_s"] for p in parts),
        "launches": sum(p["launches"] * p["steps"] for p in parts) / steps,
        "device_ops": top("device_ops"),
        "idle_gaps": top("idle_gaps"),
    }
