"""Per-stage device time of the train step on the card (the port's
counterpart of ``tools/profile_stages.py`` and ``tools/profile_scale.py``).

The JAX tools timed prefix programs (preprocess; + binning; the forward;
+ backward; the step) and took telescoping differences, because XLA fuses
each program on its own: a stage timed alone materialises what the fused
step never writes, and the isolated stages did not compose. The port runs
eagerly, one CUDA kernel after another on one stream, with no fusion across
stages for a prefix to distort. So a profiler run over the real step reads
each stage directly: ``ops/rasterize.py`` and ``train/step.py`` mark their
stages with ``record_function`` ranges (``STAGES``), each range's device
time is its stage's, and the ranges compose. What no range holds is
autograd's backward of preprocess, the appearance net and the loss, and the
few operations outside any range: ``REST``, the device busy time less the
ranges.

The profiler ties no ctypes kernel launch to the range around it, so the
port's own kernels join their stage by symbol name (``OWN_KERNELS``).

    python -m pcp_tpu_torch.tools.profile_stages [--iters 10] [--scale]
        [--device cpu]

prints one JSON line: ``stage_breakdown`` of the bench's canonical point
(100k live Gaussians at 800x600), or with ``--scale`` of its
reference-scale point (719,802 live in 2^21 slots at 1280x800, fx 850),
with the roofline's share of each stage's bound (``bench.run_point``). Without ``--device cpu``
it runs on the card and raises without one; on the CPU no device time is
measured.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType

PROFILER_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                       torch.profiler.ProfilerActivity.CUDA]
# The profiler ranges that rasterize, Blend and train_step_impl mark, in the
# order a step runs them; the rest of the device time is autograd's backward
# of preprocess, the appearance net and the loss, and the few operations
# outside any range (the GT's conversion, the probe, the gradient list).
STAGES = ("preprocess", "binning", "composite_fwd", "appearance + loss",
          "composite_bwd", "segment_sum", "densify stats + adam")
REST = "the rest: preprocess, appearance and loss backward (autograd)"
OWN_KERNELS = {"composite_fwd": "composite_fwd_kernel",
               "composite_bwd": "composite_bwd_kernel",
               "segment_sum": "segsum_"}   # the inverse and the sum
WARM_STEPS = 3         # before timed steps
PROFILED_STEPS = 3


def sync() -> None:
    """Wait for the card, where one is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def card_text(dev) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if torch.device(dev).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls after ``warm``. The
    timed calls queue behind a spin kernel (``exp_r2``'s), so the host's
    per-call work is hidden and the events time the launches back to
    back."""
    from pcp_tpu_torch.tools.exp_r2 import SPIN_CYCLES

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _device_events(prof) -> list:
    """The profiler's averages of every kernel, copy and fill it saw on the
    card; range annotations are not device work."""
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0]


def device_kernels(prof, per: int, events=None) -> list:
    """(name, device ms per ``per``) of every kernel, copy and fill the
    profiler saw on the card."""
    return [(e.key, e.self_device_time_total / 1e3 / per)
            for e in (_device_events(prof) if events is None else events)]


def capture_backward(run) -> tuple:
    """(arguments, ``run()``'s result): calls ``run()`` with the backward's
    two stages, ``composite_bwd`` and the segment-sum stage
    ``pack_gradient``, as ``ops.rasterize`` calls them, recording the
    arguments each got in the step with the most pairs (the last of
    equals)."""
    from pcp_tpu_torch.ops import rasterize as rasterize_mod

    seen, real = {}, {"composite_bwd": rasterize_mod.composite_bwd,
                      "pack_gradient": rasterize_mod.pack_gradient}

    def detached(args):
        return tuple(a.detach() if torch.is_tensor(a) else a for a in args)

    def bwd(*args):
        if args[1].numel() >= seen.get("n_pairs", -1):
            seen.update(n_pairs=args[1].numel(), take=True,
                        composite_bwd=detached(args))
        return real["composite_bwd"](*args)

    def pack(*args):
        if seen.pop("take", False):
            seen["pack_gradient"] = detached(args)
        return real["pack_gradient"](*args)

    try:
        rasterize_mod.composite_bwd = bwd
        rasterize_mod.pack_gradient = pack
        out = run()
    finally:
        for name, fn in real.items():
            setattr(rasterize_mod, name, fn)
    return {k: seen[k] for k in real}, out


def timed_steps(step, reps: int, warm: int = None) -> tuple:
    """(ms of ``reps`` synchronised warm steps, the last step's metrics),
    after ``warm`` (default WARM_STEPS) steps of warm-up; ``step()``
    returns (state, metrics)."""
    for _ in range(WARM_STEPS if warm is None else warm):
        step()
    sync()
    times = []
    m = None
    for _ in range(reps):
        t0 = time.perf_counter()
        _, m = step()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, m


def profiled_steps(step, reps: int = None):
    """A profiler run over ``reps`` (default PROFILED_STEPS) steps."""
    with torch.profiler.profile(activities=PROFILER_ACTIVITIES) as prof:
        for _ in range(reps or PROFILED_STEPS):
            step()
        sync()
    return prof


def stage_split(prof, rows: list, per: int) -> dict:
    """Device ms per step of each range of STAGES in a profiler run over
    ``per`` steps (``rows``: its ``device_kernels``), and REST: the device
    busy time the ranges do not hold."""
    stages = dict.fromkeys(STAGES, 0.0)
    held = {k: set() for k in STAGES}     # kernels each range's time counts

    def kernels_under(e):
        return {k.name for k in e.kernels}.union(
            *(kernels_under(c) for c in e.cpu_children))

    for e in prof.events():
        if e.key in stages and e.device_type == DeviceType.CPU:
            stages[e.key] += e.device_time_total / 1e3 / per
            held[e.key] |= kernels_under(e)
    # The profiler ties a ctypes launch to its runtime call, not to the
    # range around it: the port's own kernels join their stage by name.
    for stage, symbol in OWN_KERNELS.items():
        if not any(symbol in name for name in held[stage]):
            stages[stage] += sum(ms for key, ms in rows if symbol in key)
    stages[REST] = sum(ms for _, ms in rows) - sum(stages.values())
    return stages


def stage_breakdown(step, reps: int) -> dict:
    """The warm step (median of ``reps`` synchronised steps after one step
    and WARM_STEPS more) and its peak memory, then from a profiler run over
    PROFILED_STEPS steps each range's device ms a step, REST, device busy
    ms, the idle share of the warm step, the kernels, copies and fills
    launched a step (each one a dispatch by the host) and the top device
    kernels. Device numbers are None where the profiler saw no card."""
    profiled = PROFILED_STEPS
    on_card = torch.cuda.is_initialized()
    step()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times, m = timed_steps(step, reps)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    step_ms = statistics.median(times)
    prof = profiled_steps(step, profiled)
    events = _device_events(prof)
    rows = device_kernels(prof, profiled, events)
    busy = sum(ms for _, ms in rows)
    measured = busy > 0
    top = sorted(rows, key=lambda r: -r[1])[:10]
    return {"step_ms": step_ms, "step_ms_all": times,
            "stage_device_ms": stage_split(prof, rows, profiled)
            if measured else None,
            "device_busy_ms": busy if measured else None,
            "device_idle_share": 1 - busy / step_ms if measured else None,
            "peak_memory_bytes": peak,
            "device_launches_per_step": sum(e.count for e in events)
            / profiled if measured else None,
            "top_device_ms": [[k[:90], ms] for k, ms in top],
            "n_pairs": m["n_pairs"], "profiled_steps": profiled}


def main(argv=None) -> int:
    from pcp_tpu_torch import bench
    from pcp_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scale", action="store_true",
                    help="the reference-scale point (tools/profile_scale.py)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    point = bench.SCALE_POINT if args.scale else bench.CANONICAL
    _, h = bench.run_point(warmup=bench.WARMUP, iters=args.iters,
                           device=dev, breakdown_reps=args.iters, **point)
    print(json.dumps(dict(h["breakdown"], point=point,
                          capacity=h["capacity"], roofline=h["roofline"],
                          device=card_text(dev))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
