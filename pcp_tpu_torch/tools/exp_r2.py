"""Gather, sort and attribute-build microbenchmarks on the device
(counterpart of ``tools/exp_r2.py``).

    python -m pcp_tpu_torch.tools.exp_r2 {gather|sort|xlagather|all}
        [--n 131072] [--na 16] [--nt 1904] [--k 512] [--seed 0] [--reps 20]
        [--device cpu]

  gather    - the hand-written gather kernel (``ops/gather.py``,
              ``csrc/gather_pack.cu``) in the tool's three layouts: form1
              and form2 from the (N, NA) pack (one kernel on the card),
              form3 from the transposed (NA, N) pack; each with an ``ok=``
              spot check and its time, then the plain version
              (``index_select`` and a transpose, also the library
              yardstick). It prints the bytes a gather must move and the
              plane form's sector floor: one 32-B sector per (id, plane).
  sort      - ``torch.sort`` of 2M and 4M int32 keys in [0, 2^31), alone and
              with an int32 payload gathered by the sort's permutation.
  xlagather - the row gather + transpose as plain torch, and its VJP (a
              scatter-add into the pack rows), at K and 2K.

The defaults are the JAX tool's shapes: a (2^17, 16) f32 pack and (1904,
512) int32 ids, drawn from ``--seed``. The timed calls cycle through
``VARY`` input variants, as the JAX tool varies its inputs. Without
``--device cpu`` everything runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch

from pcp_tpu_torch.device import DeviceLike, resolve_device
from pcp_tpu_torch.ops.gather import gather_pack, gather_pack_plain

N, NA, NT, K = 1 << 17, 16, 1904, 512
SORT_SIZES = (1 << 21, 1 << 22)
VARY = 4
FORMS = (("form1_col_take", "col"), ("form2_row_take", "row"),
         ("form3_lane_take", "plane"))
# On the card the timed launches queue behind a spin kernel of this many
# cycles (~30 ms), so the host's per-call work is hidden and the events
# time the launches back to back.
SPIN_CYCLES = 50_000_000


def timed(fn: Callable[[int], object], dev: torch.device, reps: int,
          warmup: int = 2) -> float:
    """Mean ms of ``fn(i)`` over ``reps`` calls after ``warmup``: CUDA
    events on the card, the host clock on the CPU."""
    for i in range(warmup):
        fn(i)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for i in range(reps):
            fn(warmup + i)
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(reps):
        fn(warmup + i)
    stop.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(stop) / reps


def make_inputs(n: int, na: int, nt: int, k: int, seed: int,
                device: DeviceLike = None):
    """pack (n, na) f32 standard normals and ids (nt, k) int32 in [0, n)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pack = rng.standard_normal((n, na), dtype=np.float32)
    ids = rng.integers(0, n, (nt, k), dtype=np.int32)
    return torch.as_tensor(pack, device=dev), torch.as_tensor(ids, device=dev)


def gather_bytes(ids, na: int) -> int:
    """Bytes a gather must move: each id read once, each output written
    once, each distinct pack row read once."""
    rows = int(torch.unique(ids).numel())
    return 4 * ids.numel() + 4 * na * ids.numel() + 4 * na * rows


def plane_sector_bytes(ids, na: int) -> int:
    """Bytes the plane form moves at least: the NA values of an id lie N
    floats apart, so each (id, plane) costs a whole 32-B sector."""
    return 32 * na * ids.numel()


def exp_gather(n: int = N, na: int = NA, nt: int = NT, k: int = K,
               seed: int = 0, reps: int = 20,
               device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    pack, ids = make_inputs(n, na, nt, k, seed, dev)
    packs = [pack + float(v) for v in range(VARY)]
    packs_t = [p.T.contiguous() for p in packs]
    nbytes = gather_bytes(ids, na)
    sectors = plane_sector_bytes(ids, na)
    print(f"pack ({n}, {na}) f32, ids ({nt}, {k}) int32 on {dev}: "
          f"{nbytes} bytes to move; the plane form's sector floor "
          f"{sectors} bytes")
    ref = packs[0][ids[3].long()]                          # (K, NA)
    forms = {}
    for name, layout in FORMS:
        src = packs_t if layout == "plane" else packs
        out = gather_pack(src[0], ids, layout)
        ok = bool(torch.equal(out[3].T, ref))
        t = timed(lambda i: gather_pack(src[i % VARY], ids, layout), dev,
                  reps)
        forms[name] = {"layout": layout, "ok": ok, "ms": t}
        print(f"{name}: ok={ok} t={t:.4f} ms")
    plain = timed(lambda i: gather_pack_plain(packs[i % VARY], ids, "row"),
                  dev, reps)
    print(f"index_select + permute (the plain version): t={plain:.4f} ms")
    return {"n": n, "na": na, "nt": nt, "k": k, "bytes": nbytes,
            "plane_sector_bytes": sectors, "forms": forms, "plain_ms": plain}


def exp_sort(sizes=SORT_SIZES, seed: int = 0, reps: int = 10,
             device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for m in sizes:
        keys = torch.as_tensor(rng.integers(0, 1 << 31, m, dtype=np.int32),
                               device=dev)
        pay = torch.as_tensor(rng.integers(0, 1 << 20, m, dtype=np.int32),
                              device=dev)
        variants = [keys ^ v for v in range(VARY)]

        def with_payload(i):
            _, perm = torch.sort(variants[i % VARY])
            return pay[perm]

        single = timed(lambda i: torch.sort(variants[i % VARY]).values, dev,
                       reps)
        both = timed(with_payload, dev, reps)
        out[m] = {"single_ms": single, "payload_ms": both}
        print(f"m={m}: single={single:.4f} ms  payload={both:.4f} ms")
    return out


def exp_xlagather(n: int = N, na: int = NA, nt: int = NT, ks=(K, 2 * K),
                  seed: int = 0, reps: int = 20,
                  device: DeviceLike = None) -> Dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pack = torch.as_tensor(rng.standard_normal((n, na), dtype=np.float32),
                           device=dev)
    packs = [pack + float(v) for v in range(VARY)]
    out = {}
    for k in ks:
        ids = torch.as_tensor(rng.integers(0, n, (nt, k), dtype=np.int32),
                              device=dev)
        flat = ids.reshape(-1)
        cot = torch.ones((nt, na, k), dtype=torch.float32, device=dev)
        cots = [cot + float(v) for v in range(VARY)]

        def vjp(i):
            rows = cots[i % VARY].permute(0, 2, 1).reshape(-1, na)
            return torch.zeros_like(pack).index_add_(0, flat, rows)

        fwd = timed(lambda i: gather_pack_plain(packs[i % VARY], ids, "row"),
                    dev, reps)
        bwd = timed(vjp, dev, reps)
        out[k] = {"gather_ms": fwd, "scatter_add_ms": bwd}
        print(f"K={k}: gather+T={fwd:.4f} ms  scatter-add(bwd)={bwd:.4f} ms")
    return out


def main(argv=None) -> Dict:
    from pcp_tpu_torch.cli.common import add_device_arg

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("which", nargs="?", default="all",
                   choices=("gather", "sort", "xlagather", "all"))
    p.add_argument("--n", type=int, default=N, help="pack rows")
    p.add_argument("--na", type=int, default=NA, help="attributes per row")
    p.add_argument("--nt", type=int, default=NT, help="tiles (id rows)")
    p.add_argument("--k", type=int, default=K, help="ids per tile")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    if args.which in ("gather", "all"):
        print("--- in-kernel gather ---")
        out["gather"] = exp_gather(args.n, args.na, args.nt, args.k,
                                   args.seed, args.reps, dev)
    if args.which in ("sort", "all"):
        print("--- torch.sort ---")
        out["sort"] = exp_sort(seed=args.seed, reps=args.reps, device=dev)
    if args.which in ("xlagather", "all"):
        print("--- plain att build ---")
        out["xlagather"] = exp_xlagather(args.n, args.na, args.nt,
                                         (args.k, 2 * args.k), args.seed,
                                         args.reps, dev)
    return out


if __name__ == "__main__":
    main()
