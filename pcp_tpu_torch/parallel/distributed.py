"""Process groups for the port's multi-card modes (counterpart of
``pcp_tpu/parallel/distributed.py``).

One rank drives one card. ``initialize`` joins the group that
``torchrun`` (``python -m torch.distributed.run``) describes in the
environment, as the JAX package's ``initialize`` joins the coordinator of
``COORDINATOR_ADDRESS``; ``spawn`` starts ``n`` local ranks itself, as the
JAX package uses ``n`` local chips from one command. The backend is NCCL on
``cuda:LOCAL_RANK`` and gloo for ``--device cpu``; a failing backend
raises, there is no switch from one to the other.

Rendezvous for ``spawn`` and ``local_group`` goes through a ``FileStore``
in a fresh temporary directory, so concurrent runs on one machine never
share a port or a file.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from pcp_tpu_torch.device import DeviceLike, resolve_device

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
# seconds ``spawn`` waits for its ranks; None waits for ever (the CLIs).
# The tests set a limit, so a hung collective fails instead of stalling.
JOIN_TIMEOUT_S: Optional[float] = None


def backend_of(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device: DeviceLike, local_rank: int) -> torch.device:
    """The card of ``local_rank`` (``cuda:<local_rank>``), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {local_rank} needs cuda:{local_rank}, but "
            f"{torch.cuda.device_count()} card(s) are visible")
    torch.cuda.set_device(local_rank)
    return resolve_device(torch.device("cuda", local_rank))


def initialize(device: DeviceLike = None) -> Optional[torch.device]:
    """Join torchrun's process group: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the
    environment. Returns this rank's device, or None (nothing joined) when
    the environment does not describe a group, as JAX's ``initialize``
    returns False without ``COORDINATOR_ADDRESS``."""
    if any(k not in os.environ for k in TORCHRUN_ENV):
        return None
    dev = rank_device(device, int(os.environ["LOCAL_RANK"]))
    if not dist.is_initialized():
        dist.init_process_group(
            backend_of(dev), init_method="env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def local_block_slice(n_blocks: int, rank: int, world: int) -> slice:
    """The blocks rank ``rank`` of ``world`` owns under even contiguous
    sharding (JAX ``local_block_slice``: ceil(n / world) each, the last
    ranks fewer or none)."""
    per = (n_blocks + world - 1) // world
    return slice(min(rank * per, n_blocks), min((rank + 1) * per, n_blocks))


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def allreduce_int(x: int, device: torch.device,
                  op=dist.ReduceOp.SUM) -> int:
    """``x`` reduced over the joined group's ranks (``x`` itself without
    one)."""
    if not dist.is_initialized():
        return x
    t = torch.tensor([x], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=op)
    return int(t.item())


@contextlib.contextmanager
def local_group(device: torch.device, store_path: str, rank_: int,
                world_: int) -> Iterator[None]:
    """A process group of ``world_`` local ranks that meet at the
    ``FileStore`` ``store_path``; destroyed on exit."""
    store = dist.FileStore(store_path, world_)
    dist.init_process_group(backend_of(device), store=store, rank=rank_,
                            world_size=world_)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn: Callable, r: int, n: int, device: str, store_path: str,
               threads: int, args: Sequence) -> None:
    torch.set_num_threads(threads)
    dev = rank_device(device, r)
    with local_group(dev, store_path, r, n):
        fn(dev, *args)


def spawn(fn: Callable, n: int, device: DeviceLike, *args) -> None:
    """Run ``fn(rank_device, *args)`` in ``n`` new processes, one rank
    each, joined in one process group (NCCL on ``cuda:<rank>``, gloo on the
    CPU). ``fn`` and ``args`` must pickle. Each rank runs on as many CPU
    threads as this process. Raises when a rank fails or when
    ``JOIN_TIMEOUT_S`` seconds pass; the other ranks are then stopped."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    timeout = JOIN_TIMEOUT_S
    tmp = tempfile.mkdtemp(prefix="pcp_rdzv_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(
        target=_rank_main,
        args=(fn, r, n, str(dev), os.path.join(tmp, "store"),
              torch.get_num_threads(), args), daemon=False)
        for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"rank(s) {bad} of {n} failed (exit codes "
                    f"{[procs[r].exitcode for r in bad]})")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{timeout} s")
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(
                f"rank(s) {bad} of {n} failed (exit codes "
                f"{[procs[r].exitcode for r in bad]})")
    finally:
        procs = [p for p in procs if p.pid is not None]
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def group_of(device: torch.device, n: int) -> Iterator[None]:
    """The process group ``n`` ranks of this process need: the one already
    joined (torchrun), else a new one-rank group when ``n`` is 1. Several
    ranks of one process do not exist: ``spawn`` them."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(
                f"{n} ranks asked for, but the joined group has "
                f"{dist.get_world_size()}")
        yield
        return
    if n != 1:
        raise ValueError("more than one rank: start them with spawn()")
    tmp = tempfile.mkdtemp(prefix="pcp_rdzv_")
    try:
        with local_group(device, os.path.join(tmp, "store"), 0, 1):
            yield
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
