"""Per-Gaussian sums of per-pair gradient rows (counterpart of
``pcp_tpu/ops/segsum_pallas.py`` ``sorted_segment_sum``).

Two entry points reach one hand-written CUDA kernel (``csrc/segsum.cu``):

- ``gathered_segment_sum(rows, order, offsets, n)``: the backward's form.
  The rows stay in pair-list (tile-major) order, as the blend's backward
  writes them, and ``order`` is the binning's sort permutation
  (``TileBins.order``: pair-list row i holds Gaussian-major position
  order[i]). The kernel first inverts it into an int32 index (one scatter)
  and then reads each Gaussian's rows through that index, so no
  Gaussian-major copy of the rows is made.
- ``sorted_segment_sum(gs, s_gid, n, offsets=None)``: the JAX package's
  form, rows already in gid order (the kernel with the identity index).

Each wrapper launches the kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; a CUDA tensor either reaches the kernel or
raises. Rows are (M, 9) here, one row per pair, where the JAX package keeps
(9, M) planes. Gaussian g sums the rows of Gaussian-major positions
[offsets[g], offsets[g + 1]) in that order, in float64, and rounds the sum
once to float32 (an fp32 accumulator's error grows with the segment's
length past the 1e-6 of its sum of |terms| that the card's check allows
at the default tier); positions past offsets[n]
(gid >= n, the TPU kernel's pads) are ignored. The binning already holds
the offsets (``TileBins.offsets``); ``sorted_segment_sum`` derives them
from the gids when the caller has none.
"""

from __future__ import annotations

import ctypes

import torch

from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops.binning import gaussian_major
from pcp_tpu_torch.ops.composite import LAUNCHES, NA, check_tensors


def segment_offsets(s_gid, n: int):
    """(n + 1,) int32: Gaussian g owns rows [offsets[g], offsets[g + 1]) of
    the nondecreasing ``s_gid``; rows with gid >= n lie past offsets[n]."""
    return torch.searchsorted(
        s_gid, torch.arange(n + 1, dtype=torch.int32, device=s_gid.device),
        out_int32=True)


def sorted_segment_sum_plain(gs, s_gid, n: int, fp64: bool = False):
    """``index_add_`` of the rows with gid < n in float64, rounded once to
    float32 as the kernel rounds its fp64 sums: sequential in row order on
    the CPU, the order the kernel sums in. ``fp64`` returns the float64
    sums unrounded: the witness that says how far an fp32 result is off."""
    out = torch.zeros((n, gs.shape[1]), dtype=torch.float64, device=gs.device)
    keep = s_gid < n
    out.index_add_(0, s_gid[keep].to(torch.int64), gs[keep].double())
    return out if fp64 else out.float()


def _check_offsets(offsets, n: int, device) -> None:
    check_tensors(device, (("offsets", offsets, torch.int32),))
    if offsets.shape != (n + 1,):
        raise ValueError(f"offsets must be ({n + 1},), got "
                         f"{tuple(offsets.shape)}")


def _check_rows(rows) -> None:
    if rows.dim() != 2 or rows.shape[1] != NA:
        raise ValueError(f"rows must be (M, {NA}), got {tuple(rows.shape)}")


def _launch(name: str, args, n: int, device) -> torch.Tensor:
    """Runs the kernel entry ``name`` on ``args`` (its arguments before
    ``n``: pointers as ints, sizes as ``ctypes.c_int``) into a new (n, 9)
    output; counts the launch."""
    fn = getattr(_build.load("segsum"), name)
    fn.argtypes = [ctypes.c_int if isinstance(a, ctypes.c_int) else
                   ctypes.c_void_p for a in args] + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty((n, NA), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, int(n), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES["sorted_segment_sum"] += 1
    return out


def gathered_segment_sum_plain(rows, order, offsets, n: int):
    """``gaussian_major`` (one scatter of the rows), then
    ``sorted_segment_sum_plain`` (fp64 sums rounded to fp32) with each
    position's gid read from ``offsets``."""
    ordered = gaussian_major(rows, order)
    lo, hi = int(offsets[0]), int(offsets[n])
    gid = torch.repeat_interleave(
        torch.arange(n, device=rows.device), offsets.diff().to(torch.int64),
        output_size=hi - lo)
    out = torch.zeros((n, rows.shape[1]), dtype=torch.float64,
                      device=rows.device)
    return out.index_add_(0, gid, ordered[lo:hi].double()).float()


def gathered_segment_sum(rows, order, offsets, n: int):
    """(n, 9) f32: Gaussian g's sum, in order, of the rows that ``order``
    places at Gaussian-major positions [offsets[g], offsets[g + 1]).
    ``rows`` (M, 9) f32 in pair-list order, ``order`` (M,) int64 a
    permutation of [0, M) (row i belongs at position order[i]),
    ``offsets`` (n + 1,) int32 nondecreasing with offsets[n] <= M.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    check_tensors(rows.device, (("rows", rows, torch.float32),
                                ("order", order, torch.int64)))
    _check_rows(rows)
    if order.shape != rows.shape[:1]:
        raise ValueError("order must hold one position per row of rows")
    _check_offsets(offsets, n, rows.device)
    if rows.device.type == "cpu":
        return gathered_segment_sum_plain(rows, order, offsets, n)
    if rows.device.type != "cuda":
        raise ValueError(f"gathered_segment_sum: unsupported device "
                         f"{rows.device}")
    m = rows.shape[0]
    inv = torch.empty(m, dtype=torch.int32, device=rows.device)
    return _launch("gathered_segment_sum",
                   (rows.data_ptr(), order.data_ptr(), ctypes.c_int(m),
                    inv.data_ptr(), offsets.data_ptr()), n, rows.device)


def sorted_segment_sum(gs, s_gid, n: int, offsets=None):
    """(n, 9) f32 sums of the rows of ``gs`` (M, 9) over each gid of the
    nondecreasing ``s_gid`` (M,) int32. ``offsets`` (n + 1,) int32, if
    given, must be ``segment_offsets(s_gid, n)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    check_tensors(gs.device, (("gs", gs, torch.float32),
                              ("s_gid", s_gid, torch.int32)))
    _check_rows(gs)
    if s_gid.shape != gs.shape[:1]:
        raise ValueError("s_gid must hold one gid per row of gs")
    if offsets is not None:
        _check_offsets(offsets, n, gs.device)
    if gs.device.type == "cpu":
        return sorted_segment_sum_plain(gs, s_gid, n)
    if gs.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {gs.device}")
    if offsets is None:
        offsets = segment_offsets(s_gid, n)
    return _launch("sorted_segment_sum", (gs.data_ptr(), offsets.data_ptr()),
                   n, gs.device)
