"""Per-Gaussian sums of gid-sorted gradient rows (counterpart of
``pcp_tpu/ops/segsum_pallas.py`` ``sorted_segment_sum``).

``sorted_segment_sum`` launches the hand-written CUDA kernel
(``csrc/segsum.cu``) for CUDA tensors and runs the plain PyTorch version
``sorted_segment_sum_plain`` for CPU tensors; a CUDA tensor either reaches
the kernel or raises. Rows are (M, 9) here, one row per pair, where the JAX
package keeps (9, M) planes; rows whose gid is >= n are ignored, as in the
TPU kernel. The kernel reads each Gaussian's range of rows from
``offsets``; the binning already holds them (``TileBins.offsets``), and the
wrapper derives them from the gids when the caller has none.
"""

from __future__ import annotations

import ctypes

import torch

from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops.composite import LAUNCHES, NA, check_tensors


def segment_offsets(s_gid, n: int):
    """(n + 1,) int32: Gaussian g owns rows [offsets[g], offsets[g + 1]) of
    the nondecreasing ``s_gid``; rows with gid >= n lie past offsets[n]."""
    return torch.searchsorted(
        s_gid, torch.arange(n + 1, dtype=torch.int32, device=s_gid.device),
        out_int32=True)


def sorted_segment_sum_plain(gs, s_gid, n: int):
    """``index_add_`` of the rows with gid < n: sequential in row order on
    the CPU, the order the kernel sums in."""
    out = torch.zeros((n, gs.shape[1]), dtype=torch.float32, device=gs.device)
    keep = s_gid < n
    return out.index_add_(0, s_gid[keep].to(torch.int64), gs[keep])


def sorted_segment_sum(gs, s_gid, n: int, offsets=None):
    """(n, 9) f32 sums of the rows of ``gs`` (M, 9) over each gid of the
    nondecreasing ``s_gid`` (M,) int32. ``offsets`` (n + 1,) int32, if
    given, must be ``segment_offsets(s_gid, n)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    check_tensors(gs.device, (("gs", gs, torch.float32),
                              ("s_gid", s_gid, torch.int32)))
    if gs.dim() != 2 or gs.shape[1] != NA:
        raise ValueError(f"gs must be (M, {NA}), got {tuple(gs.shape)}")
    if s_gid.shape != gs.shape[:1]:
        raise ValueError("s_gid must hold one gid per row of gs")
    if offsets is not None:
        check_tensors(gs.device, (("offsets", offsets, torch.int32),))
        if offsets.shape != (n + 1,):
            raise ValueError(f"offsets must be ({n + 1},), got "
                             f"{tuple(offsets.shape)}")
    if gs.device.type == "cpu":
        return sorted_segment_sum_plain(gs, s_gid, n)
    if gs.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {gs.device}")
    if offsets is None:
        offsets = segment_offsets(s_gid, n)
    fn = _build.load("segsum").sorted_segment_sum
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    dev = gs.device
    out = torch.empty((n, NA), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(gs.data_ptr(), offsets.data_ptr(), int(n), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"sorted_segment_sum kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["sorted_segment_sum"] += 1
    return out
