"""Attribute gather by id in three layouts (counterpart of the kernel that
``tools/exp_r2.py`` ``exp_gather`` builds; pallas_call at exp_r2.py:80).

``gather_pack(pack, ids, layout)`` returns out (NT, NA, K) f32 with
out[t, a, k] = pack[ids[t, k], a]. ``layout`` names how the pack is held
and read, as the tool's three forms do:

- ``"row"`` (form2_row_take): pack (N, NA), one row load per id;
- ``"col"`` (form1_col_take): pack (N, NA), the row form's input; the TPU
  bodies differ, the function does not, so on the card it runs the row
  kernel;
- ``"plane"`` (form3_lane_take): pack transposed, (NA, N), one scalar load
  per attribute plane, two planes at a time across the whole grid.

For CUDA tensors the wrapper launches the hand-written kernel
(``csrc/gather_pack.cu``); for CPU tensors it runs the plain version
``gather_pack_plain``. A CUDA tensor either reaches the kernel or raises.
The plain version is one ``index_select`` and a ``permute().contiguous()``:
it is also the library yardstick. Ids must lie in [0, N): the plain
version raises on others and the kernel writes NaN for them.
"""

from __future__ import annotations

import ctypes

import torch

from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops.composite import LAUNCHES, check_tensors

LAYOUTS = ("row", "col", "plane")


def gather_pack_plain(pack, ids, layout: str):
    """``pack[ids]`` (or ``packT[:, ids]``) permuted to (NT, NA, K)."""
    nt, k = ids.shape
    flat = ids.reshape(-1)
    if layout == "plane":
        g = torch.index_select(pack, 1, flat)              # (NA, NT * K)
        return g.reshape(-1, nt, k).permute(1, 0, 2).contiguous()
    g = torch.index_select(pack, 0, flat)                  # (NT * K, NA)
    return g.reshape(nt, k, -1).permute(0, 2, 1).contiguous()


def gather_pack(pack, ids, layout: str):
    """(NT, NA, K) f32 gather of ``pack`` rows by ``ids`` (NT, K) int32 in
    ``layout`` (``LAYOUTS``): pack is (N, NA) for "row" and "col", (NA, N)
    for "plane". CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    check_tensors(pack.device, (("pack", pack, torch.float32),
                                ("ids", ids, torch.int32)))
    if pack.dim() != 2 or ids.dim() != 2:
        raise ValueError("pack and ids must be 2-D")
    na, n = pack.shape if layout == "plane" else pack.shape[::-1]
    if layout != "plane" and (na % 4 or pack.data_ptr() % 16):
        raise ValueError(f"the {layout} layout reads float4: NA must be a "
                         "multiple of 4 and the pack 16-byte aligned")
    if pack.device.type == "cpu":
        return gather_pack_plain(pack, ids, layout)
    if pack.device.type != "cuda":
        raise ValueError(f"gather_pack: unsupported device {pack.device}")
    nt, k = ids.shape
    fn = getattr(_build.load("gather_pack"), f"gather_pack_{layout}")
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    dev = pack.device
    out = torch.empty((nt, na, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pack.data_ptr(), ids.data_ptr(), int(n), int(na), int(nt),
                 int(k), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather_pack_{layout} kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[f"gather_pack_{layout}"] += 1
    return out
