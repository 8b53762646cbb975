"""Device resolution for every entry point of the port.

``None`` and ``"cuda"`` mean the CUDA card and raise ``RuntimeError`` when
there is none: there is no silent fallback to the CPU. ``"cpu"`` is
honoured only when the caller passes it explicitly (the CPU tests do).
On the CUDA path TF32 is switched off for matmuls and cuDNN, so fp32 math
stays fp32 as in the JAX reference, and cuDNN is held to its deterministic
algorithms with autotuning off (``cudnn.deterministic``, no
``cudnn.benchmark``): the appearance net's convolution gradients then sum in
a fixed order, so training gives the same bits on every run, as the
reference's backward (no atomics) does. There is no switch for either.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pcp_tpu_torch runs on a CUDA card by default and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run "
                "on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
