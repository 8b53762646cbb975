"""Schedule, quaternion and activation helpers (torch counterpart of
``pcp_tpu/utils/general.py``; general_utils.py:18, :29-62, :78-97
semantics)."""

from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Plenoxels-style log-linear LR schedule with optional delayed warmup
    (get_expon_lr_func, general_utils.py:29-62), evaluated in fp32 as the
    JAX version is; returns the fp32 value as a Python float. 0 when
    ``lr_init`` is 0 (a disabled group); ``step`` is clamped to
    [0, max_steps]."""
    f32 = torch.float32
    step = torch.tensor(step, dtype=f32)
    lr_init = torch.tensor(lr_init, dtype=f32)
    lr_final = torch.tensor(lr_final, dtype=f32)
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_lerp = torch.exp(
        torch.log(torch.clamp_min(lr_init, 1e-32)) * (1 - t)
        + torch.log(torch.clamp_min(lr_final, 1e-32)) * t
    )
    if float(lr_init) == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
        log_lerp = delay_rate * log_lerp
    return float(log_lerp)


def inverse_sigmoid(x):
    """logit; opacity is stored pre-sigmoid (general_utils.py:18)."""
    x = torch.as_tensor(x)
    return torch.log(x / (1.0 - x))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=dim, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [w, x, y, z] (..., 4) -> rotation matrices (..., 3, 3),
    normalising first like build_rotation (general_utils.py:78-97)."""
    q = normalize(q, dim=-1)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))
