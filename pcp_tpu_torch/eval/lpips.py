"""LPIPS (v0.1, AlexNet backbone) as a PyTorch module in NCHW (counterpart
of ``pcp_tpu/eval/lpips.py``; lpipsPyTorch/ of the reference).

AlexNet's five conv stages (ReLU after each, 3x3/2 max pool after the first
two), unit-normalised per-channel differences at the five taps, 1x1 linear
heads, a spatial mean, and the sum over the taps. The convolutions are
``F.conv2d`` with TF32 off on the card (``resolve_device``), as the JAX
package computes them with ``lax.conv`` in fp32.

No weights ship with the repo and none are downloaded. They load from

- an ``.npz`` in the JAX package's layout (HWIO convs ``conv{i}_{w,b}``,
  heads ``lin{i}_w``), or
- torch ``.pth`` files: one combined file, or ``alexnet.pth,alex.pth``
  (comma-joined torchvision AlexNet and richzhang LPIPS v0.1 heads),

passed to ``--lpips_weights`` or set in ``PCP_LPIPS_WEIGHTS``. Without
weights ``make_lpips`` returns None and the metrics report LPIPS as null.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcp_tpu_torch.device import DeviceLike, resolve_device

# AlexNet feature stages: (out_channels, kernel, stride, padding) per conv,
# with ReLU after each and maxpool(3, 2) after stages 0 and 1.
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_CONV_IDX = [0, 3, 6, 8, 10]  # conv layer positions in alexnet.features
_REQUIRED = [f"conv{i}_{s}" for i in range(5) for s in "wb"] + [
    f"lin{i}_w" for i in range(5)
]


def _normalize_tensor(x, eps=1e-10):
    """Unit norm over the channel axis, ``eps`` inside the square root."""
    return x / torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """lpips(img1, img2) over (H, W, 3) images in [0, 1] -> 0-d tensor."""

    def __init__(self):
        super().__init__()
        convs, c_in = [], 3
        for c, k, s, p in _ALEX_CONVS:
            convs.append(nn.Conv2d(c_in, c, k, stride=s, padding=p))
            c_in = c
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(
            nn.Conv2d(c, 1, 1, bias=False) for c, *_ in _ALEX_CONVS)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1))

    def features(self, x):
        """x: (N, 3, H, W) in [-1, 1]; the five tap activations."""
        x = (x - self.shift) / self.scale
        taps = []
        for i, conv in enumerate(self.convs):
            x = F.relu(conv(x))
            taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return taps

    def forward(self, img1, img2):
        x = torch.stack([img1, img2]).permute(0, 3, 1, 2) * 2.0 - 1.0
        total = 0.0
        for f, lin in zip(self.features(x), self.lins):
            n = _normalize_tensor(f)
            d = (n[:1] - n[1:]) ** 2
            total = total + lin(d).mean()
        return total


def lpips_from_numpy(weights: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> LPIPS:
    """An ``LPIPS`` on ``device`` (the card unless ``"cpu"``) from the JAX
    package's arrays: HWIO convs become OIHW, (C,) heads (1, C, 1, 1)."""
    dev = resolve_device(device)
    model = LPIPS()
    with torch.no_grad():
        for i, (conv, lin) in enumerate(zip(model.convs, model.lins)):
            w = np.transpose(np.asarray(weights[f"conv{i}_w"], np.float32),
                             (3, 2, 0, 1))
            conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
            conv.bias.copy_(torch.from_numpy(
                np.asarray(weights[f"conv{i}_b"], np.float32)))
            lin.weight.copy_(torch.from_numpy(np.asarray(
                weights[f"lin{i}_w"], np.float32)).reshape(lin.weight.shape))
    return model.requires_grad_(False).eval().to(dev)


def synthetic_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random AlexNet-LPIPS weights in the JAX package's layout, the recipe
    of ``tools/make_lpips_weights.py --synthetic``: He-scaled filters, zero
    biases, positive heads over their width, and a ``synthetic`` marker. A
    stand-in until pretrained weights are in the repo: the distance is 0 on
    equal images, but its values are not comparable to published LPIPS."""
    rng = np.random.default_rng(seed)
    out, c_in = {}, 3
    for i, (c, k, _, _) in enumerate(_ALEX_CONVS):
        std = np.sqrt(2.0 / (c_in * k * k))
        out[f"conv{i}_w"] = (
            rng.standard_normal((k, k, c_in, c)).astype(np.float32) * std)
        out[f"conv{i}_b"] = np.zeros(c, np.float32)
        c_in = c
    for i, (c, *_) in enumerate(_ALEX_CONVS):
        out[f"lin{i}_w"] = np.abs(
            rng.standard_normal(c).astype(np.float32)) / c
    out["synthetic"] = np.int32(1)
    return out


def _map_torch_weights(flat) -> dict:
    """Flat {torch key: array} -> the JAX package's weight names. Accepts
    torchvision AlexNet keys (``features.N.weight``) and LPIPS head keys
    (``lin{i}.model.1.weight``, richzhang v0.1 naming) under any prefix."""
    out = {}
    for i, ci in enumerate(_CONV_IDX):
        wk = [k for k in flat if k.endswith(f"features.{ci}.weight")]
        bk = [k for k in flat if k.endswith(f"features.{ci}.bias")]
        if wk and bk:
            w = np.asarray(flat[wk[0]], np.float32)      # (O, I, kH, kW)
            out[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0))  # HWIO
            out[f"conv{i}_b"] = np.asarray(flat[bk[0]], np.float32)
    for i in range(5):
        cands = [
            k for k in flat
            if k.endswith(f"lin{i}.model.1.weight")
            or k.endswith(f"lins.{i}.model.1.weight")
            or k == f"lin{i}.weight"
        ]
        if cands:
            out[f"lin{i}_w"] = np.asarray(
                flat[cands[0]], np.float32).reshape(-1)
    return out


def _flat_tensors(obj, prefix: str, out: dict) -> None:
    """The tensors of a loaded checkpoint as {``/``-joined key: fp32
    array}, nested containers flattened."""
    if torch.is_tensor(obj):
        out[prefix] = obj.float().numpy()
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flat_tensors(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flat_tensors(v, f"{prefix}/{i}" if prefix else str(i), out)


def load_weights(path: str) -> Optional[dict]:
    """LPIPS weights in the JAX package's layout from an ``.npz`` or
    (comma-joined) torch ``.pth`` files; None, with a warning when keys are
    missing, if they are incomplete or a file does not exist."""
    parts = [p for p in path.split(",") if p]
    if not all(os.path.exists(p) for p in parts):
        return None
    if len(parts) == 1 and not parts[0].endswith(".pth"):
        return dict(np.load(parts[0]))
    flat: dict = {}
    for p in parts:
        _flat_tensors(torch.load(p, map_location="cpu", weights_only=True),
                      "", flat)
    weights = _map_torch_weights(flat)
    missing = [k for k in _REQUIRED if k not in weights]
    if missing:
        print(f"[lpips] {path}: missing weights {missing[:4]}... — "
              f"supply torchvision AlexNet AND the LPIPS linear heads")
        return None
    return weights


def make_lpips(weights_path: Optional[str] = None,
               device: DeviceLike = None) -> Optional[LPIPS]:
    """The LPIPS module on ``device`` from ``weights_path`` or, without one,
    ``PCP_LPIPS_WEIGHTS``; None when neither names loadable weights."""
    path = weights_path or os.environ.get("PCP_LPIPS_WEIGHTS", "")
    if not path:
        return None
    data = load_weights(path)
    if data is None:
        return None
    return lpips_from_numpy(data, device)
