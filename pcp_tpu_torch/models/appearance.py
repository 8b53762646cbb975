"""Per-view appearance decoupling network (counterpart of
``pcp_tpu/models/appearance.py``; VastGaussian, appearance_network.py:7-61).

A trainable 64-d embedding per view is concatenated onto a 1/32
downsampled render; conv + 4 x (PixelShuffle 2, conv 3x3, ReLU) + an
align-corners bilinear resize + two convs + sigmoid give a multiplicative
map, ``map_scale * sigmoid(x)``: 1 is the reference; the training config's
``pipeline.app_map_scale`` (the JAX package's ``PCP_APP_MAP_SCALE``,
appearance.py:44-46, 160-163) widens the map to (0, scale) so per-view gains
above 1 are expressible. The decoupled image (map * render) feeds the L1
loss; SSIM sees the raw render (train.py:111-117).

NCHW, as PyTorch's convolutions take it; the JAX package is NHWC and
reproduces ``nn.PixelShuffle``'s channel order (appearance.py:49-56), so the
layers correspond one to one. The resize is the JAX package's dense
align-corners matrix applied with two matmuls, which is also deterministic
in its backward. Parameters are fp32 (the JAX package's bf16 path is a TPU
choice); TF32 is off on the card (``pcp_tpu_torch.device``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NUM_EMBEDDINGS = 2048
EMBED_DIM = 64


@functools.lru_cache(maxsize=16)
def _resize_matrix(out: int, inp: int, device: torch.device) -> torch.Tensor:
    """(out, inp) align_corners=True bilinear interpolation matrix, two
    non-zeros per row (appearance.py:59-80)."""
    if out == 1 or inp == 1:
        m = np.zeros((out, inp), np.float32)
        m[:, 0] = 1.0
        return torch.tensor(m, device=device)
    pos = np.arange(out, dtype=np.float64) * ((inp - 1) / (out - 1))
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, inp - 1)
    i1 = np.clip(i0 + 1, 0, inp - 1)
    f = (pos - i0).astype(np.float32)
    m = np.zeros((out, inp), np.float32)
    m[np.arange(out), i0] += 1.0 - f
    m[np.arange(out), i1] += f
    return torch.tensor(m, device=device)


def bilinear_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of (B, C, Hi, Wi) to (B, C, h, w)
    as two dense matmuls, out = Wy @ x @ Wx^T per channel."""
    wy = _resize_matrix(h, x.shape[2], x.device)
    wx = _resize_matrix(w, x.shape[3], x.device)
    x = torch.einsum("oh,bchw->bcow", wy, x)
    return torch.einsum("pw,bchw->bchp", wx, x)


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class AppearanceNetwork(nn.Module):
    """(B, 3+64, H/32, W/32) -> multiplicative map (B, 3, H, W) in
    (0, map_scale)."""

    def __init__(self, map_scale: float = 1.0):
        super().__init__()
        self.map_scale = float(map_scale)
        self.conv0 = _conv(3 + EMBED_DIM, 256)
        self.up = nn.ModuleList(
            [_conv(cin // 4, cout)
             for cin, cout in ((256, 128), (128, 64), (64, 32), (32, 16))])
        self.conv1 = _conv(16, 16)
        self.conv2 = _conv(16, 3)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = F.relu(self.conv0(x))
        for conv in self.up:
            x = F.relu(conv(F.pixel_shuffle(x, 2)))
        x = bilinear_resize(x, h, w)
        m = torch.sigmoid(self.conv2(F.relu(self.conv1(x))))
        return m if self.map_scale == 1.0 else self.map_scale * m

    def convs(self) -> Iterator[nn.Conv2d]:
        """The convs in ``FLAX_CONV_PATHS`` order."""
        yield self.conv0
        yield from self.up
        yield self.conv1
        yield self.conv2


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's lecun_normal: truncated normal (+-2 sigma) with variance
    1 / fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def init_appearance(generator: torch.Generator, device,
                    num_embeddings: int = NUM_EMBEDDINGS,
                    map_scale: float = 1.0) -> Dict:
    """{"embeddings": (E, 64) N(0, 0.01^2), "net": AppearanceNetwork with
    lecun-normal kernels and zero biases}, as init_appearance draws them."""
    net = AppearanceNetwork(map_scale)
    with torch.no_grad():
        for conv in net.convs():
            _lecun_normal_(conv.weight, generator)
            conv.bias.zero_()
        emb = torch.randn((num_embeddings, EMBED_DIM),
                          generator=generator) * 0.01
    return {"embeddings": emb.to(device), "net": net.to(device)}


FLAX_CONV_PATHS = (("Conv_0",),
                   *((f"UpsampleBlock_{i}", "Conv_0") for i in range(4)),
                   ("Conv_1",), ("Conv_2",))


def flax_leaves(tree: Mapping) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) of a nested Flax parameter dict, kernel before bias,
    in the order ``AppearanceNetwork.parameters()`` walks the convs."""
    for path in FLAX_CONV_PATHS:
        node = tree
        for key in path:
            node = node[key]
        yield path + ("kernel",), node["kernel"]
        yield path + ("bias",), node["bias"]


def net_tensors_from_flax(tree: Mapping, device) -> list:
    """A Flax parameter tree (numpy leaves, HWIO kernels) -> the list of
    tensors ``AppearanceNetwork.parameters()`` holds, OIHW, same order."""
    out = []
    for path, leaf in flax_leaves(tree):
        a = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1)
        out.append(torch.tensor(np.ascontiguousarray(a), device=device))
    return out


def appearance_from_flax(app: Mapping, device,
                         map_scale: float = 1.0) -> Dict:
    """{"embeddings": (E, 64), "net": Flax tree} as numpy arrays -> the
    port's appearance state with the same weights."""
    net = AppearanceNetwork(map_scale).to(device)
    with torch.no_grad():
        for p, t in zip(net.parameters(), net_tensors_from_flax(app["net"],
                                                                device)):
            if p.shape != t.shape:
                raise ValueError(f"Flax leaf {tuple(t.shape)} does not fit "
                                 f"{tuple(p.shape)}")
            p.copy_(t)
    emb = torch.tensor(np.asarray(app["embeddings"], np.float32),
                       device=device)
    return {"embeddings": emb, "net": net}


def decouple_appearance(image: torch.Tensor, app: Dict, view_idx: int):
    """(H, W, 3) render -> (map * render, map), both (H, W, 3)
    (decouple_appearance, appearance_network.py:7-17): downsample x32,
    concat the view's embedding, run the CNN."""
    h, w = image.shape[0], image.shape[1]
    hd, wd = max(h // 32, 1), max(w // 32, 1)
    chw = image.permute(2, 0, 1)[None]
    down = bilinear_resize(chw, hd, wd)
    emb = app["embeddings"][view_idx]
    x = torch.cat([down, emb[None, :, None, None].expand(1, EMBED_DIM, hd,
                                                          wd)], dim=1)
    mapping = app["net"](x, h, w)[0].permute(1, 2, 0)
    return mapping * image, mapping
