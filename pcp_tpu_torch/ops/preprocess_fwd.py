"""A view's preprocess from the model's stored parameters: the activation,
the SH read, projection, the EWA conic, radius, colour, tile rect and the
blend's row (the render path's forward, with no gradient).

``preprocess_params`` launches the hand-written CUDA kernel
``csrc/preprocess_fwd.cu`` for CUDA tensors (one pass over the parameters)
and runs ``preprocess_params_plain`` for CPU tensors: the composition of
``G.opacity_act``, ``G.scaling_act``, ``G.sh_coeffs``,
``projection.preprocess`` and ``composite.pack_attributes`` that the render
path runs under autograd. There is no fallback from one to the other: a
CUDA tensor either reaches the kernel or raises.

Both return ``(prep, pack)``: ``pack`` (N, 9) f32 rows [mx, my, conic a, b,
c, r, g, b, opacity] and ``prep`` with ``projection.preprocess``'s keys;
on the kernel's path ``means2d``, ``conics``, ``rgb`` and ``opacity`` are
views of ``pack``.
"""

from __future__ import annotations

import ctypes

import torch
from torch.profiler import record_function

from pcp_tpu_torch.models import gaussians as G
from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops.composite import (
    LAUNCHES,
    NA,
    check_tensors,
    pack_attributes,
)
from pcp_tpu_torch.ops.projection import CameraIntrin, preprocess


def preprocess_params_plain(params, alive, viewmat, intrin: CameraIntrin,
                            image_size, sh_degree: int, *,
                            scaling_modifier: float = 1.0, tan_fov=None,
                            means2d_offset=None):
    """Activate, concatenate the SH and run ``projection.preprocess`` and
    ``pack_attributes`` (the last two in the ``preprocess`` range): the
    render path's preprocess in tensor ops, differentiable, with the
    training step's ``means2d_offset`` probe."""
    opac = G.opacity_act(params["opacity"])[:, 0] * alive.to(torch.float32)
    scales = G.scaling_act(params["scaling"]) * scaling_modifier
    sh = G.sh_coeffs(params)
    with record_function("preprocess"):
        prep = preprocess(params["xyz"], scales, params["rotation"], opac, sh,
                          viewmat, intrin, image_size, sh_degree,
                          tan_fov=tan_fov, means2d_offset=means2d_offset)
        return prep, pack_attributes(prep)


def _check(params, alive, viewmat, intrin, sh_degree):
    f32 = torch.float32
    check_tensors(params["xyz"].device,
                  [(k, params[k], f32) for k in G.PARAM_KEYS]
                  + [("alive", alive, torch.bool), ("viewmat", viewmat, f32)]
                  + [(k, v, f32) for k, v in zip(CameraIntrin._fields,
                                                 intrin)])
    n = params["xyz"].shape[0]
    got = dict(params, alive=alive, viewmat=viewmat)
    for k, shape in (("xyz", (n, 3)), ("scaling", (n, 3)),
                     ("rotation", (n, 4)), ("opacity", (n, 1)),
                     ("f_dc", (n, 3)), ("alive", (n,)), ("viewmat", (4, 4))):
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{k} must be {shape}, got "
                             f"{tuple(got[k].shape)}")
    rest = params["f_rest"]
    if rest.dim() != 3 or rest.shape[0] != n or rest.shape[2] != 3:
        raise ValueError(f"f_rest must be ({n}, R, 3), got "
                         f"{tuple(rest.shape)}")
    if not 0 <= sh_degree <= 3:
        raise ValueError(f"SH degree {sh_degree} outside [0, 3]")
    if rest.shape[1] < (sh_degree + 1) ** 2 - 1:
        raise ValueError(f"f_rest holds {rest.shape[1]} rows, SH degree "
                         f"{sh_degree} needs {(sh_degree + 1) ** 2 - 1}")
    if any(v.dim() != 0 for v in intrin):
        raise ValueError("intrinsics must be scalars")


def preprocess_params(params, alive, viewmat, intrin: CameraIntrin,
                      image_size, sh_degree: int, *,
                      scaling_modifier: float = 1.0, tan_fov=None):
    """(prep, pack) of the pre-activation ``params`` (``G.PARAM_KEYS``, f32,
    contiguous) and ``alive`` (N,) bool for one view; dead slots get
    opacity 0 and are culled. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(params, alive, viewmat, intrin, sh_degree)
    dev = params["xyz"].device
    if dev.type == "cpu":
        return preprocess_params_plain(
            params, alive, viewmat, intrin, image_size, sh_degree,
            scaling_modifier=scaling_modifier, tan_fov=tan_fov)
    if dev.type != "cuda":
        raise ValueError(f"preprocess_params: unsupported device {dev}")
    n = params["xyz"].shape[0]
    with record_function("preprocess"):
        pack = torch.empty((n, NA), dtype=torch.float32, device=dev)
        depths = torch.empty(n, dtype=torch.float32, device=dev)
        rect = torch.empty((n, 4), dtype=torch.int32, device=dev)
        radii = torch.empty(n, dtype=torch.float32, device=dev)
        visible = torch.empty(n, dtype=torch.bool, device=dev)
        if n > 0:
            with torch.cuda.device(dev):
                _operator()(
                    *(params[k] for k in G.PARAM_KEYS), alive, viewmat,
                    *intrin, int(image_size[0]), int(image_size[1]),
                    sh_degree, float(scaling_modifier),
                    None if tan_fov is None else [float(v) for v in tan_fov],
                    pack, depths, rect, radii, visible)
            LAUNCHES["preprocess_fwd"] += 1
    prep = {"means2d": pack[:, 0:2], "depths": depths,
            "conics": pack[:, 2:5], "radii": radii, "rgb": pack[:, 5:8],
            "opacity": pack[:, 8], "rect": rect, "visible": visible}
    return prep, pack


_OPS = {}


def _operator():
    """The kernel's launch as the operator ``pcp_tpu_torch::preprocess_fwd``
    (defined at first use). The profiler ties a launch to the operator it
    is made in and never to a ``record_function`` range alone, so inside an
    operator the kernel's device time joins the ``preprocess`` range."""
    if "op" in _OPS:
        return _OPS["op"]
    fn = _build.load("preprocess_fwd").preprocess_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int

    def launch(xyz, f_dc, f_rest, scaling, rotation, opacity, alive,
               viewmat, fx, fy, cx, cy, width, height, sh_degree,
               scaling_modifier, tan_fov, pack, depths, rect, radii,
               visible):
        tanx, tany = (0.0, 0.0) if tan_fov is None else tan_fov
        ptr = [t.data_ptr() for t in (xyz, scaling, rotation, opacity, alive,
                                      f_dc, f_rest)]
        err = fn(*ptr, f_rest.shape[1], viewmat.data_ptr(), fx.data_ptr(),
                 fy.data_ptr(), cx.data_ptr(), cy.data_ptr(), xyz.shape[0],
                 width, height, sh_degree, scaling_modifier,
                 tan_fov is not None, tanx, tany, pack.data_ptr(),
                 depths.data_ptr(), rect.data_ptr(), radii.data_ptr(),
                 visible.data_ptr(),
                 torch.cuda.current_stream(xyz.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"preprocess_fwd kernel launch failed: CUDA "
                               f"error {err}")

    lib = torch.library.Library("pcp_tpu_torch", "FRAGMENT")
    lib.define(
        "preprocess_fwd(Tensor xyz, Tensor f_dc, Tensor f_rest, "
        "Tensor scaling, Tensor rotation, Tensor opacity, Tensor alive, "
        "Tensor viewmat, Tensor fx, Tensor fy, Tensor cx, Tensor cy, "
        "int width, int height, int sh_degree, float scaling_modifier, "
        "float[]? tan_fov, Tensor(a!) pack, Tensor(b!) depths, "
        "Tensor(c!) rect, Tensor(d!) radii, Tensor(e!) visible) -> ()")
    lib.impl("preprocess_fwd", launch, "CUDA")
    _OPS["lib"] = lib                    # the registration lives with it
    _OPS["op"] = torch.ops.pcp_tpu_torch.preprocess_fwd
    return _OPS["op"]
