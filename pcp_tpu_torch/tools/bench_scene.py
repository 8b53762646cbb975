"""The canonical benchmark scene: a trained block's density statistics
(counterpart of ``tools/bench_scene.py``).

The Gaussians fill a camera's frustum (depths 8..60, ~20% spill outside
the frame), with splat sizes set in pixels (lognormal, median 4 px sigma at
100k live, shrinking as sqrt(100k / n) so coverage stays bounded by the
image), mild anisotropy and an opacity mix uniform in [0.1, 0.8]: what
converged 3DGS blocks look like after densify and prune, not raw kNN init.
At 100k live and 800x600 that gives ~8 tiles a Gaussian.

``make_scene`` makes the JAX module's numpy draws in the same order, so a
seed gives the same arrays in both packages. Width, height and focal length
are arguments here (the JAX tools set them on the module, as
``tools/profile_scale.py`` does); the defaults are the JAX constants.
"""

from __future__ import annotations

import numpy as np
import torch

W, H = 800, 600
FX = 700.0
N_POINTS = 100_000
SIGMA_PX_MEDIAN = 4.0
SIGMA_PX_LOGSTD = 0.6


def capacity_for(n_points: int) -> int:
    """Slots for ``n_points`` live: 1.31 n rounded up to a power of two,
    at least 2^17 (2^17 at the canonical 100k)."""
    return 1 << max(17, int(np.ceil(np.log2(n_points * 1.31))))


def make_scene(rng=None, n_points: int = None, capacity: int = None,
               width: int = W, height: int = H, fx: float = FX,
               device=None):
    """(params, alive) of ``n_points`` live Gaussians (default 100k) in
    ``capacity`` slots (default ``capacity_for``) on ``device`` (the card
    unless ``"cpu"``), built with ``models.gaussians.create_from_pcd`` and
    then given pixel-space scales and the opacity mix; dead slots hold -10
    log-scales and opacity logits. fy = fx."""
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.models import gaussians as G

    dev = resolve_device(device)
    n_points = n_points or N_POINTS
    capacity = capacity or capacity_for(n_points)
    sigma_med = SIGMA_PX_MEDIAN * float(np.sqrt(N_POINTS / n_points))

    rng = rng or np.random.default_rng(0)
    depth = rng.uniform(8.0, 60.0, n_points).astype(np.float32)
    half_w = (width / 2 + 60) / fx * depth
    half_h = (height / 2 + 60) / fx * depth
    xyz = np.stack(
        [rng.uniform(-1, 1, n_points) * half_w,
         rng.uniform(-1, 1, n_points) * half_h,
         depth], -1,
    ).astype(np.float32)
    rgb = rng.uniform(0, 1, (n_points, 3)).astype(np.float32)

    gcfg = G.GaussianConfig(sh_degree=3, capacity=capacity)
    params, alive = G.create_from_pcd(xyz, rgb, gcfg, dev)

    sigma_px = np.exp(
        rng.normal(np.log(sigma_med), SIGMA_PX_LOGSTD, n_points)
    ).astype(np.float32)
    sigma_world = sigma_px * depth / fx
    scaling = np.full((capacity, 3), -10.0, np.float32)
    scaling[:n_points] = np.log(sigma_world)[:, None] * np.ones(
        (1, 3), np.float32)
    scaling[:n_points] += rng.uniform(-0.35, 0.35,
                                      (n_points, 3)).astype(np.float32)
    params["scaling"] = torch.from_numpy(scaling).to(dev)

    op = rng.uniform(0.1, 0.8, n_points).astype(np.float32)
    opacity = np.full((capacity, 1), -10.0, np.float32)
    opacity[:n_points, 0] = np.log(op / (1.0 - op))
    params["opacity"] = torch.from_numpy(opacity).to(dev)
    return params, alive


def camera(width: int = W, height: int = H, fx: float = FX, device=None):
    """(viewmat, CameraIntrin) of the bench view: identity pose, fx = fy,
    principal point (W/2, H/2), as fp32 tensors on ``device``."""
    from pcp_tpu_torch.device import resolve_device
    from pcp_tpu_torch.ops.projection import CameraIntrin

    dev = resolve_device(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    viewmat = torch.eye(4, dtype=torch.float32, device=dev)
    return viewmat, CameraIntrin(fx=scalar(fx), fy=scalar(fx),
                                 cx=scalar(width / 2), cy=scalar(height / 2))
