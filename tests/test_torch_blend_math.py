"""The blend kernels' shared sample rule (``csrc/blend_math.cuh``) through
its plain mirror in ``ops/composite.py``, and the kernel build's hash.

A warp passes over a row, expf and all, where the row's box misses its
pixels; the box is sized from the row's log-domain threshold. Both must be
conservative: no power below the threshold, and no pixel outside the box,
may hold a sample that ``composite_fwd_plain``'s exact test applies
(power <= 0 and min(0.99, op exp(power)) >= 1/255), or the forward and the
backward would blend another set of samples than the plain version.
"""

import re
from pathlib import Path

import numpy as np
import torch

from pcp_tpu_torch.ops import _build
from pcp_tpu_torch.ops import composite

HEADER = Path(composite.__file__).resolve().parent.parent / "csrc" / \
    "blend_math.cuh"


def _exact_applied(op, power):
    """composite_fwd_plain's test of one sample, in its fp32 operations."""
    alpha = torch.clamp_max(op * torch.exp(power), composite.ALPHA_MAX)
    return ~(power > 0.0) & ~(alpha < composite.ALPHA_MIN)


def test_skip_never_drops_an_applied_sample():
    # opacities from 1e-7 to 1 and around 1/255; at each, the 601 fp32
    # powers nearest the boundary log(1/255 / op), powers within 4e-3 of it,
    # and a coarse sweep to -30
    ops = np.concatenate([
        np.logspace(-7, 0, 500),
        composite.ALPHA_MIN * (1 + np.linspace(-1e-3, 1e-3, 51)),
        [0.99, 1.0]]).astype(np.float32)
    op = torch.from_numpy(ops)[:, None]
    edge = torch.log(torch.tensor(composite.ALPHA_MIN) / op.double())
    ulps = edge.float().view(torch.int32) + torch.arange(-300, 301)
    power = torch.cat([
        ulps.view(torch.float32),
        (edge + torch.linspace(-4e-3, 4e-3, 201, dtype=torch.float64)).float(),
        torch.linspace(-30.0, 0.0, 101).expand(op.shape[0], -1)], dim=1)
    skip = power < composite.skip_threshold(op)
    applied = _exact_applied(op, power)
    assert not bool((skip & applied).any())
    # not vacuous: both sides of the boundary are on the grid, and the skip
    # takes every sample further than twice its margin below it
    assert int(applied.sum()) > 100_000 and int(skip.sum()) > 50_000
    far = power.double() < edge - 2 * composite.SKIP_MARGIN
    assert bool(skip[far].all())


def test_skip_matches_the_plain_blend():
    """The same rule against composite_fwd_plain itself: one isotropic
    Gaussian per tile, one slot, scaled so that its 256 pixels' powers
    straddle the 1/255 boundary; a pixel's colour is nonzero iff the plain
    blend applied its sample."""
    rng = np.random.default_rng(4)
    nt = 512
    op = rng.uniform(0.01, 1.0, nt).astype(np.float32)
    off = rng.uniform(0.0, 1.0, nt)
    r2_mid = 2 * 7.5 ** 2
    conic = (-2 * np.log(composite.ALPHA_MIN / op) / r2_mid
             * (1 + rng.uniform(-0.05, 0.05, nt)))
    tiles_x = 32
    x0 = (np.arange(nt) % tiles_x) * 16.0 - off
    y0 = (np.arange(nt) // tiles_x) * 16.0 - off
    pack = np.stack([x0, y0, conic, np.zeros(nt), conic, np.ones(nt),
                     np.ones(nt), np.ones(nt), op], -1).astype(np.float32)
    pack_t = torch.from_numpy(pack)
    idx = torch.arange(nt, dtype=torch.int32)
    color, _, _ = composite.composite_fwd_plain(
        pack_t, idx, idx, torch.ones(nt, dtype=torch.int32), tiles_x)
    applied = color[:, 0] > 0
    px, py = composite.pixel_coords(nt, tiles_x, "cpu")
    dx, dy = px - pack_t[:, 0:1], py - pack_t[:, 1:2]
    a, c = pack_t[:, 2:3], pack_t[:, 4:5]
    power = -0.5 * (a * dx * dx + c * dy * dy) - pack_t[:, 3:4] * dx * dy
    skip = power < composite.skip_threshold(pack_t[:, 8:9])
    assert not bool((skip & applied).any())
    assert int(applied.sum()) > 10_000 and int(skip.sum()) > 10_000


def test_box_holds_every_applied_pixel():
    """Rows of random conics (sigmas 0.3-60 px, any angle, condition
    numbers past MAX_COND) and opacities, at the integer pixels within 64 px
    of their means: every pixel the exact test applies lies in the row's
    box, and the boxes are not vacuous."""
    rng = np.random.default_rng(6)
    n = 400
    sig = np.exp(rng.uniform(np.log(0.3), np.log(60.0), (2, n)))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = (c * sig[0]) ** 2 + (s * sig[1]) ** 2
    cyy = (s * sig[0]) ** 2 + (c * sig[1]) ** 2
    cxy = c * s * (sig[0] ** 2 - sig[1] ** 2)
    det = cxx * cyy - cxy * cxy
    op = np.where(rng.uniform(size=n) < 0.1, 0.0, rng.uniform(0, 1, n))
    pack = torch.from_numpy(np.stack([
        rng.uniform(0, 1, n), rng.uniform(0, 1, n), cyy / det, -cxy / det,
        cxx / det, *np.ones((3, n)), op], -1).astype(np.float32))
    box = composite.pixel_box(pack)
    grid = torch.arange(-64.0, 65.0)
    px = grid[None, :, None].expand(n, -1, grid.numel())
    py = grid[None, None, :].expand(n, grid.numel(), -1)
    r = pack[:, :, None, None]
    dx, dy = px - r[:, 0], py - r[:, 1]
    power = (-0.5 * (r[:, 2] * dx * dx + r[:, 4] * dy * dy)
             - r[:, 3] * dx * dy)
    applied = _exact_applied(r[:, 8], power)
    b = box[:, :, None, None]
    inside = ((px >= b[:, 0]) & (px <= b[:, 1]) & (py >= b[:, 2])
              & (py <= b[:, 3]))
    assert not bool((applied & ~inside).any())
    assert int(applied.sum()) > 100_000
    # boxes cut: most rows' boxes hold under half of the grid
    frac = inside.float().mean(dim=(1, 2))
    assert float((frac < 0.5).float().mean()) > 0.5
    assert bool(torch.isinf(box[pack[:, 8] == 0]).all())


def test_dead_row_skips_everything():
    power = torch.tensor([0.0, -0.0, -1e-30, -1e-3, -1.0, -100.0,
                          -float("inf")])
    for op in (0.0, -0.0, -0.5):
        thr = composite.skip_threshold(torch.tensor([op]))
        assert bool(torch.isinf(thr).all()) and bool((thr > 0).all())
        assert bool((power < thr).all())


def test_mirror_constants_are_the_kernels():
    text = HEADER.read_text()

    def const(name):
        m = re.search(rf"constexpr float {name} = ([^;]+);", text)
        assert m, name
        num, *den = (float(x.strip().rstrip("f")) for x in
                     m.group(1).split("/"))      # a literal or 1.0f / 255.0f
        return np.float32(num / den[0] if den else num)

    assert const("kSkipMargin") == np.float32(composite.SKIP_MARGIN)
    assert const("kAlphaMin") == np.float32(composite.ALPHA_MIN)
    assert const("kAlphaMax") == np.float32(composite.ALPHA_MAX)
    assert const("kMaxCond") == np.float32(composite.MAX_COND)
    for kernel in ("composite_fwd.cu", "composite_bwd.cu"):
        src = (HEADER.parent / kernel).read_text()
        assert '#include "blend_math.cuh"' in src


def test_library_hash_covers_the_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    assert _build.library_path("k") not in (first, second)
