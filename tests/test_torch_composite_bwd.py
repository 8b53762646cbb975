"""The port's blend backward and gradient reduction vs the JAX package's.

- ``composite_bwd_plain`` followed by ``pack_gradient`` (the Gaussian-major
  reorder and ``sorted_segment_sum``) against the Pallas backward
  ``_composite_bwd`` in interpret mode, its per-slot gradients reduced per
  Gaussian by the gather's scatter-add VJP. Tolerance rtol 2e-3 / atol 2e-5,
  the JAX package's own Pallas-vs-XLA gate (tests/test_pallas_composite.py).
- The Pallas kernels on other grid layouts compute the same functions: the
  explicit-tile-id pair ``composite_tiles_tid`` (``_fwd_kernel_tid`` /
  ``_bwd_kernel_tid``) and the one-step-per-tile-block pair selected by
  ``FUSED_CHUNKS`` (``_fwd_kernel_fused`` / ``_bwd_kernel_fused``), each
  held against the port's forward and backward.
- ``rasterize`` gradients against JAX autodiff through the XLA composite,
  ~1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops import pallas_composite as pc
from pcp_tpu.ops import projection as jproj
from pcp_tpu.ops.rasterize import rasterize as jrasterize
from pcp_tpu_torch.ops import composite as tcomp
from pcp_tpu_torch.ops import projection as tproj
from pcp_tpu_torch.ops.binning import bin_gaussians, tile_table
from pcp_tpu_torch.ops.rasterize import pack_gradient
from pcp_tpu_torch.ops.rasterize import rasterize as trasterize
from tests.test_torch_composite import _port_inputs, _table

RTOL, ATOL = 2e-3, 2e-5        # the JAX package's Pallas-vs-XLA gate
TOL_FWD = 3e-5                 # as tests/test_torch_composite.py


@pytest.fixture
def interpret():
    pc.INTERPRET = True
    yield
    pc.INTERPRET = False


def _splats(seed, tiles_x, tiles_y, n, opacity_hi):
    """``n`` seeded Gaussians over a tiles_x x tiles_y grid, binned by the
    port: rows (N, 9), bins, and each Gaussian spans up to a few tiles."""
    rng = np.random.default_rng(seed)
    w, h = 16 * tiles_x, 16 * tiles_y
    sig = rng.uniform(1.5, 8.0, (2, n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = (c * sig[0]) ** 2 + (s * sig[1]) ** 2
    cyy = (s * sig[0]) ** 2 + (c * sig[1]) ** 2
    cxy = c * s * (sig[0] ** 2 - sig[1] ** 2)
    det = cxx * cyy - cxy * cxy
    mx = rng.uniform(-4, w + 4, n)
    my = rng.uniform(-4, h + 4, n)
    pack = np.stack([mx, my, cyy / det, -cxy / det, cxx / det,
                     *rng.uniform(0, 1, (3, n)),
                     rng.uniform(0.02, opacity_hi, n)], -1).astype(np.float32)
    r = 3.0 * np.sqrt(np.maximum(cxx, cyy))
    rect = np.stack([np.floor((mx - r) / 16), np.floor((my - r) / 16),
                     np.floor((mx + r) / 16) + 1, np.floor((my + r) / 16) + 1],
                    -1)
    rect = np.clip(rect, 0, [tiles_x, tiles_y, tiles_x, tiles_y])
    bins = bin_gaussians(torch.from_numpy(rect.astype(np.int32)),
                         torch.from_numpy(rng.uniform(1, 9, n).astype(
                             np.float32)), tiles_x, tiles_y, 10_000)
    return torch.from_numpy(pack), bins


def _cotangents(seed, nt):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nt, 3, 256)).astype(np.float32),
            rng.normal(size=(nt, 256)).astype(np.float32))


def _jax_table(pack, bins, k):
    """(9, nt, k) Pallas attribute table of the port's bins, pads zeroed,
    and its (nt, k) gid table (pads -1)."""
    ids = tile_table(bins, k).numpy()
    att = pack.numpy().T[:, np.maximum(ids, 0)] * (ids >= 0)[None]
    return jnp.asarray(att.astype(np.float32)), ids


def _jax_fwd_bwd(att, tiles_x, gcolor, gtfin):
    color, tfin, nc = pc._fwd(att, tiles_x)
    (datt,) = pc._composite_bwd(tiles_x, (att, tfin, nc),
                                (jnp.asarray(gcolor), jnp.asarray(gtfin)))
    return [np.asarray(x) for x in (color, tfin, nc, datt)]


@pytest.mark.parametrize("opacity_hi", [0.99, 0.5],
                         ids=["saturating", "translucent"])
def test_plain_bwd_and_segsum_match_pallas(interpret, opacity_hi):
    tiles_x, tiles_y, n = 4, 4, 400
    pack, bins = _splats(11, tiles_x, tiles_y, n, opacity_hi)
    k = 256
    assert 64 < int(bins.max_tile_load) <= k
    assert bins.n_pairs > 1.5 * n          # Gaussians span several tiles
    att, ids = _jax_table(pack, bins, k)
    gcolor, gtfin = _cotangents(3, tiles_x * tiles_y)
    j_color, j_tfin, j_nc, j_datt = _jax_fwd_bwd(att, tiles_x, gcolor, gtfin)
    # the gather's VJP: per-slot gradients summed per Gaussian
    live = ids >= 0
    j_dpack = np.zeros((n, 9), np.float32)
    np.add.at(j_dpack, ids[live], np.moveaxis(j_datt, 0, -1)[live])

    color, t_fin, n_contrib = tcomp.composite_fwd(
        pack, bins.gids, bins.tile_start, bins.tile_count, tiles_x)
    np.testing.assert_allclose(color.numpy(), j_color, rtol=0, atol=TOL_FWD)
    np.testing.assert_array_equal(n_contrib.numpy(), j_nc.astype(np.int32))
    rows = tcomp.composite_bwd(
        pack, bins.gids, bins.tile_start, bins.tile_count, tiles_x, t_fin,
        n_contrib, torch.from_numpy(gcolor), torch.from_numpy(gtfin))
    assert rows.shape == (bins.n_pairs, 9)
    # per slot, before the reduction
    np.testing.assert_allclose(
        rows.numpy(), np.moveaxis(j_datt, 0, -1)[live], rtol=RTOL, atol=ATOL)
    dpack = pack_gradient(rows, bins, n)
    np.testing.assert_allclose(dpack.numpy(), j_dpack, rtol=RTOL, atol=ATOL)
    assert float(np.abs(j_dpack).max()) > 1.0
    if opacity_hi > 0.9:
        assert int((t_fin < 1e-3).sum()) > 100    # pixels stopped early


def test_bwd_zero_rows_past_the_clamp():
    # Slots past max_per_tile are not composited: their rows are zero, and
    # the rows that are composited equal those of the clamped list alone.
    tiles_x, tiles_y = 2, 2
    pack, bins = _splats(5, tiles_x, tiles_y, 120, 0.6)
    clamp = 20
    assert int(bins.max_tile_load) > clamp
    clamped = bins._replace(tile_count=torch.clamp_max(bins.tile_count,
                                                       clamp))
    gcolor, gtfin = (torch.from_numpy(a) for a in _cotangents(4, 4))
    args = (pack, clamped.gids, clamped.tile_start, clamped.tile_count,
            tiles_x)
    color, t_fin, nc = tcomp.composite_fwd(*args)
    rows = tcomp.composite_bwd(*args, t_fin, nc, gcolor, gtfin)
    slot = torch.arange(bins.n_pairs) - torch.repeat_interleave(
        bins.tile_start.long(), (bins.tile_start.diff(append=torch.tensor(
            [bins.n_pairs], dtype=torch.int32))).long())
    past = slot >= clamp
    assert int(past.sum()) > 0
    assert (rows[past] == 0).all()
    assert float(rows[~past].abs().max()) > 0


def test_tid_kernels_match_the_port(interpret):
    # composite_tiles_tid: the same blend with an explicit tile id per
    # table row; one TB block of 8 rows mapped to tiles of a 4x4 grid.
    tiles_x, tiles_y, k = 4, 4, 256
    att, counts = _table(21, tiles_x, 2, k, 0.99)        # 8 rows
    tids = np.random.default_rng(2).permutation(tiles_x * tiles_y)[:pc.TB]
    # rows were drawn for tiles 0..7: move each to its tile id's frame
    for r, t in enumerate(tids):
        att[0, r] += (t % tiles_x - r % tiles_x) * 16.0
        att[1, r] += (t // tiles_x - r // tiles_x) * 16.0
    att = att * (np.arange(k)[None, None, :] < counts[None, :, None])
    gcolor, gtfin = _cotangents(6, pc.TB)
    tid_col = jnp.asarray(tids.astype(np.int32)[:, None])
    (j_color, j_tfin), vjp = jax.vjp(
        lambda a: pc.composite_tiles_tid(a, tid_col, tiles_x),
        jnp.asarray(att))
    (j_datt,) = vjp((jnp.asarray(gcolor), jnp.asarray(gtfin)))

    # the port: the same rows as pairs of the full grid's tile ranges
    pack, gids, start8, count8 = _port_inputs(att, counts, 9)
    nt = tiles_x * tiles_y
    start = torch.zeros(nt, dtype=torch.int32)
    count = torch.zeros(nt, dtype=torch.int32)
    start[tids], count[tids] = start8, count8
    color, t_fin, nc = tcomp.composite_fwd(pack, gids, start, count, tiles_x)
    np.testing.assert_allclose(color[tids].numpy(), np.asarray(j_color),
                               rtol=0, atol=TOL_FWD)
    np.testing.assert_allclose(t_fin[tids].numpy(), np.asarray(j_tfin),
                               rtol=0, atol=TOL_FWD)
    g_full = np.zeros((nt, 3, 256), np.float32)
    t_full = np.zeros((nt, 256), np.float32)
    g_full[tids], t_full[tids] = gcolor, gtfin
    rows = tcomp.composite_bwd(pack, gids, start, count, tiles_x, t_fin, nc,
                               torch.from_numpy(g_full),
                               torch.from_numpy(t_full))
    # one pair per table slot, pads included (their rows are zero)
    np.testing.assert_allclose(
        rows.numpy(), np.moveaxis(np.asarray(j_datt), 0, -1).reshape(-1, 9),
        rtol=RTOL, atol=ATOL)
    assert int((t_fin[tids] < 1e-3).sum()) > 100


def test_fused_kernels_match_the_port(interpret, monkeypatch):
    # FUSED_CHUNKS: one grid step per tile block, the chunk loop inside.
    monkeypatch.setattr(pc, "FUSED_CHUNKS", True)
    tiles_x, k = 4, 256
    att, counts = _table(31, tiles_x, 2, k, 0.99)
    gcolor, gtfin = _cotangents(8, 8)
    j_color, j_tfin, j_nc, j_datt = _jax_fwd_bwd(jnp.asarray(att), tiles_x,
                                                 gcolor, gtfin)
    args = _port_inputs(att, counts, 10)
    color, t_fin, nc = tcomp.composite_fwd(*args, tiles_x)
    np.testing.assert_allclose(color.numpy(), j_color, rtol=0, atol=TOL_FWD)
    np.testing.assert_allclose(t_fin.numpy(), j_tfin, rtol=0, atol=TOL_FWD)
    np.testing.assert_array_equal(nc.numpy(), j_nc.astype(np.int32))
    rows = tcomp.composite_bwd(*args, tiles_x, t_fin, nc,
                               torch.from_numpy(gcolor),
                               torch.from_numpy(gtfin))
    np.testing.assert_allclose(
        rows.numpy(), np.moveaxis(j_datt, 0, -1).reshape(-1, 9), rtol=RTOL,
        atol=ATOL)


W, H = 64, 48
BG = np.float32([0.1, 0.2, 0.3])


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("deg", [0, 3])
def test_rasterize_grads_match_jax_autodiff(deg):
    rng = np.random.default_rng(40 + deg)
    n = 150
    s = dict(
        xyz=np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(2, 6, n)], -1).astype(np.float32),
        scales=rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.3, 0.95, n).astype(np.float32),
        sh=rng.uniform(-0.3, 0.8, (n, (deg + 1) ** 2, 3)).astype(np.float32),
        offset=np.zeros((n, 2), np.float32),
    )
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    f = (40.0, 40.0, W / 2, H / 2)
    keys = ("xyz", "scales", "quats", "opacities", "sh", "offset")

    def j_loss(*a):
        img, aux = jrasterize(
            *a[:5], jnp.eye(4), jproj.CameraIntrin(*(jnp.float32(v)
                                                     for v in f)),
            (W, H), jnp.asarray(BG), deg, max_per_tile=128,
            max_pairs=1 << 14, use_pallas=False, means2d_offset=a[5])
        return (jnp.mean((img - gt) ** 2)
                + 0.1 * jnp.mean(aux["final_t"]))

    j_grads = jax.grad(j_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(s[k]) for k in keys))

    t_in = [torch.tensor(s[k], requires_grad=True) for k in keys]
    img, aux = trasterize(
        *t_in[:5], torch.eye(4), tproj.CameraIntrin(*(torch.tensor(v)
                                                      for v in f)),
        (W, H), BG, deg, max_per_tile=128, means2d_offset=t_in[5],
        device="cpu")
    loss = (torch.mean((img - torch.from_numpy(gt)) ** 2)
            + 0.1 * torch.mean(aux["final_t"]))
    loss.backward()
    for name, t, g in zip(keys, t_in, j_grads):
        g = np.asarray(g)
        assert np.abs(g).max() > 0, name
        assert _rel(t.grad.numpy(), g) < 1e-4, (name, _rel(t.grad.numpy(), g))
