"""The port's per-Gaussian segment sum vs the JAX package's Pallas kernel.

``sorted_segment_sum_plain`` (what the wrapper runs for CPU tensors) is held
against ``segsum_pallas.sorted_segment_sum(..., mode="f32",
interpret=True)``, the TPU kernel with full-precision operands, on random
segments, a skewed segment spanning many of the kernel's chunks, and pad
rows with gid >= n. The backward's folded form, ``gathered_segment_sum``,
takes the rows in pair-list order with the binning's sort permutation and
is held to the same kernel on the rows put in Gaussian-major order, on the
real bins of a small scene and on a skewed segment under a seeded
permutation. Tolerance
1e-5: both sum the same fp32 values, in other orders (the port in fp64,
rounded once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops.segsum_pallas import sorted_segment_sum as j_segsum
from pcp_tpu_torch.ops.binning import bin_gaussians, gaussian_major
from pcp_tpu_torch.ops.projection import CameraIntrin, preprocess
from pcp_tpu_torch.ops.segsum import (
    gathered_segment_sum,
    segment_offsets,
    sorted_segment_sum,
    sorted_segment_sum_plain,
)

TOL = 1e-5


def _both(gs, gid, n):
    """(port (n, 9), JAX (n, 9)) for rows gs (M, 9) and sorted gids."""
    j = np.asarray(j_segsum(jnp.asarray(gs.T), jnp.asarray(gid), n, gb=128,
                            chunk=256, mode="f32", interpret=True)).T
    t = sorted_segment_sum(torch.from_numpy(gs), torch.from_numpy(gid), n)
    return t.numpy(), j


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("case", ["random", "skewed", "pads"])
def test_plain_matches_pallas(case):
    rng = np.random.default_rng({"random": 0, "skewed": 1, "pads": 2}[case])
    n = 512
    if case == "random":
        gid = np.sort(rng.integers(0, n, 3000))
    elif case == "skewed":
        # one Gaussian owns most rows: many chunks of one kernel block
        gid = np.concatenate([np.full(2500, 7),
                              np.sort(rng.integers(8, n, 400))])
    else:
        # empty blocks, then pad rows (gid >= n) with nonzero values
        gid = np.concatenate([np.sort(rng.integers(0, 128, 500)),
                              np.full(80, n), np.full(20, n + 3)])
    gid = gid.astype(np.int32)
    gs = rng.normal(size=(gid.shape[0], 9)).astype(np.float32)
    t, j = _both(gs, gid, n)
    assert t.shape == (n, 9)
    assert _rel(t, j) < TOL
    if case == "pads":
        assert np.abs(t[128:]).max() == 0.0
    if case == "skewed":
        # fp32 rounding of a 2500-term sum: ~1e-6 of the sum of |terms|
        np.testing.assert_allclose(
            t[7], gs[:2500].sum(0, dtype=np.float64), rtol=0,
            atol=1e-6 * np.abs(gs[:2500]).sum(0).max())


def test_sums_in_row_order():
    # the CPU version adds rows in order, as the kernel does: each output is
    # the sequential fp64 sum of its segment, rounded once to fp32
    rng = np.random.default_rng(5)
    gid = np.sort(rng.integers(0, 16, 200)).astype(np.int32)
    gs = rng.normal(size=(200, 9)).astype(np.float32)
    out = sorted_segment_sum(torch.from_numpy(gs), torch.from_numpy(gid), 16)
    assert out.dtype == torch.float32
    for g in range(16):
        acc = np.zeros(9, np.float64)
        for row in gs[gid == g]:
            acc = acc + row.astype(np.float64)
        np.testing.assert_array_equal(out[g].numpy(), acc.astype(np.float32))


def test_fp64_witness_sums_in_float64():
    # the witness is the float64 sum of the fp32 rows, rows with gid >= n
    # left out; the fp32 result is that sum rounded once: within half an
    # ulp of it, where a sequential fp32 sum of a 3000-row segment drifts
    # by many
    rng = np.random.default_rng(9)
    gid = np.concatenate([np.full(3000, 3), np.sort(rng.integers(4, 40, 500)),
                          np.full(7, 40)]).astype(np.int32)
    gs = (rng.normal(size=(gid.shape[0], 9))
          * rng.uniform(1e-3, 1e3, (gid.shape[0], 1))).astype(np.float32)
    t_gs, t_gid = torch.from_numpy(gs), torch.from_numpy(gid)
    w = sorted_segment_sum_plain(t_gs, t_gid, 40, fp64=True)
    assert w.dtype == torch.float64 and w.shape == (40, 9)
    ref = np.zeros((40, 9))
    np.add.at(ref, gid[gid < 40], gs[gid < 40].astype(np.float64))
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-12, atol=1e-9)
    f32 = sorted_segment_sum_plain(t_gs, t_gid, 40)
    assert f32.dtype == torch.float32
    assert torch.equal(f32, w.float())
    scale = sorted_segment_sum_plain(t_gs.abs(), t_gid, 40, fp64=True)
    rel = ((f32.double() - w).abs() / scale.clamp_min(1e-30)).max()
    assert rel <= 2.0 ** -24
    seq = np.cumsum(gs[:3000], axis=0, dtype=np.float32)[-1]
    assert np.abs(seq - ref[3]).max() > 10 * np.abs(f32[3].numpy()
                                                     - ref[3]).max()


def test_wrapper_checks_its_inputs():
    gs = torch.zeros((5, 9))
    gid = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        sorted_segment_sum(gs, gid.long(), 4)
    with pytest.raises(ValueError):
        sorted_segment_sum(torch.zeros((5, 8)), gid, 4)
    with pytest.raises(ValueError):
        sorted_segment_sum(gs, gid[:4], 4)
    offsets = segment_offsets(gid, 4)
    with pytest.raises(TypeError):
        sorted_segment_sum(gs, gid, 4, offsets.long())
    with pytest.raises(ValueError):
        sorted_segment_sum(gs, gid, 4, offsets[:4])


def test_segment_offsets_bound_each_gid():
    # pads (gid >= n) lie past offsets[n]; empty segments have lo == hi
    gid = torch.tensor([0, 0, 2, 2, 2, 5, 6, 9], dtype=torch.int32)
    assert segment_offsets(gid, 6).tolist() == [0, 2, 2, 5, 5, 5, 6]
    assert segment_offsets(gid[:0], 3).tolist() == [0, 0, 0, 0]


def test_bins_keep_the_offsets_of_their_pair_gids():
    # the backward hands TileBins.offsets to the kernel in place of a search
    rng = np.random.default_rng(4)
    n, tiles_x, tiles_y = 300, 9, 7
    x0 = rng.integers(0, tiles_x, n)
    y0 = rng.integers(0, tiles_y, n)
    rect = np.stack([x0, y0, np.minimum(x0 + rng.integers(0, 4, n), tiles_x),
                     np.minimum(y0 + rng.integers(0, 3, n), tiles_y)], -1)
    bins = bin_gaussians(torch.tensor(rect, dtype=torch.int32),
                         torch.tensor(rng.uniform(1, 9, n)), tiles_x, tiles_y,
                         64)
    assert bins.offsets.dtype == torch.int32
    assert torch.equal(bins.offsets, segment_offsets(bins.pair_gid, n))
    counts = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    assert bins.offsets.diff().tolist() == counts.tolist()


def _scene_bins(seed=6, n=384, w=96, h=64):
    """The real ``bin_gaussians`` output of a small seeded scene, through
    the port's preprocess."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 9, n)], -1)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    prep = preprocess(
        t(xyz), t(rng.uniform(0.05, 0.4, (n, 3))), t(rng.normal(size=(n, 4))),
        t(rng.uniform(0.1, 0.9, n)), t(rng.normal(0, 0.3, (n, 16, 3))),
        torch.eye(4), CameraIntrin(*(torch.tensor(v) for v in
                                     (80.0, 80.0, w / 2, h / 2))),
        (w, h), 3)
    return bin_gaussians(prep["rect"], prep["depths"], (w + 15) // 16,
                         (h + 15) // 16, 256), n


def _gathered_case(case):
    """(pair-order rows, order, offsets, n, Gaussian-major rows, gids)."""
    if case == "bins":
        bins, n = _scene_bins()
        rng = np.random.default_rng(8)
        rows = torch.from_numpy(
            rng.normal(size=(bins.n_pairs, 9)).astype(np.float32))
        return (rows, bins.order, bins.offsets, n,
                gaussian_major(rows, bins.order), bins.pair_gid)
    # one Gaussian owns most rows, and the pair order is a seeded shuffle:
    # pair row i belongs at Gaussian-major position order[i]
    rng = np.random.default_rng(9)
    n = 256
    gid = np.concatenate([np.full(2000, 5), np.sort(
        rng.integers(6, n, 500))]).astype(np.int32)
    order = rng.permutation(gid.shape[0])
    pair_rows = rng.normal(size=(gid.shape[0], 9)).astype(np.float32)
    ordered = np.empty_like(pair_rows)
    ordered[order] = pair_rows
    gid_t = torch.from_numpy(gid)
    return (torch.from_numpy(pair_rows), torch.from_numpy(order),
            segment_offsets(gid_t, n), n, torch.from_numpy(ordered), gid_t)


@pytest.mark.parametrize("case", ["bins", "skewed"])
def test_gathered_matches_pallas(case):
    rows, order, offsets, n, ordered, gid = _gathered_case(case)
    assert rows.shape[0] > 1000 and (offsets.diff() > 0).sum() > 100
    t = gathered_segment_sum(rows, order, offsets, n).numpy()
    j = np.asarray(j_segsum(jnp.asarray(ordered.numpy().T),
                            jnp.asarray(gid.numpy()), n, gb=128, chunk=256,
                            mode="f32", interpret=True)).T
    assert t.shape == (n, 9)
    assert _rel(t, j) < TOL


@pytest.mark.parametrize("case", ["bins", "skewed"])
def test_gathered_is_the_unfolded_stage(case):
    # the plain twin of the folded form: the Gaussian-major copy, then the
    # sequential sum; the same bits
    rows, order, offsets, n, ordered, gid = _gathered_case(case)
    assert torch.equal(rows, ordered[order])
    assert torch.equal(gathered_segment_sum(rows, order, offsets, n),
                       sorted_segment_sum_plain(ordered, gid, n))


def test_gathered_never_reads_positions_past_the_last_segment():
    rng = np.random.default_rng(10)
    gid = torch.tensor(np.sort(rng.integers(0, 50, 400)).astype(np.int32))
    offsets = segment_offsets(gid, 50)
    order = torch.from_numpy(rng.permutation(500))
    rows = torch.from_numpy(rng.normal(size=(500, 9)).astype(np.float32))
    rows[order >= 400] = float("nan")        # positions >= offsets[n]
    out = gathered_segment_sum(rows, order, offsets, 50)
    assert torch.isfinite(out).all()
    ordered = torch.empty_like(rows)
    ordered[order] = rows
    assert torch.equal(out, sorted_segment_sum_plain(ordered[:400], gid, 50))


def test_gathered_wrapper_checks_its_inputs():
    rows = torch.zeros((5, 9))
    order = torch.arange(5)
    offsets = torch.tensor([0, 2, 5], dtype=torch.int32)
    assert gathered_segment_sum(rows, order, offsets, 2).shape == (2, 9)
    with pytest.raises(TypeError):
        gathered_segment_sum(rows, order.int(), offsets, 2)
    with pytest.raises(TypeError):
        gathered_segment_sum(rows.double(), order, offsets, 2)
    with pytest.raises(ValueError):
        gathered_segment_sum(torch.zeros((5, 8)), order, offsets, 2)
    with pytest.raises(ValueError):
        gathered_segment_sum(rows, order[:4], offsets, 2)
    with pytest.raises(ValueError):
        gathered_segment_sum(rows, order, offsets, 3)
    with pytest.raises(TypeError):
        gathered_segment_sum(rows, order, offsets.long(), 2)
