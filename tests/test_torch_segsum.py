"""The port's per-Gaussian segment sum vs the JAX package's Pallas kernel.

``sorted_segment_sum_plain`` (what the wrapper runs for CPU tensors) is held
against ``segsum_pallas.sorted_segment_sum(..., mode="f32",
interpret=True)``, the TPU kernel with full-precision operands, on random
segments, a skewed segment spanning many of the kernel's chunks, and pad
rows with gid >= n. Tolerance 1e-5: both sum the same fp32 values, in other
orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops.segsum_pallas import sorted_segment_sum as j_segsum
from pcp_tpu_torch.ops.binning import bin_gaussians
from pcp_tpu_torch.ops.segsum import segment_offsets, sorted_segment_sum

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
    # the sequential fp32 sum of its segment
    rng = np.random.default_rng(5)
    gid = np.sort(rng.integers(0, 16, 200)).astype(np.int32)
    gs = rng.normal(size=(200, 9)).astype(np.float32)
    out = sorted_segment_sum(torch.from_numpy(gs), torch.from_numpy(gid), 16)
    for g in range(16):
        acc = np.zeros(9, np.float32)
        for row in gs[gid == g]:
            acc = acc + row
        np.testing.assert_array_equal(out[g].numpy(), acc)


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
