"""The port's model construction and densification vs the JAX package's.

- ``mean_sq_dist_3nn``: the same Morton-window algorithm, 1e-5 relative;
- ``create_from_pcd``: the same capacity-padded params and alive mask;
- ``densify_and_prune`` with the split noise JAX draws from its key fed to
  the port: the same alive mask and written slots, params to 1e-5, also
  on a full block (every slot live), where children are dropped;
- ``reset_opacity``: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.models import gaussians as jG
from pcp_tpu.ops import knn as jknn
from pcp_tpu.ops.knn import mean_sq_dist_3nn as j_knn
from pcp_tpu_torch.ops import knn as tknn
from pcp_tpu_torch.models import gaussians as tG
from pcp_tpu_torch.ops.knn import mean_sq_dist_3nn as t_knn


def _cloud(seed, n):
    """A clustered, surface-like cloud (the SfM case) plus uniform noise."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-5, 5, (8, 3))
    pts = centres[rng.integers(0, 8, n)] + rng.normal(0, 0.3, (n, 3))
    pts[: n // 10] = rng.uniform(-6, 6, (n // 10, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("n", [3, 600])
def test_knn_matches_jax(n):
    pts = _cloud(n, n)
    j = np.asarray(j_knn(jnp.asarray(pts)))
    t = t_knn(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,k,chunk", [(600, 5, 1 << 19), (600, 8, 128),
                                     (5, 5, 1 << 19)],
                         ids=["one_pass", "chunked", "n_le_k"])
def test_kth_nn_dist2_matches_jax(n, k, chunk):
    # The tensor form and its numpy twin against JAX's, the chunked large-N
    # path with a small ``chunk``: the same candidates and squared
    # distances, so 1e-5 relative; n <= k gives +inf everywhere.
    pts = _cloud(n + k, n)
    j = np.asarray(jknn.kth_nn_dist2(jnp.asarray(pts), k, chunk=chunk))
    t = tknn.kth_nn_dist2(torch.from_numpy(pts), k, chunk=chunk).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=0)
    j_np = jknn.kth_nn_dist2_np(pts, k, chunk=chunk // 2 or 1)
    t_np = tknn.kth_nn_dist2_np(pts, k, chunk=chunk // 2 or 1)
    np.testing.assert_array_equal(t_np, j_np)
    assert t.dtype == t_np.dtype == np.float32
    if n <= k:
        assert np.isinf(t).all() and np.isinf(t_np).all()
    else:   # a point near an end of every ordering may see < k others
        assert np.isfinite(t).mean() > 0.9


def test_create_from_pcd_matches_jax():
    pts = _cloud(1, 300)
    rgb = np.random.default_rng(2).integers(0, 256, (300, 3)).astype(
        np.float32)
    for cap in (512, 200):                       # padded, then truncated
        j_p, j_alive = jG.create_from_pcd(pts, rgb, jG.GaussianConfig(
            sh_degree=2, capacity=cap))
        t_p, t_alive = tG.create_from_pcd(pts, rgb, tG.GaussianConfig(
            sh_degree=2, capacity=cap), device="cpu")
        np.testing.assert_array_equal(t_alive.numpy(), np.asarray(j_alive))
        for k in tG.PARAM_KEYS:
            assert t_p[k].shape == j_p[k].shape, k
            np.testing.assert_allclose(t_p[k].numpy(), np.asarray(j_p[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def _state(seed, c=96, n_alive=70):
    rng = np.random.default_rng(seed)
    alive = np.arange(c) < n_alive
    params = {
        "xyz": rng.normal(size=(c, 3)),
        "f_dc": rng.normal(size=(c, 3)),
        "f_rest": rng.normal(size=(c, 3, 3)),
        "scaling": rng.uniform(-4.5, -1.5, (c, 3)),
        "rotation": rng.normal(size=(c, 4)),
        "opacity": rng.uniform(-7, 2, (c, 1)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    stats = {
        "grad_accum": rng.uniform(0, 0.002, c).astype(np.float32),
        "denom": rng.integers(0, 5, c).astype(np.float32),
        "max_radii2d": rng.uniform(0, 30, c).astype(np.float32),
    }
    return params, alive, stats


@pytest.mark.parametrize("prune_big,full", [(False, False), (True, False),
                                             (True, True)],
                         ids=["False", "True", "full"])
def test_densify_and_prune_matches_jax(prune_big, full):
    # ``full``: every slot live, as at the reference's population cap; the
    # children outnumber the free slots and those past the last are
    # dropped (the same 96 slots as the other cases: one JAX compile)
    params, alive, stats = _state(7, n_alive=96 if full else 70)
    c = alive.shape[0]
    kw = dict(grad_threshold=0.0002, min_opacity=0.005, extent=3.0,
              percent_dense=0.01, prune_big_screen=prune_big)
    key = jax.random.PRNGKey(5)
    j_p, j_alive, j_written = jG.densify_and_prune(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        {k: jnp.asarray(v) for k, v in stats.items()}, key, **kw)
    k0, k1 = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (c, 3))))
                  for k in (k0, k1))
    counts = {}
    t_p, t_alive, t_written = tG.densify_and_prune(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(alive), {k: torch.from_numpy(v)
                                  for k, v in stats.items()},
        None, noise=noise, counts=counts, **kw)
    np.testing.assert_array_equal(t_alive.numpy(), np.asarray(j_alive))
    np.testing.assert_array_equal(t_written.numpy(), np.asarray(j_written))
    for k in tG.PARAM_KEYS:
        np.testing.assert_allclose(t_p[k].numpy(), np.asarray(j_p[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the case reaches what it is meant to: clones, splits and prunes
    assert int(t_written.sum()) > 10
    if full:   # every free slot filled, children dropped
        assert bool(t_alive.all()) and int(counts["dropped"]) > 0
    else:
        assert int(t_alive.sum()) != int(alive.sum())


def test_full_capacity_drops_children():
    params, alive, stats = _state(8, c=40, n_alive=38)
    stats["grad_accum"][:] = 0.01
    stats["denom"][:] = 1.0
    kw = dict(grad_threshold=0.0002, min_opacity=0.0, extent=100.0)
    t_p, t_alive, written = tG.densify_and_prune(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(alive), {k: torch.from_numpy(v)
                                  for k, v in stats.items()},
        torch.Generator().manual_seed(0), **kw)
    assert bool(t_alive.all())            # two free slots, both filled
    assert int(written.sum()) == 2


def test_reset_opacity_matches_jax():
    params, alive, _ = _state(9)
    j = jG.reset_opacity({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(alive))
    t = tG.reset_opacity({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(alive))
    np.testing.assert_array_equal(t["opacity"].numpy(),
                                  np.asarray(j["opacity"]))
    assert float(t["opacity"][alive].max()) <= np.log(0.01 / 0.99) + 1e-6
