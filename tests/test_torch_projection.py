"""Port vs JAX package: spherical harmonics, quaternions, covariances, RNG
seeding and preprocess.

Inputs come from numpy seeds and go through ``pcp_tpu`` (JAX on the CPU)
and ``pcp_tpu_torch`` (torch on the CPU) unchanged.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.ops import projection as jproj
from pcp_tpu.utils import general as jgen
from pcp_tpu.utils import sh as jsh
from pcp_tpu_torch.ops import projection as tproj
from pcp_tpu_torch.utils import general as tgen
from pcp_tpu_torch.utils import sh as tsh


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_color_matches(deg):
    # 1e-6: the same fp32 expression in the same term order; only the last
    # bits of the polynomial may round differently.
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(500, 16, 3)).astype(np.float32) * 0.5
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(d)))
    out = tsh.eval_sh_color(deg, torch.from_numpy(sh), torch.from_numpy(d))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert tsh.num_sh_bases(deg) == jsh.num_sh_bases(deg)


def test_quat_to_rotmat_matches():
    # 1e-6: normalise + 9 products per matrix in fp32.
    q = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    ref = np.asarray(jgen.quat_to_rotmat(jnp.asarray(q)))
    out = tgen.quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    x = np.float32([0.1, 0.5, 0.9])
    np.testing.assert_allclose(
        tgen.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jgen.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)


def test_sh_to_rgb_and_covariance_helpers_match():
    # 1e-6: the same few fp32 products and sums; sh_to_rgb inverts
    # rgb_to_sh to the same rounding in both packages.
    rng = np.random.default_rng(2)
    sh = rng.normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsh.sh_to_rgb(torch.from_numpy(sh)).numpy(),
        np.asarray(jsh.sh_to_rgb(jnp.asarray(sh))), rtol=0, atol=1e-6)
    s = rng.uniform(0.01, 2.0, (200, 3)).astype(np.float32)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    js, jq = jnp.asarray(s), jnp.asarray(q)
    ts, tq = torch.from_numpy(s), torch.from_numpy(q)
    L = tgen.build_scaling_rotation(ts, tq)
    np.testing.assert_allclose(
        L.numpy(), np.asarray(jgen.build_scaling_rotation(js, jq)),
        rtol=0, atol=1e-6)
    cov = tgen.covariance_from_scaling_rotation(ts, tq)
    j_cov = np.asarray(jgen.covariance_from_scaling_rotation(js, jq))
    np.testing.assert_allclose(cov.numpy(), j_cov, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tgen.strip_symmetric(cov).numpy(),
        np.asarray(jgen.strip_symmetric(jnp.asarray(j_cov))),
        rtol=1e-5, atol=1e-6)
    assert tgen.strip_symmetric(cov).shape == (200, 6)


def test_safe_state_seeds_python_and_numpy_as_jax():
    draws = []
    for seed_fn in (jgen.safe_state, tgen.safe_state):
        seed_fn(7)
        draws.append((random.random(), np.random.random()))
    assert draws[0] == draws[1]
    t_before = torch.random.get_rng_state()
    tgen.safe_state(8)
    assert torch.equal(torch.random.get_rng_state(), t_before)


def _scene(rng, n, deg):
    k = (deg + 1) ** 2
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(-1, 8, n)], -1).astype(np.float32)
    return dict(
        xyz=xyz,
        scales=rng.uniform(0.02, 0.4, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.001, 0.99, n).astype(np.float32),
        sh=rng.normal(size=(n, k, 3)).astype(np.float32) * 0.4,
    )


def _viewmat(rng):
    a = rng.uniform(-0.3, 0.3, 3)
    cx, cy, cz = np.cos(a)
    sx, sy, sz = np.sin(a)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    vm = np.eye(4)
    vm[:3, :3] = rz @ ry @ rx
    vm[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return vm.astype(np.float32)


CASES = {
    "deg0": dict(deg=0, size=(64, 48), tan_fov=None, offset=False),
    "deg3": dict(deg=3, size=(96, 64), tan_fov=None, offset=False),
    "deg3_tanfov_offset": dict(deg=3, size=(80, 80), tan_fov=(0.7, 0.6),
                               offset=True),
    "deg2_odd_size": dict(deg=2, size=(70, 45), tan_fov=None, offset=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_matches_every_key(case):
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    n = 400
    s = _scene(rng, n, c["deg"])
    vm = _viewmat(rng)
    w, h = c["size"]
    f = (0.8 * w, 0.9 * w, w / 2, h / 2)
    off = rng.normal(size=(n, 2)).astype(np.float32) if c["offset"] else None

    ref = jproj.preprocess(
        *(jnp.asarray(s[k]) for k in ("xyz", "scales", "quats", "opacities",
                                      "sh")),
        jnp.asarray(vm), jproj.CameraIntrin(*(jnp.float32(v) for v in f)),
        (w, h), c["deg"], tan_fov=c["tan_fov"],
        means2d_offset=None if off is None else jnp.asarray(off))
    out = tproj.preprocess(
        *(torch.from_numpy(s[k]) for k in ("xyz", "scales", "quats",
                                           "opacities", "sh")),
        torch.from_numpy(vm),
        tproj.CameraIntrin(*(torch.tensor(v, dtype=torch.float32)
                             for v in f)),
        (w, h), c["deg"], tan_fov=c["tan_fov"],
        means2d_offset=None if off is None else torch.from_numpy(off))

    assert set(out) == set(ref)
    assert out["visible"].dtype == torch.bool
    assert out["rect"].dtype == torch.int32
    np.testing.assert_array_equal(out["visible"].numpy(),
                                  np.asarray(ref["visible"]))
    np.testing.assert_array_equal(out["rect"].numpy(), np.asarray(ref["rect"]))
    assert 0 < int(out["visible"].sum()) < n  # both culled and kept cases
    for k in ("means2d", "depths", "conics", "radii", "rgb", "opacity"):
        r = np.asarray(ref[k])
        # 1e-5 relative to the array's scale: the same fp32 expressions in
        # the same order; libm rounding (exp, log, sqrt) differs in the
        # last bits.
        np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(r).max()),
                                   err_msg=k)
