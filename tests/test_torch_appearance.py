"""The port's appearance network vs the JAX package's Flax one.

Flax parameters drawn by ``init_appearance`` are carried into the port with
``appearance_from_flax`` (HWIO kernels -> OIHW); then ``decouple_appearance``
must give the same decoupled image and map (1e-5 abs: fp32 convolutions
summed in another order) and the same gradients with respect to the image,
the embeddings and every kernel and bias (1e-4 relative). The JAX package
computes in fp32 off the TPU, as the port always does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcp_tpu.models import appearance as japp
from pcp_tpu_torch.models import appearance as tapp


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.fixture(scope="module")
def flax_app():
    return jax.tree_util.tree_map(
        np.asarray, japp.init_appearance(jax.random.PRNGKey(3), (64, 48),
                                         num_embeddings=16))


@pytest.mark.parametrize("w,h", [(64, 48), (70, 45)])
def test_decouple_matches_flax(flax_app, w, h):
    rng = np.random.default_rng(w)
    image = rng.uniform(size=(h, w, 3)).astype(np.float32)
    target = rng.uniform(size=(h, w, 3)).astype(np.float32)
    view = 5

    def j_loss(img, app):
        out, mapping = japp.decouple_appearance(img, app, view)
        return jnp.mean((out - target) ** 2) + 0.1 * jnp.mean(mapping)

    j_app = jax.tree_util.tree_map(jnp.asarray, flax_app)
    j_out, j_map = japp.decouple_appearance(jnp.asarray(image), j_app, view)
    j_gimg, j_gapp = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(image),
                                                      j_app)

    app = tapp.appearance_from_flax(flax_app, "cpu")
    app["embeddings"].requires_grad_(True)
    img = torch.tensor(image, requires_grad=True)
    out, mapping = tapp.decouple_appearance(img, app, view)
    assert out.shape == mapping.shape == (h, w, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(mapping.detach().numpy(), np.asarray(j_map),
                               rtol=0, atol=1e-5)
    loss = (torch.mean((out - torch.from_numpy(target)) ** 2)
            + 0.1 * torch.mean(mapping))
    loss.backward()
    assert _rel(img.grad.numpy(), j_gimg) < 1e-4
    assert _rel(app["embeddings"].grad.numpy(), j_gapp["embeddings"]) < 1e-4
    j_net = tapp.net_tensors_from_flax(
        jax.tree_util.tree_map(np.asarray, j_gapp["net"]), "cpu")
    for p, g in zip(app["net"].parameters(), j_net):
        assert np.abs(g.numpy()).max() > 0
        assert _rel(p.grad.numpy(), g.numpy()) < 1e-4


def test_flax_tree_maps_onto_the_module(flax_app):
    paths = [p for p, _ in tapp.flax_leaves(flax_app["net"])]
    n_flax = len(jax.tree_util.tree_leaves(flax_app["net"]))
    net = tapp.AppearanceNetwork()
    assert len(paths) == n_flax == len(list(net.parameters())) == 14
    for p, t in zip(net.parameters(),
                    tapp.net_tensors_from_flax(flax_app["net"], "cpu")):
        assert p.shape == t.shape


def test_port_init_draws_like_flax(flax_app):
    app = tapp.init_appearance(torch.Generator().manual_seed(0), "cpu")
    assert app["embeddings"].shape == (tapp.NUM_EMBEDDINGS, tapp.EMBED_DIM)
    assert abs(float(app["embeddings"].std()) - 0.01) < 5e-4
    flax = tapp.net_tensors_from_flax(flax_app["net"], "cpu")
    for p, f in zip(app["net"].parameters(), flax):
        if p.dim() == 1:
            assert (p == 0).all() and (f == 0).all()
        else:
            # lecun normal: std 1/sqrt(fan_in), truncated at 2 sigma
            fan_in = p.shape[1] * 9
            assert abs(float(p.detach().std()) * fan_in ** 0.5 - 1.0) < 0.1
            bound = 2.0 * fan_in ** -0.5 / 0.8796
            assert float(p.detach().abs().max()) <= bound + 1e-6
