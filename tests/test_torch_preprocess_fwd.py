"""The render path's preprocess from stored parameters on the CPU:
``ops/preprocess_fwd.preprocess_params``'s plain version, the rule by which
``train/step.render_gaussians`` takes it, and the wrapper's checks. The
kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py::test_preprocess_fwd_matches_plain``)."""

import pytest
import torch

from pcp_tpu_torch.ops import composite
from pcp_tpu_torch.ops.preprocess_fwd import preprocess_params
from pcp_tpu_torch.ops.projection import preprocess
from pcp_tpu_torch.tools.preprocess_inputs import (preprocess_inputs,
                                                   row_kind, view)
from pcp_tpu_torch.train import step

W, H = 75, 53          # a partial tile row and column


def _inputs(n=1500, rest=15, seed=0):
    viewmat, intrin = view(W, H, "cpu")
    params, alive = preprocess_inputs(n, rest, viewmat, intrin, W, H, seed,
                                      "cpu")
    return params, alive, viewmat, intrin


@pytest.mark.parametrize("deg,rest,kw", [
    (0, 15, {}), (1, 3, {}), (2, 15, {}), (3, 15, {}),
    (3, 15, {"scaling_modifier": 0.5}),
    (3, 15, {"tan_fov": (0.31, 0.27)})])
def test_plain_is_the_composition_bit_for_bit(deg, rest, kw):
    """The plain version is the render path's composition: activation,
    ``sh_coeffs``, ``preprocess`` and ``pack_attributes``, the same bits;
    it launches nothing."""
    params, alive, viewmat, intrin = _inputs(rest=rest, seed=deg)
    before = dict(composite.LAUNCHES)
    prep, pack = preprocess_params(params, alive, viewmat, intrin, (W, H),
                                   deg, **kw)
    assert dict(composite.LAUNCHES) == before
    opac = torch.sigmoid(params["opacity"])[:, 0] * alive.to(torch.float32)
    sh = torch.cat([params["f_dc"][:, None, :], params["f_rest"]], dim=1)
    want = preprocess(params["xyz"], torch.exp(params["scaling"])
                      * kw.get("scaling_modifier", 1.0), params["rotation"],
                      opac, sh, viewmat, intrin, (W, H), deg,
                      tan_fov=kw.get("tan_fov"))
    assert sorted(prep) == sorted(want)
    for k in want:
        assert torch.equal(prep[k].nan_to_num(), want[k].nan_to_num()), k
        assert torch.equal(prep[k].isnan(), want[k].isnan()), k
    rows = torch.cat([want["means2d"], want["conics"], want["rgb"],
                      want["opacity"][:, None]], dim=1)
    assert torch.equal(pack.nan_to_num(), rows.nan_to_num())
    kind = row_kind(params["xyz"].shape[0], "cpu")
    assert not prep["visible"][(kind == 1) | (kind == 4) | (kind == 5)].any()
    assert prep["visible"][kind == 0].any()


@pytest.mark.parametrize("kw", [{}, {"scaling_modifier": 0.7}])
def test_render_without_grad_matches_autograd(kw):
    """``render_gaussians`` under ``torch.no_grad()`` gives the image and
    aux of the autograd path bit for bit on the CPU."""
    params, alive, viewmat, intrin = _inputs(n=400, seed=11)
    bg = torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        image, aux = step.render_gaussians(params, alive, viewmat, intrin,
                                           (W, H), bg, 3, device="cpu", **kw)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    g_image, g_aux = step.render_gaussians(leaves, alive, viewmat, intrin,
                                           (W, H), bg, 3, device="cpu", **kw)
    assert g_image.requires_grad and not image.requires_grad
    assert torch.equal(image, g_image.detach())
    assert sorted(aux) == sorted(g_aux)
    for k in aux:
        assert torch.equal(torch.as_tensor(aux[k]),
                           torch.as_tensor(g_aux[k]).detach()), k
    assert float(image.std()) > 0.01


@pytest.mark.parametrize("grad_on,leaf_grad,probe,takes", [
    (True, True, False, False),     # the training step's leaves
    (True, True, True, False),      # ... with the means2d probe
    (False, False, True, False),    # a probe alone keeps autograd's path
    (False, True, False, True),     # torch.no_grad() around leaves
    (True, False, False, True),     # plain tensors, autograd on
    (False, False, False, True),    # plain tensors under no_grad
])
def test_dispatch_rule(monkeypatch, grad_on, leaf_grad, probe, takes):
    """The kernel's path is taken where no gradient can flow and no
    ``means2d_offset`` is given; otherwise autograd's path."""
    params, alive, viewmat, intrin = _inputs(n=64, seed=2)
    calls = []
    real = step.preprocess_params
    monkeypatch.setattr(step, "preprocess_params",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if leaf_grad:
        params = {k: v.requires_grad_(True) for k, v in params.items()}
    offset = torch.zeros(64, 2) if probe else None
    with torch.set_grad_enabled(grad_on):
        image, _ = step.render_gaussians(
            params, alive, viewmat, intrin, (W, H), torch.zeros(3), 3,
            means2d_offset=offset, device="cpu")
    assert len(calls) == int(takes)
    assert image.requires_grad == (grad_on and leaf_grad)


@pytest.mark.parametrize("fault,error", [
    ("xyz_f64", TypeError), ("alive_u8", TypeError),
    ("f_rest_strided", ValueError), ("rotation_shape", ValueError),
    ("rest_short", ValueError), ("viewmat_f64", TypeError)])
def test_wrapper_rejects_bad_inputs(fault, error):
    params, alive, viewmat, intrin = _inputs(n=32)
    if fault == "xyz_f64":
        params["xyz"] = params["xyz"].double()
    elif fault == "alive_u8":
        alive = alive.to(torch.uint8)
    elif fault == "f_rest_strided":
        params["f_rest"] = params["f_rest"].transpose(1, 2).contiguous() \
            .transpose(1, 2)
    elif fault == "rotation_shape":
        params["rotation"] = params["rotation"][:, :3].contiguous()
    elif fault == "rest_short":
        params["f_rest"] = params["f_rest"][:, :8].contiguous()
    elif fault == "viewmat_f64":
        viewmat = viewmat.double()
    with pytest.raises(error):
        preprocess_params(params, alive, viewmat, intrin, (W, H), 3)
