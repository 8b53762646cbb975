"""The port's attribute gather (B6: ``tools/exp_r2.py`` ``exp_gather``) and
its experiment tool, on the CPU.

The JAX tool's Pallas bodies are closures inside ``exp_gather`` and cannot
be imported, so the plain version is held to the tool's own spot check,
numpy's ``pack[ids].transpose(0, 2, 1)``, exactly: a gather does no
arithmetic. The CUDA kernel is held to the plain version bit for bit on the
card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from pcp_tpu_torch.ops import composite
from pcp_tpu_torch.ops.gather import LAYOUTS, gather_pack, gather_pack_plain
from pcp_tpu_torch.tools import exp_r2


def _inputs(seed, n=300, na=16, nt=7, k=40):
    rng = np.random.default_rng(seed)
    pack = rng.standard_normal((n, na)).astype(np.float32)
    ids = rng.integers(0, n, (nt, k)).astype(np.int32)
    return pack, ids


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("na", [16, 12])
def test_gather_matches_numpy(layout, na):
    pack, ids = _inputs(1, na=na)
    want = pack[ids].transpose(0, 2, 1)                  # (NT, NA, K)
    src = torch.from_numpy(pack.T.copy() if layout == "plane" else pack)
    ids_t = torch.from_numpy(ids)
    before = dict(composite.LAUNCHES)
    got = gather_pack(src, ids_t, layout)
    assert got.shape == (7, na, 40) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather_pack_plain(src, ids_t, layout).numpy(), want)
    assert dict(composite.LAUNCHES) == before     # the CPU runs no kernel


def test_gather_rejects_bad_inputs():
    pack, ids = _inputs(2)
    p, i = torch.from_numpy(pack), torch.from_numpy(ids)
    with pytest.raises(ValueError):
        gather_pack(p, i, "diagonal")
    with pytest.raises(TypeError):
        gather_pack(p, i.long(), "row")
    with pytest.raises(TypeError):
        gather_pack(p.double(), i, "col")
    with pytest.raises(ValueError):
        gather_pack(p[:, :6].contiguous(), i, "row")  # NA not a multiple of 4
    with pytest.raises(ValueError):
        gather_pack(p.T, i, "plane")                     # not contiguous


def test_exp_r2_gather_on_the_cpu(capsys):
    out = exp_r2.main(["gather", "--n", "512", "--nt", "8", "--k", "64",
                       "--reps", "2", "--seed", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    for name, _ in exp_r2.FORMS:
        assert f"{name}: ok=True" in text
        assert out["gather"]["forms"][name]["ok"]
    pack, ids = exp_r2.make_inputs(512, 16, 8, 64, 3, "cpu")
    rows = len(np.unique(ids.numpy()))
    assert out["gather"]["bytes"] == 4 * 8 * 64 * 17 + 64 * rows


def test_exp_r2_sort_and_xlagather_on_the_cpu():
    s = exp_r2.exp_sort(sizes=(1000,), reps=1, device="cpu")
    assert set(s[1000]) == {"single_ms", "payload_ms"}
    x = exp_r2.exp_xlagather(n=64, na=4, nt=3, ks=(8, 16), reps=1,
                             device="cpu")
    assert sorted(x) == [8, 16]


def test_exp_r2_needs_the_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        exp_r2.main(["gather", "--n", "64", "--nt", "2", "--k", "8"])
