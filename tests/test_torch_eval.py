"""The eval slice: the port's color correction, LPIPS, metrics, eval_views
and the metrics / full_eval CLIs against the JAX package's, on the CPU.

Inputs come from numpy seeds; LPIPS weights are a random bundle with the
AlexNet-LPIPS shapes (no pretrained weights are in the repo). Tolerances:

- color_correct: both packages solve the same fp32 normal equations, whose
  10x10 A^T A (condition ~1.6e4 here) each sums in its own order; five
  rounds of warps and clip masks carry that on. Each lands up to ~7e-4
  from a float64 run of the algorithm, ~2e-5 on average. So both are held
  to the float64 run and to each other within 1e-3 per pixel and 5e-5 on
  average, and the corrected PSNR within 1e-3 dB.
- LPIPS: 1e-5 relative. The convolutions sum in another order than XLA's.
- per view PSNR within 1e-3 dB, SSIM within 1e-5, LPIPS 1e-5 relative;
  ``renders_cc`` PNGs within 1 level of 255 (a float within 2e-5 can still
  truncate to the neighbouring integer).
- eval_views: L1 within 1e-5 and PSNR within 1e-3 dB (the renders agree to
  3e-5, ``tests/test_torch_render.py``).
"""

import functools
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcp_tpu.eval import lpips as jlpips
from pcp_tpu.eval import metrics as jmetrics
from pcp_tpu.eval.render_batch import eval_views as j_eval_views
from pcp_tpu.scene import cameras as jcams
from pcp_tpu.scene import load_colmap_scene as j_load_scene
from pcp_tpu.scene import split_train_test as j_split
from pcp_tpu.utils.image import color_correct as j_color_correct
from pcp_tpu_torch.eval import lpips as tlpips
from pcp_tpu_torch.eval import metrics as tmetrics
from pcp_tpu_torch.eval.render_batch import eval_views as t_eval_views
from pcp_tpu_torch.models.gaussians import params_from_numpy
from pcp_tpu_torch.scene import cameras as tcams
from pcp_tpu_torch.scene import load_colmap_scene as t_load_scene
from pcp_tpu_torch.scene import split_train_test as t_split
from pcp_tpu_torch.utils.image import color_correct
from tests.pth_writer import save_pth
from tests.synthetic import write_synthetic_scene

_CONVS = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3),
          (256, 256, 3)]
_CONV_IDX = [0, 3, 6, 8, 10]


def _bundle(seed):
    """Random LPIPS weights in the JAX package's layout (HWIO convs)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (ci, co, k) in enumerate(_CONVS):
        out[f"conv{i}_w"] = (rng.normal(size=(k, k, ci, co)) * 0.05).astype(
            np.float32)
        out[f"conv{i}_b"] = (rng.normal(size=co) * 0.05).astype(np.float32)
        out[f"lin{i}_w"] = np.abs(rng.normal(size=co)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    np.savez(path, **_bundle(5))
    return path


def _warped_pair(seed, h=48, w=64):
    """A smooth reference with clipped patches, and a render that is a
    quadratic color warp of it plus noise, saturated where the warp leaves
    [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    ref = np.stack([0.5 + 0.5 * np.sin(3 * xx + c) * np.cos(2 * yy - c)
                    for c in range(3)], -1)
    ref += rng.normal(0, 0.03, ref.shape)
    ref[: h // 6, : w // 5] = 1.0
    ref[-h // 6:, -w // 5:] = 0.0
    ref = np.clip(ref, 0, 1)
    m = 0.9 * np.eye(3) + rng.normal(0, 0.08, (3, 3))
    img = ref @ m + 0.25 * ref ** 2 - 0.05 + rng.normal(0, 0.01, ref.shape)
    return np.clip(img, 0, 1).astype(np.float32), ref.astype(np.float32)


def _color_correct_f64(img, ref, num_iters=5, eps=0.5 / 255):
    """The multinerf algorithm in float64 numpy (image_utils.py:26-69)."""
    im, rf = img.reshape(-1, 3).astype(np.float64), ref.reshape(-1, 3)

    def unclipped(z):
        return (z >= eps) & (z <= 1 - eps)

    mask0 = unclipped(im)
    for _ in range(num_iters):
        a = np.concatenate([im[:, c:c + 1] * im[:, c:] for c in range(3)]
                           + [im, np.ones_like(im[:, :1])], -1)
        warp = np.zeros((a.shape[1], 3))
        for c in range(3):
            m = mask0[:, c] & unclipped(im[:, c]) & unclipped(rf[:, c])
            ma, mb = a * m[:, None], rf[:, c] * m
            warp[:, c] = np.linalg.solve(ma.T @ ma + 1e-6 * np.eye(10),
                                         ma.T @ mb)
        im = np.clip(a @ warp, 0, 1)
    return im.reshape(img.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_color_correct_matches_jax(seed):
    img, ref = _warped_pair(seed)
    assert (img == 1).mean() > 0.01 and (img == 0).mean() > 0.01
    got = color_correct(torch.from_numpy(img), torch.from_numpy(ref)).numpy()
    want = np.asarray(j_color_correct(jnp.asarray(img), jnp.asarray(ref)))
    exact = _color_correct_f64(img, ref)
    assert got.shape == img.shape and got.dtype == np.float32
    for a, b in ((got, exact), (want, exact), (got, want)):
        assert np.abs(a - b).max() <= 1e-3
        assert np.abs(a - b).mean() <= 5e-5

    def psnr(x):
        return -10 * np.log10(np.mean((x - ref) ** 2))

    assert abs(psnr(got) - psnr(want)) <= 1e-3
    # the warp is real: the correction brings the render much closer
    assert np.abs(got - ref).mean() < 0.5 * np.abs(img - ref).mean()


def test_color_correct_of_a_grey_reference():
    """A grey GT (equal channels) makes the first warp grey too; the basis
    columns r, g, b then coincide and the 1e-6 regularisation vanishes in
    fp32 beside the pixel sums. JAX's solve returns NaN for every pixel;
    the port's ``torch.linalg.solve`` raises."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0.1, 0.9, (48, 64, 3)).astype(np.float32)
    ref = np.repeat(rng.uniform(0.1, 0.9, (48, 64, 1)), 3, -1).astype(
        np.float32)
    assert np.isnan(np.asarray(j_color_correct(jnp.asarray(img),
                                               jnp.asarray(ref)))).all()
    with pytest.raises(torch.linalg.LinAlgError):
        color_correct(torch.from_numpy(img), torch.from_numpy(ref))


@pytest.mark.parametrize("h,w", [(64, 96), (70, 101)])
def test_lpips_matches_jax(npz, h, w):
    rng = np.random.default_rng(h)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1).astype(np.float32)
    want = float(jlpips.make_lpips(npz)(a, b))
    ours = tlpips.make_lpips(npz, "cpu")
    carried = tlpips.lpips_from_numpy(_bundle(5), "cpu")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with torch.no_grad():
        for fn in (ours, carried):
            np.testing.assert_allclose(float(fn(ta, tb)), want, rtol=1e-5)
        assert float(ours(ta, ta)) == pytest.approx(0.0, abs=1e-7)
    assert want > 1e-3


def test_synthetic_weights_match_the_jax_tool():
    from tools.make_lpips_weights import synthetic_bundle

    got, want = tlpips.synthetic_weights(3), synthetic_bundle(3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a usable distance: 0 on equal images, positive on different ones
    fn = tlpips.lpips_from_numpy(got, "cpu")
    a = torch.rand((40, 56, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert float(fn(a, a)) == 0.0 and float(fn(a, a.flip(0))) > 0.0


def _alexnet_sd(w):
    """The bundle as torchvision AlexNet and LPIPS v0.1 head state dicts."""
    alex = {}
    for i, ci in enumerate(_CONV_IDX):
        alex[f"features.{ci}.weight"] = np.ascontiguousarray(
            np.transpose(w[f"conv{i}_w"], (3, 2, 0, 1)))
        alex[f"features.{ci}.bias"] = w[f"conv{i}_b"]
    lins = {f"lin{i}.model.1.weight": w[f"lin{i}_w"].reshape(1, -1, 1, 1)
            for i in range(5)}
    return alex, lins


def test_load_weights_matches_jax(npz, tmp_path, capsys):
    alex, lins = _alexnet_sd(_bundle(5))
    alex_p, lins_p = str(tmp_path / "alexnet.pth"), str(tmp_path / "alex.pth")
    both_p = str(tmp_path / "combined.pth")
    save_pth(alex, alex_p)
    save_pth(lins, lins_p)
    save_pth({**alex, **lins}, both_p)
    for path in (npz, both_p, f"{alex_p},{lins_p}"):
        got, want = tlpips.load_weights(path), jlpips.load_weights(path)
        assert sorted(got) == sorted(want) == sorted(jlpips._REQUIRED)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    capsys.readouterr()
    assert tlpips.load_weights(lins_p) is None
    assert "missing weights" in capsys.readouterr().out
    assert jlpips.load_weights(lins_p) is None
    assert tlpips.load_weights(str(tmp_path / "nope.npz")) is None
    assert tlpips.make_lpips(None, "cpu") is None


def _method_dir(root, seed, n=3, h=64, w=96):
    """renders/ and gt/ PNGs: GT noise images, renders a warp of them."""
    rng = np.random.default_rng(seed)
    for sub in ("renders", "gt"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        gt = rng.uniform(0, 1, (h, w, 3))
        r = np.clip(0.8 * gt + 0.15 * gt ** 2 + 0.05
                    + rng.normal(0, 0.05, gt.shape), 0, 1)
        for sub, img in (("renders", r), ("gt", gt)):
            Image.fromarray((img * 255).astype(np.uint8)).save(
                os.path.join(root, sub, f"{i:05d}.png"))
    return root


def test_evaluate_dir_matches_jax(npz, tmp_path):
    j_dir = _method_dir(str(tmp_path / "jax"), 7)
    t_dir = str(tmp_path / "torch")
    shutil.copytree(j_dir, t_dir)
    want = jmetrics.evaluate_dir(j_dir, lpips_weights=npz)
    got = tmetrics.evaluate_dir(t_dir, lpips_weights=npz, device="cpu")
    names = ["00000.png", "00001.png", "00002.png"]
    assert sorted(got["per_view"]) == sorted(want["per_view"]) == names
    for name in names:
        g, j = got["per_view"][name], want["per_view"][name]
        assert list(g) == list(j) == ["PSNR", "SSIM", "LPIPS"]
        assert abs(g["PSNR"] - j["PSNR"]) <= 1e-3
        assert abs(g["SSIM"] - j["SSIM"]) <= 1e-5
        np.testing.assert_allclose(g["LPIPS"], j["LPIPS"], rtol=1e-5)
        a = np.asarray(Image.open(os.path.join(t_dir, "renders_cc", name)),
                       np.int16)
        b = np.asarray(Image.open(os.path.join(j_dir, "renders_cc", name)),
                       np.int16)
        assert int(np.abs(a - b).max()) <= 1
    for f in ("results.json", "per_view.json"):
        with open(os.path.join(t_dir, f)) as fh:
            t_json = json.load(fh)
        with open(os.path.join(j_dir, f)) as fh:
            j_json = json.load(fh)
        assert list(t_json) == list(j_json)
    assert got["mean"]["PSNR"] > want["mean"]["PSNR"] - 1e-3 > 20

    # evaluate_images without weights or correction, as JAX's
    imgs = [tmetrics._load_image(os.path.join(t_dir, s, names[0]))
            for s in ("renders", "gt")]
    raw = tmetrics.evaluate_images([imgs[0]], [imgs[1]], [names[0]],
                                   use_color_correct=False, device="cpu")
    j_raw = jmetrics.evaluate_images([imgs[0]], [imgs[1]], [names[0]],
                                     use_color_correct=False)
    assert raw["mean"]["LPIPS"] is None and j_raw["mean"]["LPIPS"] is None
    assert abs(raw["mean"]["PSNR"] - j_raw["mean"]["PSNR"]) <= 1e-3
    assert raw["mean"]["PSNR"] < got["per_view"][names[0]]["PSNR"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    src = str(tmp_path_factory.mktemp("eval_scene"))
    write_synthetic_scene(src, np.random.default_rng(3), n_points=80,
                          n_cams=4)
    return src


def test_eval_views_matches_jax(scene):
    rng = np.random.default_rng(4)
    n = 120
    params = {
        "xyz": rng.uniform(-1.5, 1.5, (n, 3)),
        "f_dc": rng.normal(0, 0.5, (n, 3)),
        "f_rest": rng.normal(0, 0.1, (n, 15, 3)),
        "scaling": rng.uniform(-2.5, -1.5, (n, 3)),
        "rotation": rng.normal(size=(n, 4)),
        "opacity": rng.uniform(-1, 2, (n, 1)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    alive = np.ones(n, bool)
    alive[-10:] = False
    _, j_test = j_split(j_load_scene(scene).cameras, True, 2)
    _, t_test = t_split(t_load_scene(scene).cameras, True, 2)
    j_cams = [jcams.from_info(i, 1) for i in j_test]
    t_cams = [tcams.from_info(i, 1) for i in t_test]
    bg = np.float32([0.1, 0.2, 0.3])
    j_l1, j_psnr = j_eval_views(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        j_cams, 3, jnp.asarray(bg), batch=len(j_cams))
    p, a = params_from_numpy(params, alive, "cpu")
    t_l1, t_psnr = t_eval_views(p, a, t_cams, 3, torch.from_numpy(bg),
                                device="cpu")
    assert len(t_l1) == len(j_l1) == 2
    np.testing.assert_allclose(t_l1, j_l1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_psnr, j_psnr, rtol=0, atol=1e-3)
    assert t_eval_views(p, a, [], 3, torch.from_numpy(bg),
                        device="cpu") == ([], [])


def test_metrics_and_full_eval_clis_on_the_cpu(scene, npz, tmp_path,
                                               monkeypatch, capsys):
    from pcp_tpu_torch.cli import full_eval
    from pcp_tpu_torch.cli import metrics as metrics_cli
    from pcp_tpu_torch.train import loop

    # the JSONL log only: importing TensorBoard here costs a minute
    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))
    root = tmp_path / "tanksandtemples"
    root.mkdir()
    for name in full_eval.TANKS_AND_TEMPLES:
        os.symlink(scene, root / name)
    out = str(tmp_path / "eval")
    res = full_eval.main(["--tanksandtemples", str(root), "--output_path",
                          out, "--iterations", "2", "--device", "cpu"])
    assert "LPIPS weights not found" in capsys.readouterr().out
    assert sorted(res) == [os.path.join(out, s, "test", "ours_2")
                           for s in ("train", "truck")]
    for mdir, r in res.items():
        with open(os.path.join(mdir, "results.json")) as fh:
            assert json.load(fh) == r["mean"]
        assert np.isfinite(r["mean"]["PSNR"]) and r["mean"]["LPIPS"] is None

    # metrics again over both models, with weights
    again = metrics_cli.main(["-m", os.path.join(out, "truck"),
                              os.path.join(out, "train"), "--lpips_weights",
                              npz, "--device", "cpu"])
    text = capsys.readouterr().out
    assert "LPIPS weights not found" not in text
    assert text.count("PSNR") == 2
    for mdir, r in again.items():
        assert r["mean"]["PSNR"] == res[mdir]["mean"]["PSNR"]
        assert r["mean"]["LPIPS"] > 0


def test_metrics_cli_defaults_to_the_card(tmp_path):
    from pcp_tpu_torch.cli import metrics as metrics_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        metrics_cli.main(["-m", str(tmp_path)])
    with pytest.raises(RuntimeError):
        tmetrics.evaluate_images([np.zeros((8, 8, 3))], [np.zeros((8, 8, 3))])
