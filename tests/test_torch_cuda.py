"""The port's CUDA kernels against their plain PyTorch versions, on the card.

On a machine with a CUDA card and ``nvcc``:

    python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips, from inside the ``card`` fixture.
"""

import numpy as np
import pytest
import torch

from pcp_tpu_torch.ops import composite, segsum
from pcp_tpu_torch.ops.projection import CameraIntrin
from pcp_tpu_torch.ops.rasterize import rasterize
from pcp_tpu_torch.tools.blend_inputs import blend_inputs, real_block_counts

pytestmark = pytest.mark.cuda

# The forward kernel takes every decision (power, the 1/255 test, the
# T < 1e-4 stop) and T with the plain version's fp32 rounding (built with
# --fmad=false; a warp passes over a row only where its box, which holds
# every applied pixel, misses the warp), so t_fin and n_contrib agree but
# where expf rounds otherwise; its colour sums are FMAs, a few ulp from the
# plain version's mul-then-add.
ATOL = 1e-5
# Sums taken in another order than the plain version's: the backward's
# 256-pixel reductions (a transposed warp butterfly, then the warps in
# order) and its FMAs and one reciprocal of 1 - alpha in place of two
# divisions, to 1e-5 of each plane's largest value; the segment sum against
# index_add_'s atomics to 1e-6 of the sum of |terms| of each segment (fp32
# rounding grows with a segment's length).
RSUM = 1e-5
RSEG = 1e-6


def _plane_rel(a, b):
    """max |a - b| per column over that column's largest |b|."""
    return ((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(1e-30)).max()


def _seg_rel(out, plain, rows, gid, n):
    """max |out - plain| over the sum of |terms| of each segment."""
    scale = segsum.sorted_segment_sum_plain(rows.abs(), gid, n)
    return ((out - plain).abs() / scale.clamp_min(1e-30)).max()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bins(seed, tiles_x, tiles_y, max_count, dev):
    """Seeded per-Gaussian rows, a shuffled pair list and tile ranges, with
    an empty tile and lists longer than one 256-slot batch."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count + 1, tiles_x * tiles_y)
    counts[0] = 0
    counts[-1] = max_count
    return blend_inputs(rng, tiles_x, counts, dev)


@pytest.mark.parametrize("seed,max_count", [(0, 40), (1, 700), (2, 1500)])
def test_composite_fwd_matches_plain(card, seed, max_count):
    args = _bins(seed, 8, 5, max_count, card)
    before = composite.LAUNCHES["composite_fwd"]
    color, t_fin, n_contrib = composite.composite_fwd(*args)
    assert composite.LAUNCHES["composite_fwd"] == before + 1
    p_color, p_tfin, p_nc = composite.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(color, p_color, rtol=0, atol=ATOL)
    torch.testing.assert_close(t_fin, p_tfin, rtol=0, atol=ATOL)
    assert float((n_contrib == p_nc).float().mean()) >= 0.9999
    assert (t_fin[0] == 1).all() and (n_contrib[0] == 0).all()
    if max_count > 256:
        assert float(t_fin.min()) < 1e-3   # pixels stop inside the lists


def test_composite_fwd_with_no_pairs(card):
    nt = 6
    color, t_fin, n_contrib = composite.composite_fwd(
        torch.zeros((3, 9), device=card),
        torch.zeros(0, dtype=torch.int32, device=card),
        torch.zeros(nt, dtype=torch.int32, device=card),
        torch.zeros(nt, dtype=torch.int32, device=card), 3)
    torch.cuda.synchronize()
    assert (color == 0).all() and (t_fin == 1).all() and (n_contrib == 0).all()


def test_composite_fwd_rejects_mixed_devices(card):
    args = list(_bins(3, 2, 2, 10, card))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError):
        composite.composite_fwd(*args)


def test_rasterize_on_the_card_matches_the_cpu(card):
    # CPU and CUDA libm round exp/log/sqrt differently in the last bits;
    # a sample at alpha = 1/255 or a pixel at the T = 1e-4 stop may flip,
    # which moves that pixel by at most about T / 255.
    rng = np.random.default_rng(5)
    n, w, h = 3000, 160, 96
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(3, 9, n)], -1).astype(np.float32)
    kw = dict(
        xyz=xyz, scales=rng.uniform(0.02, 0.2, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.9, n).astype(np.float32),
        sh=rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32),
        viewmat=np.eye(4, dtype=np.float32), image_size=(w, h),
        background=np.float32([0.1, 0.2, 0.3]), sh_degree=3)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for dev in ("cpu", "cuda", "cuda"):
        intrin = CameraIntrin(*(torch.tensor(v, device=dev) for v in
                                (120.0, 120.0, w / 2, h / 2)))
        img, aux = rasterize(**kw, intrin=intrin, device=dev)
        out[dev] = (img.cpu(), aux["final_t"].cpu(), aux["n_pairs"])
    assert out["cuda"][0].shape == (h, w, 3)
    for i in (0, 1):
        diff = (out["cuda"][i] - out["cpu"][i]).abs()
        assert float(diff.max()) <= 5e-3
        assert float((diff <= 1e-4).float().mean()) >= 0.999
    assert abs(out["cuda"][2] - out["cpu"][2]) <= 1e-3 * out["cpu"][2]


@pytest.mark.parametrize("seed,max_count", [(0, 40), (1, 700), (2, 1500)])
def test_composite_bwd_matches_plain(card, seed, max_count):
    args = _bins(seed, 8, 5, max_count, card)
    color, t_fin, n_contrib = composite.composite_fwd(*args)
    g = torch.Generator(device=card).manual_seed(seed)
    gcolor = torch.randn(color.shape, generator=g, device=card)
    gtfin = torch.randn(t_fin.shape, generator=g, device=card)
    before = composite.LAUNCHES["composite_bwd"]
    rows = composite.composite_bwd(*args, t_fin, n_contrib, gcolor, gtfin)
    assert composite.LAUNCHES["composite_bwd"] == before + 1
    plain = composite.composite_bwd_plain(*args, t_fin, n_contrib, gcolor,
                                          gtfin)
    torch.cuda.synchronize()
    assert rows.shape == (args[1].shape[0], 9)
    assert float(_plane_rel(rows, plain)) <= RSUM
    assert float(plain.abs().max()) > 0
    # deterministic: a second launch gives the same bits
    again = composite.composite_bwd(*args, t_fin, n_contrib, gcolor, gtfin)
    assert torch.equal(rows, again)


def _blend_case(case, dev):
    """Blend inputs of the three shapes the redesigned kernels must hold:
    tile loads of a real block; Gaussians wide and opaque enough that most
    applied samples clamp at alpha = 0.99; a third of the rows dead."""
    rng = np.random.default_rng({"real_block": 20, "clamped": 21,
                                 "dead": 22}[case])
    nt = 40
    if case == "real_block":
        return blend_inputs(rng, 8, real_block_counts(rng, nt), dev)
    counts = rng.integers(0, 701, nt)
    counts[-1] = 700
    if case == "clamped":
        return blend_inputs(rng, 8, counts, dev, opacity=(0.995, 1.0),
                            sigma=(20.0, 3000.0))
    return blend_inputs(rng, 8, counts, dev, dead=1 / 3)


def _first_slot_alpha(pack, gids, tile_start, tile_count, tiles_x):
    """alpha = min(0.99, op exp(power)) of each tile's first slot at its
    256 pixels, where power <= 0 (tiles with pairs only)."""
    live = tile_count > 0
    att = pack[gids[tile_start[live].long()].long()]
    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x, pack.device)
    dx, dy = px[live] - att[:, 0:1], py[live] - att[:, 1:2]
    power = (-0.5 * (att[:, 2:3] * dx * dx + att[:, 4:5] * dy * dy)
             - att[:, 3:4] * dx * dy)
    alpha = torch.clamp_max(att[:, 8:9] * torch.exp(power),
                            composite.ALPHA_MAX)
    return alpha[power <= 0]


@pytest.mark.parametrize("case", ["real_block", "clamped", "dead"])
def test_blend_kernels_match_plain_on_hard_cases(card, case):
    args = _blend_case(case, card)
    pack, count = args[0], args[3]
    color, t_fin, n_contrib = composite.composite_fwd(*args)
    p_color, p_tfin, p_nc = composite.composite_fwd_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(color, p_color, rtol=0, atol=ATOL)
    torch.testing.assert_close(t_fin, p_tfin, rtol=0, atol=ATOL)
    assert float((n_contrib == p_nc).float().mean()) >= 0.9999
    g = torch.Generator(device=card).manual_seed(5)
    gcolor = torch.randn(color.shape, generator=g, device=card)
    gtfin = torch.randn(t_fin.shape, generator=g, device=card)
    bwd = (*args, p_tfin, p_nc, gcolor, gtfin)
    rows = composite.composite_bwd(*bwd)
    plain = composite.composite_bwd_plain(*bwd)
    again = composite.composite_bwd(*bwd)
    torch.cuda.synchronize()
    assert float(_plane_rel(rows, plain)) <= RSUM
    assert torch.equal(rows, again)
    # each case reaches what it is meant to
    if case == "real_block":
        assert int(count.max()) == 2640 and float(count.float().median()) > 700
        assert float(plain[:, 0].abs().max()) > 0
    elif case == "clamped":
        alpha = _first_slot_alpha(*args)
        assert float((alpha == composite.ALPHA_MAX).float().mean()) > 0.5
        assert int(((alpha < composite.ALPHA_MAX)
                    & (alpha >= composite.ALPHA_MIN)).sum()) > 0
        assert float(plain[:, 8].abs().max()) > 0
    else:
        dead = pack[args[1].long(), 8] == 0
        assert 0.25 < float(dead.float().mean()) < 0.4
        assert (rows[dead] == 0).all()


@pytest.mark.parametrize("case", ["random", "skewed", "pads"])
def test_sorted_segment_sum_matches_plain(card, case):
    rng = np.random.default_rng(7)
    n = 4096
    if case == "random":
        gid = np.sort(rng.integers(0, n, 60_000))
    elif case == "skewed":
        gid = np.concatenate([np.full(50_000, 9), np.sort(
            rng.integers(10, n, 10_000))])
    else:
        gid = np.concatenate([np.sort(rng.integers(0, 1000, 5000)),
                              np.full(300, n), np.full(30, n + 5)])
    gid_t = torch.tensor(gid.astype(np.int32), device=card)
    rows = torch.tensor(rng.normal(size=(len(gid), 9)).astype(np.float32),
                        device=card)
    before = composite.LAUNCHES["sorted_segment_sum"]
    out = segsum.sorted_segment_sum(rows, gid_t, n)
    assert composite.LAUNCHES["sorted_segment_sum"] == before + 1
    # the ranges the binning hands over give the same bits as the search
    offsets = segsum.segment_offsets(gid_t.cpu(), n).to(card)
    assert torch.equal(segsum.sorted_segment_sum(rows, gid_t, n, offsets),
                       out)
    plain = segsum.sorted_segment_sum_plain(rows, gid_t, n)
    torch.cuda.synchronize()
    assert float(_seg_rel(out, plain, rows, gid_t, n)) <= RSEG
    # summed in row order, as the CPU's sequential index_add_: equal
    cpu = segsum.sorted_segment_sum(rows.cpu(), gid_t.cpu(), n)
    assert torch.equal(out.cpu(), cpu)
    if case == "pads":
        assert (out[1000:] == 0).all()


def test_train_step_on_the_card_matches_the_cpu(card):
    """One step of a seeded 3000-Gaussian state at 160x96 with appearance on
    both devices: the loss to 1e-4 and each group's gradient (Adam's first
    moment) to 1e-3 of its largest value. CPU and CUDA libm round exp in the
    last bits, which can flip a sample at alpha = 1/255 or a pixel at the
    T = 1e-4 stop. On the card the step runs twice from the same state and,
    with cuDNN held to deterministic algorithms (the port's own kernels
    use no atomics), gives the same bits."""
    from pcp_tpu_torch.models.appearance import init_appearance
    from pcp_tpu_torch.train import optim
    from pcp_tpu_torch.train.config import OptimConfig
    from pcp_tpu_torch.train.step import (TrainState, app_groups,
                                          train_step_impl)
    from pcp_tpu_torch.models.gaussians import (init_densify_stats,
                                                params_from_numpy)

    rng = np.random.default_rng(9)
    n, w, h = 3000, 160, 96
    params = {
        "xyz": np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                         rng.uniform(3, 9, n)], -1),
        "f_dc": rng.normal(0, 0.5, (n, 3)), "f_rest": rng.normal(
            0, 0.1, (n, 15, 3)),
        "scaling": rng.uniform(-4, -2, (n, 3)),
        "rotation": rng.normal(size=(n, 4)),
        "opacity": rng.uniform(-2, 2, (n, 1)),
    }
    gt = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for dev in ("cpu", "cuda", "cuda"):
        p, alive = params_from_numpy(params, np.ones(n, bool), dev)
        app = init_appearance(torch.Generator().manual_seed(1), dev,
                              num_embeddings=4)
        state = TrainState(p, app, optim.init_adam(p), optim.init_adam(
            app_groups(app)), alive, init_densify_stats(n, dev))
        intrin = CameraIntrin(*(torch.tensor(v, device=dev) for v in
                                (120.0, 120.0, w / 2, h / 2)))
        composite.LAUNCHES.clear()
        state, m = train_step_impl(
            state, torch.eye(4, device=dev), intrin,
            torch.tensor(gt, device=dev), 2, torch.zeros(3, device=dev),
            2.0, ocfg=OptimConfig(), image_size=(w, h), sh_degree=3,
            use_appearance=True)
        if dev == "cuda":
            assert dict(composite.LAUNCHES) == {
                "composite_fwd": 1, "composite_bwd": 1,
                "sorted_segment_sum": 1}
        moments = {k: v[0].cpu() for k, v in state.opt_g["mu"].items()}
        moments["net"] = torch.cat([v.flatten().cpu()
                                    for v in state.opt_a["mu"]["net"]])
        if dev in out:
            assert all(torch.equal(moments[k], out[dev][1][k])
                       for k in moments)
        out[dev] = (float(m["loss"]), moments)
    torch.backends.cudnn.deterministic = deterministic
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * l_cpu
    for k in g_cpu:
        rel = (g_gpu[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max()
        assert float(rel) <= 1e-3, (k, float(rel))


@pytest.mark.parametrize("layout", ["row", "col", "plane"])
def test_gather_pack_matches_plain(card, layout):
    """Bit for bit: a gather does no arithmetic. K = 300 is no multiple of
    32, so warps straddle two id rows; ids outside [0, N) give NaN."""
    from pcp_tpu_torch.ops.gather import gather_pack, gather_pack_plain

    rng = np.random.default_rng(11)
    n, na, nt, k = 5000, 16, 37, 300
    pack = torch.tensor(rng.standard_normal((n, na)).astype(np.float32),
                        device=card)
    src = pack.T.contiguous() if layout == "plane" else pack
    ids = torch.tensor(rng.integers(0, n, (nt, k)).astype(np.int32),
                       device=card)
    key = f"gather_pack_{layout}"
    before = composite.LAUNCHES[key]
    out = gather_pack(src, ids, layout)
    assert composite.LAUNCHES[key] == before + 1
    plain = gather_pack_plain(src, ids, layout)
    torch.cuda.synchronize()
    assert out.shape == (nt, na, k)
    assert torch.equal(out, plain)
    bad = ids.clone()
    bad[0, :2] = torch.tensor([-1, n], dtype=torch.int32)
    out = gather_pack(src, bad, layout)
    torch.cuda.synchronize()
    assert torch.isnan(out[0, :, :2]).all()
    assert torch.equal(out[0, :, 2:], plain[0, :, 2:])
    assert torch.equal(out[1:], plain[1:])


def test_evaluate_images_on_the_card_matches_the_cpu(card, tmp_path):
    """3 warped views with a random LPIPS bundle, to the tolerances of
    tests/test_torch_eval.py: PSNR 1e-3 dB, SSIM 1e-5, LPIPS 1e-5
    relative."""
    from pcp_tpu_torch.eval.lpips import synthetic_weights
    from pcp_tpu_torch.eval.metrics import evaluate_images

    rng = np.random.default_rng(12)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **synthetic_weights(12))
    gts = [rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
           for _ in range(3)]
    renders = [np.clip(0.8 * g + 0.15 * g * g + 0.05 + rng.normal(
        0, 0.05, g.shape), 0, 1).astype(np.float32) for g in gts]
    out = {dev: evaluate_images(renders, gts, lpips_weights=path,
                                device=dev)["per_view"]
           for dev in ("cpu", "cuda")}
    for name, c in out["cpu"].items():
        g = out["cuda"][name]
        assert abs(g["PSNR"] - c["PSNR"]) <= 1e-3
        assert abs(g["SSIM"] - c["SSIM"]) <= 1e-5
        assert abs(g["LPIPS"] - c["LPIPS"]) <= 1e-5 * abs(c["LPIPS"])
