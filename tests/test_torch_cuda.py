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
# rounding grows with a segment's length). On the CPU index_add_ adds in row
# order, as the segment sum does: there the two agree bit for bit.
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


def test_poll_viewer_on_the_card_matches_the_cpu(card, monkeypatch):
    # A viewer frame of a seeded 3000-Gaussian state at an off-grid 333x187
    # (a partial tile row and column) with scaling_modifier 0.8, through
    # poll_viewer on both devices: the uint8 frames within 1 level of 255
    # but where CPU and CUDA libm flip a sample (as above: at most 0.1% of
    # the values, each within 2 levels); on the card the float image
    # against the plain composite to ATOL, and the frame is its cast.
    from types import SimpleNamespace

    from pcp_tpu_torch.ops import rasterize as rasterize_mod
    from pcp_tpu_torch.train import loop
    from pcp_tpu_torch.train.config import OptimConfig
    from pcp_tpu_torch.viewer import ViewerCamera

    rng = np.random.default_rng(6)
    n, w, h = 3000, 333, 187
    params = {
        "xyz": np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                         rng.uniform(3, 9, n)], -1),
        "f_dc": rng.normal(0, 0.5, (n, 3)),
        "f_rest": rng.normal(0, 0.1, (n, 15, 3)),
        "scaling": np.log(rng.uniform(0.02, 0.2, (n, 3))),
        "rotation": rng.normal(size=(n, 4)),
        "opacity": rng.normal(0, 1.5, (n, 1))}
    alive = np.arange(n) < n - 100
    wvt = np.eye(4, dtype=np.float32)
    wvt[3, :3] = [0.2, -0.1, 0.5]         # viewmat = wvt.T: a translation
    cam = ViewerCamera(w, h, 1.2, 0.75, 0.01, 100.0, wvt,
                       np.eye(4, dtype=np.float32), True, True, 0.8, False,
                       False)

    class Viewer:
        def try_connect(self):
            return True

        def receive(self):
            return cam

        def send(self, frame, verify):
            self.sent = (frame, verify)

    ocfg = OptimConfig()
    frames, states = {}, {}
    for dev in ("cpu", "cuda"):
        states[dev] = SimpleNamespace(
            params={k: torch.tensor(v, dtype=torch.float32, device=dev)
                    for k, v in params.items()},
            alive=torch.tensor(alive, device=dev))
        viewer = Viewer()
        before = composite.LAUNCHES["composite_fwd"]
        assert loop.poll_viewer(viewer, states[dev], 3, torch.zeros(
            3, device=dev), ocfg, False) is False
        assert composite.LAUNCHES["composite_fwd"] == before + (
            dev == "cuda")
        frames[dev] = viewer.sent[0]
        assert viewer.sent[1] == "pcp_tpu"
        assert frames[dev].shape == (h, w, 3)
    diff = np.abs(frames["cuda"].astype(np.int16) - frames["cpu"])
    assert int(diff.max()) <= 2 and float((diff <= 1).mean()) >= 0.999
    assert float(np.std(frames["cuda"])) > 5

    bg = torch.zeros(3, device=card)
    image = loop.viewer_image(states["cuda"], cam, 3, bg, ocfg)
    np.testing.assert_array_equal(loop.to_frame(image).cpu().numpy(),
                                  frames["cuda"])
    monkeypatch.setattr(rasterize_mod, "composite_fwd",
                        composite.composite_fwd_plain)
    plain = loop.viewer_image(states["cuda"], cam, 3, bg, ocfg)
    torch.testing.assert_close(image, plain, rtol=0, atol=ATOL)


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


def _segment_case(case, rng, n):
    """Nondecreasing gids of the three segment-sum cases."""
    if case == "random":
        return np.sort(rng.integers(0, n, 60_000))
    if case == "skewed":
        return np.concatenate([np.full(50_000, 9), np.sort(
            rng.integers(10, n, 10_000))])
    return np.concatenate([np.sort(rng.integers(0, 1000, 5000)),
                           np.full(300, n), np.full(30, n + 5)])


@pytest.mark.parametrize("case", ["random", "skewed", "pads"])
def test_gathered_segment_sum_matches_plain(card, case):
    """The backward's folded form: pair-order rows placed by a seeded
    permutation. Rows that land past offsets[n] (the pads' gids >= n) are
    NaN and must never be read."""
    rng = np.random.default_rng(13)
    n = 4096
    gid = torch.tensor(_segment_case(case, rng, n).astype(np.int32))
    m = gid.shape[0]
    order = torch.from_numpy(rng.permutation(m))
    rows = torch.from_numpy(rng.normal(size=(m, 9)).astype(np.float32))
    offsets = segsum.segment_offsets(gid, n)
    rows[order >= int(offsets[n])] = float("nan")
    ordered = torch.empty_like(rows)
    ordered[order] = rows
    args = (rows.to(card), order.to(card), offsets.to(card), n)
    before = composite.LAUNCHES["sorted_segment_sum"]
    out = segsum.gathered_segment_sum(*args)
    assert composite.LAUNCHES["sorted_segment_sum"] == before + 1
    again = segsum.gathered_segment_sum(*args)
    keep = gid < n
    plain = segsum.sorted_segment_sum_plain(ordered[keep].to(card),
                                            gid[keep].to(card), n)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    assert float(_seg_rel(out, plain, ordered[keep].to(card),
                          gid[keep].to(card), n)) <= RSEG
    # summed in Gaussian-major order, as the CPU's sequential index_add_
    assert torch.equal(out.cpu(), segsum.sorted_segment_sum(
        ordered[keep].contiguous(), gid[keep].contiguous(), n))
    if case == "pads":
        assert (out[1000:] == 0).all()


def test_train_step_on_the_card_matches_the_cpu(card):
    """One step of a seeded 3000-Gaussian state at 160x96 with appearance on
    both devices: the loss to 1e-4 and each group's gradient (Adam's first
    moment) to 1e-3 of its largest value. CPU and CUDA libm round exp in the
    last bits, which can flip a sample at alpha = 1/255 or a pixel at the
    T = 1e-4 stop. On the card the step runs twice from the same state and,
    with cuDNN held to deterministic algorithms (``resolve_device`` sets
    it; the port's own kernels use no atomics), gives the same bits."""
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
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
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


@pytest.mark.parametrize("layout", ["row", "col", "plane"])
@pytest.mark.parametrize("na", [12, 20])
def test_gather_pack_other_widths(card, layout, na):
    """NA below and above the plane kernel's batch of 16 loads; bit for
    bit, NaN for ids outside [0, N)."""
    from pcp_tpu_torch.ops.gather import gather_pack, gather_pack_plain

    rng = np.random.default_rng(14)
    n, nt, k = 3000, 9, 130
    pack = torch.tensor(rng.standard_normal((n, na)).astype(np.float32),
                        device=card)
    src = pack.T.contiguous() if layout == "plane" else pack
    ids = torch.tensor(rng.integers(0, n, (nt, k)).astype(np.int32),
                       device=card)
    ids[2, 5] = n + 7
    out = gather_pack(src, ids, layout)
    plain = gather_pack_plain(src, ids.clamp_max(n - 1), layout)
    torch.cuda.synchronize()
    assert torch.isnan(out[2, :, 5]).all()
    out[2, :, 5] = plain[2, :, 5]
    assert torch.equal(out, plain)


def _tiny_colmap_scene(root, seed):
    """A COLMAP model of 300 points seen by 4 cameras at 96x64, noise GT."""
    from PIL import Image

    from pcp_tpu_torch.io import colmap

    rng = np.random.default_rng(seed)
    n, w, h = 300, 96, 64
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], -1)
    (root / "images").mkdir(parents=True)
    images = {}
    for i in range(4):
        name = f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
                        ).save(root / "images" / name)
        images[i + 1] = colmap.Image(i + 1, np.array([1.0, 0.0, 0.0, 0.0]),
                                     rng.uniform(-0.2, 0.2, 3), 1, name)
    colmap.write_model(
        {1: colmap.Camera(1, "PINHOLE", w, h,
                          np.array([80.0, 80.0, w / 2, h / 2]))},
        images, colmap.Points3D.from_arrays(
            xyz, rng.integers(0, 256, (n, 3)).astype(np.uint8)),
        str(root / "sparse" / "0"), ext=".bin")


def test_cli_train_repeats_bit_for_bit(card, tmp_path, monkeypatch):
    """Two ``cli.train`` runs of a tiny scene, with a densify and an opacity
    reset, give the same PLY bytes and the same logged losses. They run
    under ``torch.use_deterministic_algorithms``, so an operation on the
    path with no deterministic implementation raises."""
    import functools
    import json

    from pcp_tpu_torch.cli import train
    from pcp_tpu_torch.train import loop

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))
    # cuBLAS is deterministic only with a fixed workspace
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    scene = tmp_path / "scene"
    _tiny_colmap_scene(scene, 15)
    runs = []
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(2):
            out = tmp_path / f"out{i}"
            composite.LAUNCHES.clear()
            train.main(["-s", str(scene), "-m", str(out), "--iterations",
                        "24", "--save_iterations", "24", "--capacity",
                        "1024", "--densify_from_iter", "5",
                        "--densification_interval", "10",
                        "--opacity_reset_interval", "15", "--log_interval",
                        "1", "--quiet"])
            assert composite.LAUNCHES["sorted_segment_sum"] == 24
            logs = [json.loads(line) for line in
                    (out / "train_log.jsonl").read_text().splitlines()]
            losses = [r["train_loss_patches/total_loss"] for r in logs
                      if "train_loss_patches/total_loss" in r]
            ply = (out / "point_cloud" / "iteration_24" /
                   "point_cloud.ply").read_bytes()
            runs.append((losses, ply))
    finally:
        torch.use_deterministic_algorithms(was)
    assert len(runs[0][0]) == 24
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]


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


def test_grid_screen_on_the_card_matches_the_cpu(card):
    """The partition's outlier screen (integer counts, exact in any order)
    gives the same masks on the card as on the CPU."""
    from pcp_tpu_torch.partition.points import _grid_screen

    rng = np.random.default_rng(4)
    pts = np.concatenate([
        np.stack([rng.uniform(-15, 15, 5000), rng.uniform(-15, 15, 5000),
                  rng.normal(0, 0.5, 5000)], -1),
        rng.uniform(-20, 20, (200, 3))]).astype(np.float32)
    on_card = _grid_screen(pts, 5, 1.0, card)
    on_cpu = _grid_screen(pts, 5, 1.0, "cpu")
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a, b)
    assert on_card[0].any() and on_card[1].any()


def test_checkpoint_round_trip_on_the_card(card, tmp_path, monkeypatch):
    """A card state's checkpoint loads back bit for bit, on the card and on
    the CPU."""
    import functools

    from pcp_tpu_torch.cli import train
    from pcp_tpu_torch.scene import load_colmap_scene
    from pcp_tpu_torch.train import checkpoint as ckpt
    from pcp_tpu_torch.train import loop
    from pcp_tpu_torch.train.config import OptimConfig, TrainRunConfig

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))
    scene = tmp_path / "scene"
    _tiny_colmap_scene(scene, 16)
    out = tmp_path / "out"
    state = train.main(["-s", str(scene), "-m", str(out), "--iterations",
                        "6", "--capacity", "1024", "--densify_from_iter",
                        "2", "--densification_interval", "3",
                        "--checkpoint_iterations", "6", "--quiet"])
    cfg = TrainRunConfig(optim=OptimConfig(capacity=1024))
    info = load_colmap_scene(str(scene))
    for dev in (card, torch.device("cpu")):
        template = loop.init_state(info, cfg, torch.Generator().manual_seed(1),
                                   dev)
        loaded, it = ckpt.load(str(out / "chkpnt6.pth"), template)
        assert it == 6
        for a, b in zip(ckpt.leaves(state), ckpt.leaves(loaded)):
            if isinstance(a, torch.Tensor):
                assert b.device.type == dev.type
                assert torch.equal(a.cpu(), b.cpu())
            else:
                assert a == b == 6


def test_pipeline_on_the_card(card, tmp_path, monkeypatch):
    """partition -> auto_train --sequential -> merge -> render -> metrics on
    the card (the CLIs' default device) on a tiny scene: every block trains
    through the backward kernels, the merged model renders and scores."""
    import functools
    import json
    import os

    from pcp_tpu_torch.cli import auto_train, merge, metrics, partition, render
    from pcp_tpu_torch.train import loop

    monkeypatch.setattr(loop, "TrainLogger", functools.partial(
        loop.TrainLogger, use_tensorboard=False))
    scene = tmp_path / "scene"
    _tiny_colmap_scene(scene, 17)
    model = scene / "model"
    records = partition.main([str(scene), "--threshold", "80",
                              "--expansion_distance", "10",
                              "--visible_rate", "0.05", "--no_plots",
                              "--llffhold", "2"])
    assert len(records) >= 2
    visible = model / "split_result" / "visible"
    composite.LAUNCHES.clear()
    auto_train.main(["--base_path", str(visible), "--sequential",
                     "--iterations", "10", "--capacity", "1024",
                     "--resolution", "1", "--densify_from_iter", "3",
                     "--densification_interval", "5"])
    manifest = json.loads((visible / "train_status.json").read_text())
    blocks = sorted(d for d in os.listdir(visible) if (visible / d).is_dir())
    assert sorted(manifest) == blocks == sorted(
        r.partition_id for r in records)
    assert all(v["status"] == "done" for v in manifest.values()), manifest
    assert composite.LAUNCHES["composite_bwd"] == 10 * len(records)
    assert composite.LAUNCHES["sorted_segment_sum"] == 10 * len(records)
    merged = merge.main(["-m", str(model)])
    assert len(merged["xyz"]) > 0
    render.main(["-s", str(scene), "-m", str(model), "--llffhold", "2"])
    res = metrics.main(["-m", str(model)])
    (mean,) = [r["mean"] for r in res.values()]
    assert np.isfinite(mean["PSNR"]) and np.isfinite(mean["SSIM"])


def test_fleet_and_intra_block_on_the_card(card, tmp_path, monkeypatch):
    """auto_train's fleet (banked cameras, shared appearance) and
    ``--intra_block 1`` (one NCCL rank) on a tiny partitioned scene on the
    card: block 0 of the fleet without sharing and the intra-block run
    write the sequential block 0's bytes; the shared fleet trains every
    block through the backward kernels."""
    import json
    import os
    import shutil

    from pcp_tpu_torch.cli import auto_train, partition

    monkeypatch.setenv("PCP_TENSORBOARD", "0")
    scene = tmp_path / "scene"
    _tiny_colmap_scene(scene, 18)
    partition.main([str(scene), "--threshold", "80", "--expansion_distance",
                    "10", "--visible_rate", "0.05", "--no_plots",
                    "--llffhold", "2"])
    visible = scene / "model" / "split_result" / "visible"
    blocks = sorted(d for d in os.listdir(visible) if (visible / d).is_dir())
    flags = ["--iterations", "10", "--capacity", "1024", "--resolution",
             "1", "--densify_from_iter", "3", "--densification_interval",
             "5"]

    def run(name, extra, only=None):
        base = tmp_path / name
        shutil.copytree(visible, base, ignore=shutil.ignore_patterns(
            "train_status.json*", *(b for b in blocks if only and b not in
                                    only)))
        auto_train.main(["--base_path", str(base), *extra, *flags])
        manifest = json.loads((base / "train_status.json").read_text())
        assert all(v["status"] == "done" for v in manifest.values())
        return {b: (base / b / f"partition_{b}" / "output" / "point_cloud" /
                    "iteration_10" / f"{b}_point_cloud.ply").read_bytes()
                for b in manifest}

    seq = run("seq", ["--sequential"], blocks[:1])
    composite.LAUNCHES.clear()
    shared = run("shared", ["--share_appearance", "--device_data"])
    assert sorted(shared) == blocks
    assert composite.LAUNCHES["composite_bwd"] == 10 * len(blocks)
    assert composite.LAUNCHES["sorted_segment_sum"] == 10 * len(blocks)
    assert run("fleet", [], blocks[:1])[blocks[0]] == seq[blocks[0]]
    assert run("intra", ["--intra_block", "1"], blocks[:1]) == seq
