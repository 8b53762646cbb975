"""Per-stage byte and operation budget of the port's train step at one
H100's peaks (the port's counterpart of ``tools/roofline.py``, whose stages
and peaks were a TPU v5e's).

Each stage of ``train.step.train_step_impl``, as the profiler ranges of
``tools.profile_stages`` split it, gets the least time the card could take
for that stage's work: the larger of its bytes (each input read once, each
output written once) over the HBM rate and its fp32 operations over the
fp32 rate. The counts are lower bounds: what the stage's function needs on
these inputs, not what the port's code happens to move (no intermediate
that a fused implementation could keep on chip is counted). A step's
stages run in order on one stream, each on the last one's output, so the
step's ideal is their sum; ``sol_fraction`` is that ideal over a measured
step. The stages:

- preprocess: per slot, the geometry (xyz, scale, rotation, opacity), the
  SH coefficients of the active degree (59 floats at degree 3) and the
  probe read, the 9-float attribute row, depth, rect, radius and
  visibility written; its backward reads the segment sums and the geometry
  and writes every parameter's gradient.
- binning: the rects and depths read, then the pair expansion and the sort
  of ``n_pairs`` keys with an int32 value, one read and one write of both a
  radix pass, 8-bit digits over the key's 32 significant bits; then the
  pair list, the permutation, the Gaussian-major gids, the offsets and the
  tile ranges written.
- composite_fwd (B1), composite_bwd (B2): from the samples the kernels
  walk on these inputs (``blend_work``, ``bwd_work``) when ``work`` is
  given, else their byte floor (the pair list and ranges read, the image
  or the gradient rows written).
- segment_sum (B3): each 36-B pair row, its int64 permutation entry, the
  offsets and the n x 9 sums once; one add per input value.
- appearance + loss: the fp32 FLOPs of ``models/appearance.py``'s
  convolutions at their resolutions, the align-corners resize at its two
  non-zeros a row (the port applies it as dense matmuls, far more work),
  and SSIM's 11-tap passes over its five maps; the backward counts every
  convolution's weight gradient, the data gradient of all but the first,
  the resize's adjoint and SSIM's passes over the three maps that depend
  on the render.
- densify stats + adam: every parameter, gradient and both moments read
  and parameter and moments written (59 floats a slot and the appearance
  net and embeddings), and the densify statistics.

The profiler ranges hold forward work only for preprocess and for the
appearance + loss: autograd's backward of both falls in ``REST``, so their
two backward ideals are summed and scored against it.

    python -m pcp_tpu_torch.tools.roofline     # the bench's two geometries
"""

from __future__ import annotations

import json

import torch

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): HBM3 and
# fp32 outside the tensor cores (the port runs fp32 with TF32 off).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

TILE = 16
PIX_PER_TILE = TILE * TILE
F = 4                    # fp32 bytes
GEOMETRY = 11            # xyz 3, scale 3, rotation 4, opacity 1
PROBE = 2                # the zero means2d offset whose gradient drives densify
PARAM_FLOATS = 59        # a slot's parameters: geometry + 48 SH coefficients
NA = 9                   # the attribute row the blend reads
KEY_BITS, RADIX_BITS = 32, 8
SSIM_TAPS, SSIM_MAPS, SSIM_RENDER_MAPS = 11, 5, 3
STATS = 3                # grad_accum, denom, max_radii2d
ADAM_OPS = 10            # per parameter: both moments, the bias terms, the step
# fp32 operations, counted on the plain per-pixel loop (one per add, mul,
# compare or division, an expf as 1), over the samples of the walked
# (warp, slot) pairs; the samples the box test passes over need none of
# them, and the test itself is 4 compares per (warp, slot) pair. The dense
# count charges every sample the plain loop evaluates.
BOX_TEST_OPS = 4


def bound(nbytes: int, ops: int) -> dict:
    """The least time for the work on one H100, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": t_bytes, "ops_ms": t_ops}


# --------------------------------------------------------------------------
# B1 and B2: the samples they walk on given inputs
# --------------------------------------------------------------------------


def _slot_samples(pack, gids, start, live, px, py, block_h):
    """power and alpha of slot k of every tile (``start`` = tile_start + k)
    at its 256 pixels, and (nt, warps) whether the slot's box of applicable
    pixels (``composite.pixel_box``) meets each warp's pixels: 8-wide blocks
    ``block_h`` rows tall, two across the tile, in warp order."""
    from pcp_tpu_torch.ops import composite

    att = pack[gids[torch.where(live, start, 0)].long()]
    dx, dy = px - att[:, 0:1], py - att[:, 1:2]
    power = (-0.5 * (att[:, 2:3] * dx * dx + att[:, 4:5] * dy * dy)
             - att[:, 3:4] * dx * dy)
    alpha = torch.clamp_max(att[:, 8:9] * torch.exp(power),
                            composite.ALPHA_MAX)
    box = composite.pixel_box(att)
    w = torch.arange(2 * TILE // block_h, device=pack.device)
    sx = px[:, :1] + 8 * (w % 2)
    sy = py[:, :1] + block_h * (w // 2)
    meets = ((box[:, 1:2] >= sx) & (box[:, 0:1] <= sx + 7)
             & (box[:, 3:4] >= sy) & (box[:, 2:3] <= sy + block_h - 1))
    return power, alpha, meets


def warp_of_pixel(block_h: int, device) -> torch.Tensor:
    """(256,) the warp that owns each pixel of a tile, for 8 x ``block_h``
    warp blocks as ``_slot_samples`` lays them out."""
    lane = torch.arange(PIX_PER_TILE, device=device)
    return (lane % TILE) // 8 + 2 * ((lane // TILE) // block_h)


def blend_work(pack, gids, tile_start, tile_count, tiles_x):
    """What the blend must do for these inputs, slot by slot as the plain
    version walks them: samples evaluated (pixel not yet done), of those
    with power <= 0 (an expf), with alpha >= 1/255 (tested against the
    stop) and applied; the same four over the samples of the (warp, slot)
    pairs whose box meets the forward kernel's 8x4-pixel warp (the kernel
    walks only these pairs, the box test settles the rest); and the
    (warp, slot) pairs, in all and walked. Raises unless every tested
    sample lies in a walked pair."""
    from pcp_tpu_torch.ops import composite

    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x,
                                     pack.device)
    owner = warp_of_pixel(4, pack.device)
    T = torch.ones_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    start, count = tile_start.long(), tile_count.long()
    work = torch.zeros(10, dtype=torch.int64, device=pack.device)
    for k in range(int(count.max()) if count.numel() else 0):
        live = k < count
        power, alpha, meets = _slot_samples(pack, gids, start + k, live, px,
                                            py, 4)
        walked = live[:, None] & meets
        ev = live[:, None] & ~done
        ex = ev & (power <= 0)
        ok = ex & (alpha >= composite.ALPHA_MIN)
        test_t = T * (1 - alpha)
        stop = ok & (test_t < composite.T_EPS)
        app = ok & ~stop
        done |= stop
        T = torch.where(app, test_t, T)
        each = (ev, ex, ok, app)
        work += torch.stack([m.sum() for m in each]
                            + [(m & walked[:, owner]).sum() for m in each]
                            + [live.sum() * meets.shape[1], walked.sum()])
    work = [int(v) for v in work]
    if work[6:8] != work[2:4]:
        raise RuntimeError(f"the box must hold every tested sample: {work}")
    return work


def bwd_work(pack, gids, tile_start, tile_count, tiles_x, n_contrib):
    """What the backward must do for these inputs: samples re-evaluated
    (slot < the pixel's n_contrib), of those with power <= 0 (an expf),
    applied (alpha >= 1/255) and unclamped (alpha < 0.99); the same four
    over the samples of the (warp, slot) pairs whose box meets the backward
    kernel's 8x8-pixel warp (the kernel walks only these pairs); and the
    (warp, slot) pairs below the warp's largest n_contrib, which the kernel
    tests, in all and walked. Raises unless every applied sample lies in a
    walked pair."""
    from pcp_tpu_torch.ops import composite

    px, py = composite.pixel_coords(tile_start.shape[0], tiles_x,
                                     pack.device)
    start, count = tile_start.long(), tile_count.long()
    nc = n_contrib.long()
    nmax = torch.minimum(nc.max(dim=1).values, count)
    owner = warp_of_pixel(8, pack.device)
    warp_nc = torch.stack([nc[:, owner == w].max(dim=1).values
                           for w in range(4)], dim=1)
    warp_nc = torch.minimum(warp_nc, nmax[:, None])
    work = torch.zeros(10, dtype=torch.int64, device=pack.device)
    for k in range(int(nmax.max()) if nmax.numel() else 0):
        live = k < nmax
        power, alpha, meets = _slot_samples(pack, gids, start + k, live, px,
                                            py, 8)
        tested = k < warp_nc
        walked = tested & meets
        ev = live[:, None] & (k < nc)
        ex = ev & (power <= 0)
        app = ex & (alpha >= composite.ALPHA_MIN)
        unc = app & (alpha < composite.ALPHA_MAX)
        each = (ev, ex, app, unc)
        work += torch.stack([m.sum() for m in each]
                            + [(m & walked[:, owner]).sum() for m in each]
                            + [tested.sum(), walked.sum()])
    work = [int(v) for v in work]
    if work[6:8] != work[2:4]:
        raise RuntimeError(f"the box must hold every applied sample: {work}")
    return work


def fwd_bound(pack, gids, tile_start, work) -> dict:
    """The forward's bound on these inputs (``blend_work``'s counts)."""
    ev, ex, ok, app, wev, wex, _, _, slots, _ = work
    nt = tile_start.shape[0]
    # bytes: each referenced attribute row, the pair list and the ranges
    # read once; color, t_fin and n_contrib written once
    n_rows = int(torch.unique(gids).numel())
    nbytes = (NA * F * n_rows + 4 * gids.numel() + 8 * nt
              + 20 * nt * PIX_PER_TILE)
    # 12 per evaluated sample, 4 more with an expf, 3 more tested, 7 more
    # applied
    ops = (12 * wev + 4 * wex + 3 * ok + 7 * app + BOX_TEST_OPS * slots)
    dense = 12 * ev + 4 * ex + 3 * ok + 7 * app
    return dict(bound(nbytes, ops),
                dense_bound_ms=bound(nbytes, dense)["bound_ms"])


def bwd_bound(gids, tile_start, work) -> dict:
    """The backward's bound on these inputs (``bwd_work``'s counts)."""
    ev, ex, app, unc, wev, wex, _, _, slots, _ = work
    nt = tile_start.shape[0]
    n_pix = nt * PIX_PER_TILE
    n_used = int(torch.unique(gids).numel())
    # bytes: referenced attribute rows, the pair list and ranges, per pixel
    # t_fin, n_contrib, 3 colour and 1 t_fin cotangents read once; one
    # 36-byte row per pair written once
    nbytes = (NA * F * n_used + 4 * gids.numel() + 8 * nt + 24 * n_pix
              + NA * F * gids.numel())
    # 12 per re-evaluated sample, 4 more with an expf, 18 more applied, 21
    # more unclamped; and one add per nonzero term into its pair's row: r,
    # g, b for every applied sample, the 6 alpha terms only unclamped
    applied = (18 + 3) * app + (21 + 6) * unc
    ops = 12 * wev + 4 * wex + applied + BOX_TEST_OPS * slots
    dense = 12 * ev + 4 * ex + applied
    return dict(bound(nbytes, ops),
                dense_bound_ms=bound(nbytes, dense)["bound_ms"])


def kernel_work(bwd_args) -> dict:
    """B1's and B2's bounds on the arguments B2 got in a step
    (``profile_stages.capture_backward``); B1 got their first five."""
    pack, gids, start, count, tiles_x, _, n_contrib = bwd_args[:7]
    return {"composite_fwd": fwd_bound(pack, gids, start, blend_work(
                *bwd_args[:5])),
            "composite_bwd": bwd_bound(gids, start, bwd_work(
                pack, gids, start, count, tiles_x, n_contrib))}


# --------------------------------------------------------------------------
# the step's stages
# --------------------------------------------------------------------------


def segment_sum_bytes(n_pairs: int, capacity: int) -> int:
    """B3's bytes: each 36-B pair row and its int64 permutation entry read,
    the (capacity + 1) int32 offsets read, the capacity x 9 sums written."""
    return (NA * F * n_pairs + 8 * n_pairs + 4 * (capacity + 1)
            + NA * F * capacity)


def _appearance_counts(width: int, height: int):
    """(forward FLOPs, backward FLOPs, net weights, embedding floats) of the
    appearance net and the loss at ``width`` x ``height``, from
    ``AppearanceNetwork``'s layers at the resolutions
    ``decouple_appearance`` runs them."""
    from pcp_tpu_torch.models.appearance import (
        NUM_EMBEDDINGS,
        EMBED_DIM,
        AppearanceNetwork,
    )

    net = AppearanceNetwork()
    hd, wd = max(height // 32, 1), max(width // 32, 1)
    convs = list(net.convs())
    # conv0 at the 1/32 grid, each upsampling conv after a pixel shuffle,
    # conv1 and conv2 at full resolution after the resize
    sizes = [hd * wd] + [(hd << i) * (wd << i) for i in range(1, 5)] \
        + [width * height] * 2
    fwd = bwd = 0
    for i, (conv, px) in enumerate(zip(convs, sizes)):
        macs = px * conv.in_channels * conv.out_channels * 9
        fwd += 2 * macs
        bwd += 2 * macs * (1 if i == 0 else 2)   # weights; data but conv0
    ch = convs[4].out_channels
    # the resize from (16 hd, 16 wd): rows, then columns, two non-zeros
    # a row of each interpolation matrix (a mul and an add each)
    resize = 4 * ch * height * ((wd << 4) + width)
    pix = width * height
    ssim_pass = 2 * SSIM_TAPS * 2 * 3     # two passes, 3 channels
    fwd += resize + pix * (SSIM_MAPS * ssim_pass + 3 + 6)
    bwd += resize + pix * SSIM_RENDER_MAPS * ssim_pass
    weights = sum(p.numel() for p in net.parameters())
    return fwd, bwd, weights, NUM_EMBEDDINGS * EMBED_DIM


def budget(capacity: int, n_pairs: int, width: int, height: int,
           sh_degree: int, work: dict = None) -> dict:
    """Per-stage {MB, GFLOP, ideal_ms, bound_by, range} of one train step:
    ``capacity`` slots, ``n_pairs`` (tile, Gaussian) pairs, a ``width`` x
    ``height`` view at ``sh_degree``; ``work`` is ``kernel_work``'s bounds
    for B1 and B2 (their byte floor without it)."""
    from pcp_tpu_torch.models.appearance import EMBED_DIM
    from pcp_tpu_torch.tools.profile_stages import REST

    n = capacity
    nt = -(-width // TILE) * -(-height // TILE)
    pix = width * height
    sh = 3 * (sh_degree + 1) ** 2
    passes = -(-KEY_BITS // RADIX_BITS)
    app_fwd, app_bwd, net, table = _appearance_counts(width, height)
    app_params = net + table
    stages = {
        "preprocess": (
            n * (F * (GEOMETRY + sh + PROBE) + NA * F + 4 + 16 + 4 + 1),
            n * 2 * sh, "preprocess"),
        "binning": (
            n * 20 + n_pairs * (12 + passes * 2 * 12 + 4 + 8 + 4)
            + 4 * (n + 1) + 8 * nt, 0, "binning"),
        "composite_fwd": (
            4 * n_pairs + 8 * nt + 20 * nt * PIX_PER_TILE, 0,
            "composite_fwd"),
        # the render and the GT read, the net's weights and the view's
        # embedding row
        "appearance + loss": (
            F * (6 * pix + net + EMBED_DIM), app_fwd, "appearance + loss"),
        "composite_bwd": (
            4 * n_pairs + 8 * nt + 24 * nt * PIX_PER_TILE
            + NA * F * n_pairs, 0, "composite_bwd"),
        "segment_sum": (
            segment_sum_bytes(n_pairs, n), NA * n_pairs, "segment_sum"),
        "densify stats + adam": (
            F * (7 * (n * PARAM_FLOATS + app_params)
                 + n * (2 * STATS + PROBE + 1)),
            ADAM_OPS * (n * PARAM_FLOATS + app_params),
            "densify stats + adam"),
        "preprocess backward": (
            F * n * (NA + GEOMETRY + GEOMETRY + sh + PROBE), n * 2 * sh,
            REST),
        # the render and the GT read and the render's gradient written; the
        # weights read and their gradients and the view's embedding row's
        # written
        "appearance + loss backward": (
            F * (9 * pix + 2 * net + EMBED_DIM), app_bwd, REST),
    }
    for name in ("composite_fwd", "composite_bwd"):
        if work:
            nbytes, ops, rng = stages[name]
            stages[name] = (work[name]["bytes"], work[name]["ops"], rng)
    out = {}
    for name, (nbytes, ops, rng) in stages.items():
        b = bound(int(nbytes), int(ops))
        out[name] = {"MB": nbytes / 1e6, "GFLOP": ops / 1e9,
                     "ideal_ms": b["bound_ms"], "bound_by": b["bound_by"],
                     "range": rng}
    return {
        "stages": out,
        "speed_of_light_ms": sum(v["ideal_ms"] for v in out.values()),
        "hbm_MB_per_step": sum(v["MB"] for v in out.values()),
        "gflop_per_step": sum(v["GFLOP"] for v in out.values()),
        "kernel_work": "walked samples" if work else "byte floor",
        "geometry": {"capacity": capacity, "n_pairs": n_pairs,
                     "width": width, "height": height,
                     "sh_degree": sh_degree},
        "peaks": {"hbm_TBps": HBM_BYTES_PER_S / 1e12,
                  "fp32_TFLOPs": FP32_OPS_PER_S / 1e12},
    }


def summarize(measured_ms: float, stage_ms: dict = None, **kw) -> dict:
    """``budget(**kw)`` with ``measured_ms`` (a whole step) and
    ``sol_fraction``, the step's ideal over it; with ``stage_ms`` (device
    ms by profiler range, ``profile_stages.stage_split``) also each range's
    ``stage_share``: the ideals of the stages it holds over its ms."""
    b = budget(**kw)
    b["measured_ms"] = measured_ms
    b["sol_fraction"] = (b["speed_of_light_ms"] / measured_ms
                         if measured_ms else None)
    if stage_ms:
        ideal = {}
        for v in b["stages"].values():
            ideal[v["range"]] = ideal.get(v["range"], 0.0) + v["ideal_ms"]
        b["stage_share"] = {r: (ideal[r] / stage_ms[r]
                                if stage_ms.get(r, 0) > 0 else None)
                            for r in ideal}
    return b


def brief(r: dict) -> dict:
    """The one-line form the bench prints: the step's ideal, measured ms,
    sol_fraction, bytes and FLOPs, each stage's ideal ms and, where stage
    times were given, each range's share."""
    out = {k: r[k] for k in ("speed_of_light_ms", "measured_ms",
                             "sol_fraction", "hbm_MB_per_step",
                             "gflop_per_step", "kernel_work")}
    out["stage_ideal_ms"] = {k: v["ideal_ms"] for k, v in r["stages"].items()}
    if "stage_share" in r:
        out["stage_share"] = r["stage_share"]
    return out


# The bench's canonical point and reference-scale point, with the pairs and
# step ms that ``python -m pcp_tpu_torch.bench`` measured there on one
# NVIDIA H100 80GB HBM3 at a 700 W limit (PERF.md §5); B1 and B2 at their
# byte floor.
POINTS = {
    "canonical 100k live, 2^17 slots, 800x600": dict(
        capacity=1 << 17, n_pairs=723_379, width=800, height=600,
        measured=45.371),
    "reference scale 719,802 live, 2^21 slots, 1280x800": dict(
        capacity=1 << 21, n_pairs=1_869_735, width=1280, height=800,
        measured=62.617),
}


def main() -> None:
    for name, p in POINTS.items():
        print(f"{name} (measured {p['measured']} ms):")
        print(json.dumps(summarize(
            p["measured"], capacity=p["capacity"], n_pairs=p["n_pairs"],
            width=p["width"], height=p["height"], sh_degree=3), indent=1))


if __name__ == "__main__":
    main()
