"""The frozen roofline: the least time one H100 could take for each stage of
a training step or a render, from the work the function needs on the
measured inputs, whatever implements it.

Each stage's ideal is the larger of its bytes over the HBM rate (each input
read once, each output written once) and its fp32 operations over the fp32
rate (TF32 off; one per add, multiply, compare or division, an exp as one).
The counts come from the inputs alone:

- Per-Gaussian stages (preprocess, its backward, Adam) count live
  Gaussians, or those the view sees, never empty slots.
- The blend's work comes from ``reference.render.render(counts=True)`` on
  the same inputs: ``samples``, the (pixel, Gaussian) pairs that the plain
  per-pixel loop applies before each pixel stops; ``pairs``, the (tile,
  Gaussian) pairs with at least one applied sample; ``visible``, the
  Gaussians the view sees. A sample that is not applied changes nothing, so
  an ideal blend need not evaluate it, and an ideal reduction need not read
  a pair that has none. So no share can pass 100% however a later change
  culls, orders or fuses the work.
- B3, the per-Gaussian reduction of the backward's per-pair rows, is
  charged one read of each such pair's 9-float row and one write of each
  visible Gaussian's sum.

Peaks: one H100 SXM (NVIDIA's data sheet, dense, at a 700 W limit): HBM3
at 3.35 TB/s, fp32 outside the tensor cores at 67 TFLOP/s.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F = 4                     # bytes of an fp32 value
ROW = 9                   # mean 2, conic 3, colour 3, opacity 1
GEOMETRY = 11             # xyz 3, log-scale 3, rotation 4, opacity 1
PROBE = 2                 # the screen-mean offset of the densify statistic
PREP_OUT = ROW + 1 + 4 + 1 + 1   # row, depth, rect, radius, visibility
STATS = 3                 # grad_accum, denom, max_radii2d
EMBED_DIM = 64
# (in, out) channels of the appearance network's convolutions, in order
APP_CONVS = ((67, 256), (64, 128), (32, 64), (16, 32), (8, 16), (16, 16),
             (16, 3))
SSIM_TAPS, SSIM_MAPS, SSIM_RENDER_MAPS = 11, 5, 3
# fp32 operations of one applied sample in the plain per-pixel loop:
# forward: offsets 2, the quadratic form 8, exp 1, opacity and clamp 2, the
# skip tests 2, the transmittance 2, the weight 1, the colour 6; backward:
# the sample again (15 before the colour), the colour's three terms and
# the running sums 12, the alpha gradient 6, the conic, mean and opacity
# gradients 14
FWD_OPS_PER_SAMPLE = 24
BWD_OPS_PER_SAMPLE = 47
ADAM_OPS = 10


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def sh_floats(sh_degree: int) -> int:
    return 3 * (sh_degree + 1) ** 2


def appearance_flops(width: int, height: int):
    """(forward, backward) fp32 operations of the appearance network and
    the loss at ``width`` x ``height``: each convolution at its grid, the
    align-corners resize at two non-zeros a row, SSIM's 11-tap passes."""
    hd, wd = max(height // 32, 1), max(width // 32, 1)
    grids = [hd * wd] + [(hd << i) * (wd << i) for i in range(1, 5)] + [
        width * height] * 2
    fwd = bwd = 0
    for i, ((cin, cout), px) in enumerate(zip(APP_CONVS, grids)):
        macs = px * cin * cout * 9
        fwd += 2 * macs
        bwd += 2 * macs * (1 if i == 0 else 2)
    resize = 4 * APP_CONVS[4][1] * height * ((wd << 4) + width)
    pix = width * height
    ssim_pass = 2 * SSIM_TAPS * 2 * 3
    fwd += resize + pix * (SSIM_MAPS * ssim_pass + 9)
    bwd += resize + pix * SSIM_RENDER_MAPS * ssim_pass
    return fwd, bwd


def app_weights() -> int:
    return sum(cin * cout * 9 + cout for cin, cout in APP_CONVS)


def render_stages(live: int, counts: Dict, sh_degree: int) -> Dict:
    """Ideal ms of preprocess, binning and B1 for one view: ``live``
    Gaussians, ``counts`` from ``reference.render.render(counts=True)``."""
    sh = sh_floats(sh_degree)
    vis, pairs = counts["visible"], counts["pairs"]
    samples, pix = counts["samples"], counts["pixels"]
    return {
        "preprocess": bound_ms(live * F * (GEOMETRY + sh + PREP_OUT),
                               live * 2 * sh),
        # the visible rects and depths read, the sorted pair list written
        "binning": bound_ms(vis * F * 5 + pairs * 4, 0),
        # the visible rows and the pair list read, colour and T written
        "composite_fwd": bound_ms(vis * F * ROW + pairs * 4 + pix * F * 4,
                                  samples * FWD_OPS_PER_SAMPLE),
    }


def train_stages(live: int, counts: Dict, sh_degree: int, width: int,
                 height: int) -> Dict:
    """Ideal ms of each stage of one training step, keyed by the profiler
    range that holds it (``trace.STAGES``, ``trace.REST``)."""
    sh = sh_floats(sh_degree)
    vis, pairs = counts["visible"], counts["pairs"]
    samples, pix = counts["samples"], counts["pixels"]
    app_fwd, app_bwd = appearance_flops(width, height)
    net = app_weights()
    params = live * (GEOMETRY + sh) + net + EMBED_DIM
    out = render_stages(live, counts, sh_degree)
    out.update({
        # the render and the GT read, the weights and the view's embedding
        "appearance + loss": bound_ms(F * (6 * pix + net + EMBED_DIM),
                                      app_fwd),
        # the visible rows, the pair list, T and the image gradient read,
        # one row per pair written
        "composite_bwd": bound_ms(
            vis * F * ROW + pairs * 4 + pix * F * 5 + pairs * F * ROW,
            samples * BWD_OPS_PER_SAMPLE),
        "segment_sum": bound_ms(pairs * F * ROW + vis * F * ROW,
                                pairs * ROW),
        # parameters, gradients and both moments read, three written; the
        # statistics updated
        "densify stats + adam": bound_ms(
            F * (7 * params + vis * (2 * STATS + PROBE)), ADAM_OPS * params),
        # autograd's backward of preprocess, the appearance net and the loss
        "rest": bound_ms(
            F * (vis * (ROW + GEOMETRY + sh + PROBE) + live * (GEOMETRY + sh))
            + F * (9 * pix + 2 * net + EMBED_DIM),
            vis * 2 * sh + app_bwd),
    })
    return out
