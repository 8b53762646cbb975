// blend_math.cuh: the per-row precompute, the per-sample power/alpha/skip
// decision and the row staging that composite_fwd.cu and composite_bwd.cu
// share, so both kernels apply the same samples by construction.
//
// Semantics (pcp_tpu_torch/ops/composite.py, renderCUDA forward.cu:261-374):
// power = -0.5 (a dx^2 + c dy^2) - b dx dy; a sample is skipped if
// power > 0 or alpha = min(0.99, op expf(power)) < 1/255.
//
// Per row, once when it is staged: the conic scaled to (-0.5 a, -b, -0.5 c),
// 1 / max(op, 1/255) for the backward's opacity term, and the box that
// holds every pixel the row can apply, sized from the log-domain threshold
// thr = logf(kAlphaMin / op) - kSkipMargin (+inf for op <= 0), below every
// power the exact test applies (see sample_box). Per warp, a slot whose box
// misses the warp's pixels is passed over by all 32 lanes at once, expf and
// all; every other sample takes the exact test.
//
// The power is the plain version's to the bit: scaling by -0.5 and negating
// are exact in fp32, so ((ca dx) dx + (cc dy) dy) + (cb dx) dy rounds as
// -0.5 ((a dx) dx + (c dy) dy) - (b dx) dy does, and the files are built with
// --fmad=false. An FMA here would round the power differently and move the
// 1/255 and T < 1e-4 decisions off the plain version's on a few samples in
// 10^8, each of which shifts a pixel by up to T / 255.
//
// Why thr lies below every applied power: expf is within 2 ulp and the
// product rounds once, so op expf(power) < kAlphaMin whenever
// power < log(kAlphaMin / op) - 4e-7, and the computed threshold is within
// 1e-4 of log(kAlphaMin / op) for every positive finite fp32 op (logf is
// within 1 ulp of a result below 104 in size; the quotient rounds to 6e-8
// relative, or to 6e-5 where it falls subnormal, op > 3e35). kSkipMargin =
// 1e-3 lies above both and costs an expf only on the samples within 1e-3
// of the boundary. A quotient that overflows (op subnormal) gives +inf:
// such a row's alpha is below 1/255 everywhere. ops/composite.py mirrors
// the rule (``skip_threshold``) and tests/test_torch_blend_math.py holds
// the mirror to the exact test on a dense fp32 grid.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace blend {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // pixels per tile
constexpr int kNA = 9;                // mx my a b c r g b op
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kSkipMargin = 1.0e-3f;
constexpr float kMaxCond = 1.0e4f;    // conics beyond it get no box

// A staged row: geo = (mx, my, -0.5 a, -b), opa = (-0.5 c, op,
// 1 / max(op, 1/255), 0), rgb = (r, g, b, 0), box = (xlo, xhi, ylo, yhi).
struct Rows {
  float4* geo;
  float4* opa;
  float4* rgb;
  float4* box;
};

// The pixels (px, py) that the row can apply lie in [xlo, xhi] x [ylo, yhi].
// An applied sample has computed power >= thr (above), and the computed
// power is within 4.8e-7 kappa |power| of the true quadratic form's, kappa
// the conic's condition number; for kappa <= 1e4 its true power is then at
// least 1.01 thr - 0.01, and the box bounds that ellipse,
// a dx^2 + 2 b dx dy + c dy^2 <= 2 t with t = 0.01 - 1.01 thr, by
// |dx| <= sqrt(2 t c / det), |dy| <= sqrt(2 t a / det), widened by 0.1% and
// 0.01 px for its own rounding. thr > 0 applies nothing: an empty box. A
// conic that is not positive definite or beyond kMaxCond, or a NaN, gives
// the whole plane.
__device__ __forceinline__ float4 sample_box(float mx, float my, float a,
                                             float b, float c, float thr) {
  const float inf = CUDART_INF_F;
  if (thr > 0.0f) return make_float4(inf, -inf, inf, -inf);
  const float det = a * c - b * b;
  const float half = 0.5f * (a - c);
  const float lmax = 0.5f * (a + c) + sqrtf(half * half + b * b);
  if (!(a > 0.0f && c > 0.0f && det > 0.0f &&
        lmax * lmax <= kMaxCond * det)) {
    return make_float4(-inf, inf, -inf, inf);
  }
  const float t2 = 2.0f * (0.01f - 1.01f * thr);
  const float rx = sqrtf(t2 * c / det) * 1.001f + 0.01f;
  const float ry = sqrtf(t2 * a / det) * 1.001f + 0.01f;
  return make_float4(mx - rx, mx + rx, my - ry, my + ry);
}

// False only if the box misses [x0, x1] x [y0, y1]; a NaN box meets.
__device__ __forceinline__ bool box_meets(float4 box, float x0, float x1,
                                          float y0, float y1) {
  return !(box.y < x0 || box.x > x1 || box.w < y0 || box.z > y1);
}

__device__ __forceinline__ void prepare_row(const float* a, Rows rows,
                                            int r) {
  const float op = a[8];
  const float thr =
      op <= 0.0f ? CUDART_INF_F : logf(kAlphaMin / op) - kSkipMargin;
  rows.geo[r] = make_float4(a[0], a[1], -0.5f * a[2], -a[3]);
  rows.opa[r] = make_float4(-0.5f * a[4], op, 1.0f / fmaxf(op, kAlphaMin),
                            0.0f);
  rows.rgb[r] = make_float4(a[5], a[6], a[7], 0.0f);
  rows.box[r] = sample_box(a[0], a[1], a[2], a[3], a[4], thr);
}

// power at (px, py); dx and dy out. Same rounding as the plain version.
__device__ __forceinline__ float power_at(float4 geo, float cc, float px,
                                          float py, float& dx, float& dy) {
  dx = px - geo.x;
  dy = py - geo.y;
  return (geo.z * dx * dx + cc * dy * dy) + geo.w * dx * dy;
}

// alpha of the sample where the exact test applies it, else 0 (an applied
// alpha is at least 1/255).
__device__ __forceinline__ float applied_alpha(float power, float4 opa) {
  const float alpha = fminf(opa.y * expf(power), kAlphaMax);
  const bool ok = !(power > 0.0f) && !(alpha < kAlphaMin);
  return ok ? alpha : 0.0f;
}

// ---- staging: cp.async of 36-B rows, one thread per (row, attribute) ----

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The gids of one batch of kRows rows, kPer for each of kThreads threads,
// held in registers one batch ahead of the copies that use them so that
// their load latency hides behind the walk of the batch before.
template <int kRows, int kThreads = kPix>
struct RowIds {
  static constexpr int kPer = (kRows * kNA + kThreads - 1) / kThreads;
  int gid[kPer];

  // Rows [0, n) of the batch whose first pair is gids[first].
  __device__ __forceinline__ void fetch(const int* __restrict__ gids,
                                        int first, int n, int tid) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int r = (tid + m * kThreads) / kNA;
      gid[m] = r < n ? __ldg(gids + first + r) : -1;
    }
  }

  // raw[r * 9 + p] = pack[gid_r * 9 + p]: consecutive threads copy
  // consecutive floats of a row, so each row is one coalesced request.
  __device__ __forceinline__ void issue(float* raw,
                                        const float* __restrict__ pack,
                                        int tid) const {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int c = tid + m * kThreads;
      if (gid[m] >= 0) {
        cp_async4(raw + c,
                  pack + static_cast<size_t>(gid[m]) * kNA + c % kNA);
      }
    }
    cp_async_commit();
  }
};

}  // namespace blend
