// composite_bwd: back-to-front VJP of the tile blend, one gradient row per
// (tile, slot) pair, for Hopper (sm_90a).
//
// Replaces: pcp_tpu/ops/pallas_composite.py `_composite_bwd` -> `_bwd_kernel`
// / `_bwd_chunk_body` (the pl.pallas_call at pallas_composite.py:1101; body
// :453-620). The TPU kernel walks (9, nt, K) slot tables in reversed 128-slot
// chunks with suffix scans on the MXU; here, as in renderCUDA's backward
// (backward.cu:400-656), one block owns one 16x16 tile and walks its slots
// from the tile's largest n_contrib down to 0. A block has 128 threads in 4
// warps; a warp owns an 8x8 block of the tile, and each thread two pixels
// of one column, rows 2r and 2r + 1 of its block.
//
// Per pixel and slot k < n_contrib that the forward applied (the same
// decision as composite_fwd.cu's, from blend_math.cuh):
//   T_k     = T_{k+1} / (1 - alpha)          T rebuilt by division from t_fin
//   S       = sum_{j>k} w_j (rgb_j . gC) + t_fin gtfin     (suffix, register)
//   dalpha  = T_k (rgb . gC) - S / max(1 - alpha, 0.01)
//   unclamped (alpha < 0.99): dop = dalpha alpha / max(op, 1/255),
//     dpower = dalpha alpha, split into the mean and conic terms
//   dr, dg, db = w gC with w = alpha T_k.
// Both divisions by 1 - alpha use one correctly rounded reciprocal: the
// clamp max(1 - alpha, 0.01) differs from 1 - alpha only at alpha = 0.99
// exactly, where dalpha feeds no term. 1 / max(op, 1/255) is the row's.
//
// Each pair's 9 terms are summed over the 256 pixels in a fixed order, and
// the row is written once. Each pair belongs to one tile, so no block writes
// another's rows: no atomics, and the result is the same on every run.
//
// What bounds it: operations. Every (pixel, slot < n_contrib) sample costs
// ~16 fp32 operations with its expf and ~45 more when applied; the bytes
// (attribute rows, per-pixel t_fin/n_contrib/gcolor/gtfin, 36 B per pair
// out) take a small fraction of that (chip_smoke.py counts both). On the
// card the walk is bound by latency: each slot waits on a shared load, the
// power, an expf and a reciprocal. What the design does about it:
// - a warp walks only the slots below its lanes' largest n_contrib whose
//   box of applicable pixels (blend_math.cuh) meets its 8x8 pixels, found
//   with two ballots per batch: under half of them on a real view;
// - two pixels a thread share each slot's shared loads and give the thread
//   two independent chains, and they halve the reduction's work: a thread
//   adds its two pixels' terms before the warp sums them;
// - the reduction is transposed across a warp: each lane holds the 9 terms
//   of a group of 4 slots (36 values), two halving butterfly steps
//   (offsets 16, 8) each send half of the values a lane holds and keep the
//   sum of the other half, leaving each lane the 9 partials of one slot,
//   and three xor steps finish them: 54 shuffles per 4 slots, 13.5 a slot,
//   where a shuffle tree per value takes 45. A group in which no lane of
//   the warp applied a sample skips it. The 4 warp partials are then
//   summed in warp order. Groups of 8 slots (10 shuffles a slot) need 72
//   registers of terms and ran slower: fewer warps fit on an SM;
// - rows arrive in batches of 64 by cp.async into a double buffer (one
//   thread per row attribute, gids loaded one batch ahead), so the next
//   batch's gather overlaps this one's walk; two barriers per batch;
// - FMAs carry the gradient arithmetic, and the walk starts at the tile's
//   largest n_contrib.
// 72 registers a thread (7 blocks, 28 warps an SM) with a small spill ran
// faster on the card than 96 registers and almost none (5 blocks).
//
// The kernel writes the rows of slots below the tile's largest n_contrib
// only: the caller passes `out` cleared to zero.
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "blend_math.cuh"

namespace {

using namespace blend;

constexpr int kBatch = 64;            // slots staged per pass
constexpr int kGroup = 4;             // slots per warp reduction
constexpr int kVals = kGroup * kNA;   // terms a lane holds per group
static_assert(kBatch % kGroup == 0, "a batch is whole groups");

// One halving step: lanes with `upper` keep the upper half of x, the others
// the lower half; each sends the other half to lane ^ off and adds what it
// receives to what it keeps.
template <int N>
__device__ __forceinline__ void halve(const float (&x)[2 * N], float (&y)[N],
                                      bool upper, int off) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? x[i + N] : x[i];
    const float send = upper ? x[i] : x[i + N];
    y[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// v[9 g + p] holds term p of group slot g in each lane, which is batch slot
// js[g] (-1: none); writes the warp's sums to part[9 js[g] + p]. After the
// halving steps lane l holds group slot 2 (l >> 4 & 1) + (l >> 3 & 1),
// summed over the 4 lanes that share its low three bits; the xor steps
// over bits 0, 1 and 2 complete the sum in all eight lanes of the octet,
// and lane q of the octet stores the planes p with p % 8 == q.
__device__ __forceinline__ void reduce_group(const float (&v)[kVals],
                                             const int (&js)[kGroup],
                                             bool any, int lane,
                                             float* __restrict__ part) {
  float u[kNA];
  if (__any_sync(0xffffffffu, any)) {
    float y[kVals / 2];
    halve<kVals / 2>(v, y, lane & 16, 16);
    halve<kNA>(y, u, lane & 8, 8);
#pragma unroll
    for (int p = 0; p < kNA; ++p) {
      u[p] += __shfl_xor_sync(0xffffffffu, u[p], 1);
      u[p] += __shfl_xor_sync(0xffffffffu, u[p], 2);
      u[p] += __shfl_xor_sync(0xffffffffu, u[p], 4);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kNA; ++p) u[p] = 0.0f;
  }
  const int slot = (lane >> 3) & 3;
  int j = -1;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) j = g == slot ? js[g] : j;
  if (j < 0) return;
  const int q = lane & 7;
#pragma unroll
  for (int p = 0; p < kNA; ++p) {
    if ((p & 7) == q) part[j * kNA + p] = u[p];
  }
}

constexpr int kThreads = kPix / 2;    // two pixels a thread
constexpr int kBlockWarps = kThreads / 32;

// One pixel's backward state: T and the suffix S, its colour cotangent,
// its n_contrib (clamped to the walk) and its row.
struct PixelGrad {
  float T, S, g0, g1, g2, py;
  int nc;
};

// Adds the pixel's terms of batch slot j (pair slot k) into v[9 g + p] and
// advances T and S; false if the pixel does not apply the sample.
__device__ __forceinline__ bool grad_one(PixelGrad& q, float4 geo, float4 opa,
                                         const float4* s_rgb, int j, int k,
                                         float px, float (&v)[kVals], int g) {
  float dx, dy;
  if (k >= q.nc) return false;
  const float power = power_at(geo, opa.x, px, q.py, dx, dy);
  const float alpha = applied_alpha(power, opa);
  if (alpha == 0.0f) return false;
  const float r1m = __frcp_rn(1.0f - alpha);
  const float t_before = q.T * r1m;
  const float w = alpha * t_before;
  const float4 rgb = s_rgb[j];
  const float rgb_dot =
      __fmaf_rn(rgb.z, q.g2, __fmaf_rn(rgb.y, q.g1, rgb.x * q.g0));
  const float dalpha = __fmaf_rn(t_before, rgb_dot, -(q.S * r1m));
  q.S = __fmaf_rn(w, rgb_dot, q.S);
  q.T = t_before;
  v[g * kNA + 5] += w * q.g0;
  v[g * kNA + 6] += w * q.g1;
  v[g * kNA + 7] += w * q.g2;
  if (alpha < kAlphaMax) {
    const float dpower = dalpha * alpha;
    const float hd = -0.5f * dpower;
    const float qa = -2.0f * geo.z, qb = -geo.w, qc = -2.0f * opa.x;
    v[g * kNA + 0] += dpower * __fmaf_rn(qa, dx, qb * dy);
    v[g * kNA + 1] += dpower * __fmaf_rn(qc, dy, qb * dx);
    v[g * kNA + 2] += hd * dx * dx;
    v[g * kNA + 3] += (hd + hd) * dx * dy;
    v[g * kNA + 4] += hd * dy * dy;
    v[g * kNA + 8] += dalpha * (alpha * opa.z);
  }
  return true;
}

__device__ __forceinline__ PixelGrad load_pixel(
    int tile, int lane_pix, float py, const float* t_fin,
    const int* n_contrib, const float* gcolor, const float* gtfin) {
  const size_t pix = static_cast<size_t>(tile) * kPix + lane_pix;
  const size_t cbase = static_cast<size_t>(tile) * 3 * kPix + lane_pix;
  PixelGrad q;
  q.T = t_fin[pix];
  q.nc = n_contrib[pix];
  q.g0 = gcolor[cbase];
  q.g1 = gcolor[cbase + kPix];
  q.g2 = gcolor[cbase + 2 * kPix];
  q.S = q.T * gtfin[pix];
  q.py = py;
  return q;
}

__global__ void __launch_bounds__(kThreads, 7)
composite_bwd_kernel(const float* __restrict__ pack,
                     const int* __restrict__ gids,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int tiles_x,
                     const float* __restrict__ t_fin,
                     const int* __restrict__ n_contrib,
                     const float* __restrict__ gcolor,
                     const float* __restrict__ gtfin,
                     float* __restrict__ out) {
  __shared__ float s_raw[2][kBatch * kNA];
  __shared__ float4 s_geo[kBatch];
  __shared__ float4 s_opa[kBatch];
  __shared__ float4 s_rgb[kBatch];
  __shared__ float4 s_box[kBatch];
  __shared__ float s_part[kBlockWarps][kBatch * kNA];
  __shared__ unsigned long long s_live[kBlockWarps];
  __shared__ int s_warp_max[kBlockWarps];
  const Rows rows{s_geo, s_opa, s_rgb, s_box};

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // This warp's pixels: an 8x8 block of the tile at (x0, sy); a thread's
  // two pixels are rows ly and ly + 1 of column lx.
  const int wx = 8 * (warp & 1), wy = 8 * (warp >> 1);
  const int lx = wx + (lane & 7), ly = wy + 2 * (lane >> 3);
  const int pix0 = ly * kTile + lx;
  const float x0 = static_cast<float>((tile % tiles_x) * kTile + wx);
  const float sy = static_cast<float>((tile / tiles_x) * kTile + wy);
  const float px = static_cast<float>((tile % tiles_x) * kTile + lx);
  const float py0 = static_cast<float>((tile / tiles_x) * kTile + ly);
  const int start = tile_start[tile];

  PixelGrad q0 = load_pixel(tile, pix0, py0, t_fin, n_contrib, gcolor, gtfin);
  PixelGrad q1 = load_pixel(tile, pix0 + kTile, py0 + 1.0f, t_fin, n_contrib,
                            gcolor, gtfin);

  // The walk starts at the tile's largest n_contrib, never past its count.
  const int wmax = __reduce_max_sync(0xffffffffu, max(q0.nc, q1.nc));
  if (lane == 0) s_warp_max[warp] = wmax;
  __syncthreads();
  int nmax = 0;
  for (int w = 0; w < kBlockWarps; ++w) nmax = max(nmax, s_warp_max[w]);
  nmax = min(nmax, tile_count[tile]);
  q0.nc = min(q0.nc, nmax);
  q1.nc = min(q1.nc, nmax);
  const int warp_nc = __reduce_max_sync(0xffffffffu, max(q0.nc, q1.nc));
  if (nmax == 0) return;

  // Batches from the top: batch nb - 1 holds slots [(nb - 1) 64, nmax).
  const int nb = (nmax + kBatch - 1) / kBatch;
  RowIds<kBatch, kThreads> ids;
  ids.fetch(gids, start + (nb - 1) * kBatch, nmax - (nb - 1) * kBatch, tid);
  ids.issue(s_raw[0], pack, tid);
  if (nb > 1) ids.fetch(gids, start + (nb - 2) * kBatch, kBatch, tid);

  for (int it = 0; it <= nb; ++it) {
    const int b = nb - 1 - it;
    const int buf = it & 1;
    cp_async_wait_all();
    // Barrier: batch b has landed, and batch b + 1's walk is done.
    __syncthreads();
    if (it > 0) {
      // Batch b + 1's rows: each term summed over the warps in order, a
      // warp that passed over a slot adding nothing.
      const int prev = (b + 1) * kBatch;
      const int n_prev = min(kBatch, nmax - prev);
      float* dst = out + static_cast<size_t>(start + prev) * kNA;
      for (int i = tid; i < n_prev * kNA; i += kThreads) {
        const int j = i / kNA;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kBlockWarps; ++w) {
          s += (s_live[w] >> j) & 1 ? s_part[w][i] : 0.0f;
        }
        dst[i] = s;
      }
    }
    if (b < 0) break;
    if (b > 0) {
      // s_raw[buf ^ 1] was last read before this barrier.
      ids.issue(s_raw[buf ^ 1], pack, tid);
      if (b > 1) ids.fetch(gids, start + (b - 2) * kBatch, kBatch, tid);
    }
    const int base = b * kBatch;
    const int n = min(kBatch, nmax - base);
    if (tid < n) prepare_row(&s_raw[buf][tid * kNA], rows, tid);
    // Barrier: the rows are staged and batch b + 1's sums are read.
    __syncthreads();

    // The slots this warp walks: below its lanes' largest n_contrib, with a
    // box that meets its 8x8 pixels. The others hold no applied sample of
    // the warp.
    unsigned long long live = 0;
    const int wn = min(n, warp_nc - base);
#pragma unroll
    for (int h = 0; h < kBatch; h += 32) {
      const int j = h + lane;
      const bool meets = j < wn && box_meets(s_box[j], x0, x0 + 7.0f,
                                             sy, sy + 7.0f);
      live |= static_cast<unsigned long long>(
                  __ballot_sync(0xffffffffu, meets)) << h;
    }
    if (lane == 0) s_live[warp] = live;

    // Groups of up to 4 live slots, from the top.
    while (live) {
      int js[kGroup];
#pragma unroll
      for (int g = kGroup - 1; g >= 0; --g) {
        js[g] = live ? 63 - __clzll(live) : -1;
        if (js[g] >= 0) live ^= 1ull << js[g];
      }
      float v[kVals];
#pragma unroll
      for (int i = 0; i < kVals; ++i) v[i] = 0.0f;
      bool any = false;
#pragma unroll
      for (int g = kGroup - 1; g >= 0; --g) {
        const int j = js[g];
        if (j < 0) continue;
        const float4 geo = s_geo[j];
        const float4 opa = s_opa[j];
        any |= grad_one(q0, geo, opa, s_rgb, j, base + j, px, v, g);
        any |= grad_one(q1, geo, opa, s_rgb, j, base + j, px, v, g);
      }
      reduce_group(v, js, any, lane, s_part[warp]);
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const void* pack, const void* gids,
                             const void* tile_start, const void* tile_count,
                             int num_tiles, int tiles_x,
                             const void* t_fin, const void* n_contrib,
                             const void* gcolor, const void* gtfin, void* out,
                             void* stream) {
  composite_bwd_kernel<<<num_tiles, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pack), static_cast<const int*>(gids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      tiles_x, static_cast<const float*>(t_fin),
      static_cast<const int*>(n_contrib), static_cast<const float*>(gcolor),
      static_cast<const float*>(gtfin), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
