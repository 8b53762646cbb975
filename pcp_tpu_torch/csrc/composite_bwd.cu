// composite_bwd: back-to-front VJP of the tile blend, one gradient row per
// (tile, slot) pair, for Hopper (sm_90a).
//
// Replaces: pcp_tpu/ops/pallas_composite.py `_composite_bwd` -> `_bwd_kernel`
// / `_bwd_chunk_body` (the pl.pallas_call at pallas_composite.py:1101; body
// :453-620). The TPU kernel walks (9, nt, K) slot tables in reversed 128-slot
// chunks with suffix scans on the MXU; here, as in renderCUDA's backward
// (backward.cu:400-656), one block of 256 threads owns one 16x16 tile and one
// thread owns one pixel, walking the tile's slots from its largest n_contrib
// down to 0.
//
// Per pixel and slot k < n_contrib that the forward applied (power <= 0,
// alpha = min(0.99, op exp(power)) >= 1/255):
//   T_k     = T_{k+1} / (1 - alpha)          T rebuilt by division from t_fin
//   S       = sum_{j>k} w_j (rgb_j . gC) + t_fin gtfin     (suffix, register)
//   dalpha  = T_k (rgb . gC) - S / max(1 - alpha, 0.01)
//   unclamped (alpha < 0.99): dop = dalpha alpha / max(op, 1/255),
//     dpower = dalpha alpha, split into the mean and conic terms
//   dr, dg, db = w gC with w = alpha T_k.
// Each pair's 9 terms are summed over the 256 pixels in a fixed order (a
// shuffle tree inside each warp, then the 8 warp partials in warp order) and
// the row is written once. Each pair belongs to one tile, so no block writes
// another's rows: no atomics, and the result is the same on every run.
//
// What bounds it: operations. Every (pixel, slot < n_contrib) sample costs
// ~16 fp32 operations with its expf and ~45 more when applied; every slot
// written costs 9 x 255 adds of its reduction; the bytes (attribute rows,
// per-pixel t_fin/n_contrib/gcolor/gtfin, 36 B per pair out) take a small
// fraction of that at the reference operating point (chip_smoke.py counts
// both for its inputs). What the design does about it: rows are staged in
// shared memory 32 slots at a time (one global read per pair, not per
// pixel), T, S and the colour cotangent stay in registers, a warp with no
// applied sample skips its shuffle tree, and the walk starts at the tile's
// largest n_contrib, not at its list length. Rows past it stay as the
// caller zero-filled them.
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, pixels per tile
constexpr int kWarps = kPix / 32;
constexpr int kNA = 9;                // mx my a b c r g b op
constexpr int kBatch = 32;            // slots staged per pass
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kDenomMin = 0.01f;    // 1 - ALPHA_MAX, as the TPU kernel

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;   // the sum is in lane 0
}

__global__ void __launch_bounds__(kPix)
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
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_op[kBatch];   // a, b, c, opacity
  __shared__ float4 s_rgb[kBatch];
  __shared__ float s_part[kWarps][kBatch][kNA];
  __shared__ int s_warp_max[kWarps];

  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const int wl = lane & 31;
  const float px = static_cast<float>((tile % tiles_x) * kTile + lane % kTile);
  const float py = static_cast<float>((tile / tiles_x) * kTile + lane / kTile);
  const int start = tile_start[tile];

  const size_t pix = static_cast<size_t>(tile) * kPix + lane;
  const size_t cbase = static_cast<size_t>(tile) * 3 * kPix + lane;
  float T = t_fin[pix];
  const int nc = n_contrib[pix];
  const float g0 = gcolor[cbase];
  const float g1 = gcolor[cbase + kPix];
  const float g2 = gcolor[cbase + 2 * kPix];
  float S = T * gtfin[pix];

  // The walk starts at the tile's largest n_contrib, never past its count.
  const int wmax = __reduce_max_sync(0xffffffffu, nc);
  if (wl == 0) s_warp_max[warp] = wmax;
  __syncthreads();
  int nmax = 0;
  for (int w = 0; w < kWarps; ++w) nmax = max(nmax, s_warp_max[w]);
  nmax = min(nmax, tile_count[tile]);

  for (int base = nmax > 0 ? ((nmax - 1) / kBatch) * kBatch : -1; base >= 0;
       base -= kBatch) {
    const int n = min(kBatch, nmax - base);
    // Barrier: the previous batch's staged rows and partials are consumed.
    __syncthreads();
    if (lane < n) {
      const float* a = pack + static_cast<size_t>(gids[start + base + lane]) * kNA;
      s_xy[lane] = make_float2(a[0], a[1]);
      s_conic_op[lane] = make_float4(a[2], a[3], a[4], a[8]);
      s_rgb[lane] = make_float4(a[5], a[6], a[7], 0.0f);
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float v[kNA];
#pragma unroll
      for (int p = 0; p < kNA; ++p) v[p] = 0.0f;
      bool applied = false;
      if (base + j < nc) {
        const float2 xy = s_xy[j];
        const float4 co = s_conic_op[j];
        const float dx = px - xy.x;
        const float dy = py - xy.y;
        const float power =
            -0.5f * (co.x * dx * dx + co.z * dy * dy) - co.y * dx * dy;
        if (!(power > 0.0f)) {
          const float alpha = fminf(co.w * expf(power), kAlphaMax);
          if (!(alpha < kAlphaMin)) {
            applied = true;
            const float one_m = 1.0f - alpha;
            const float t_before = T / one_m;
            const float w = alpha * t_before;
            const float4 rgb = s_rgb[j];
            const float rgb_dot = rgb.x * g0 + rgb.y * g1 + rgb.z * g2;
            const float dalpha = t_before * rgb_dot - S / fmaxf(one_m, kDenomMin);
            S = S + w * rgb_dot;
            T = t_before;
            v[5] = w * g0;
            v[6] = w * g1;
            v[7] = w * g2;
            if (alpha < kAlphaMax) {
              const float dpower = dalpha * alpha;
              v[0] = dpower * (co.x * dx + co.y * dy);
              v[1] = dpower * (co.z * dy + co.y * dx);
              v[2] = dpower * (-0.5f * dx * dx);
              v[3] = dpower * (-dx * dy);
              v[4] = dpower * (-0.5f * dy * dy);
              v[8] = dalpha * (alpha / fmaxf(co.w, kAlphaMin));
            }
          }
        }
      }
      if (__any_sync(0xffffffffu, applied)) {
#pragma unroll
        for (int p = 0; p < kNA; ++p) v[p] = warp_sum(v[p]);
      }
      if (wl == 0) {
#pragma unroll
        for (int p = 0; p < kNA; ++p) s_part[warp][j][p] = v[p];
      }
    }
    __syncthreads();
    for (int idx = lane; idx < n * kNA; idx += kPix) {
      const int j = idx / kNA;
      const int p = idx - j * kNA;
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += s_part[w][j][p];
      out[static_cast<size_t>(start + base + j) * kNA + p] = s;
    }
  }
}

}  // namespace

extern "C" int composite_bwd(const void* pack, const void* gids,
                             const void* tile_start, const void* tile_count,
                             int num_tiles, int tiles_x, const void* t_fin,
                             const void* n_contrib, const void* gcolor,
                             const void* gtfin, void* out, void* stream) {
  composite_bwd_kernel<<<num_tiles, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pack), static_cast<const int*>(gids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      tiles_x, static_cast<const float*>(t_fin), static_cast<const int*>(n_contrib),
      static_cast<const float*>(gcolor), static_cast<const float*>(gtfin),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
