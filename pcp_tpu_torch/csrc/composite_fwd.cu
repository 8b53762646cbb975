// composite_fwd: front-to-back blend of each 16x16 tile's depth-sorted
// Gaussians, for Hopper (sm_90a).
//
// Replaces: pcp_tpu/ops/pallas_composite.py `_fwd` -> `_fwd_kernel` /
// `_fwd_chunk_body` (the pl.pallas_call at pallas_composite.py:1021). It
// computes the same function, not a block-by-block copy: the TPU kernel
// walks a materialised (9, nt, K) slot table in 128-slot chunks with scans
// on the MXU; here one block of 256 threads owns one tile, one thread owns
// one pixel, and the blend is the plain sequential loop of renderCUDA
// (forward.cu:261-374).
//
// What bounds it: operations. Each (pixel, slot) sample before the pixel's
// stop costs 16 fp32 operations with its expf, 26 when it is applied; the
// bytes it must move (each referenced 36-byte attribute row, the 4-byte
// pair list, 20 bytes of output per pixel) take ~1/7 of that time at the
// reference operating point (720k Gaussians, 1280x800; chip_smoke.py counts
// both for its inputs). On the card the walk is bound by latency: each slot
// waits on a shared load, the power and an expf. What the design does about
// it:
// - the tile's rows arrive in batches of 256 by cp.async into a double
//   buffer in shared memory (one thread per row attribute, the gids loaded
//   one batch ahead), so the next batch's gather overlaps this one's walk;
// - each row's conic is scaled, and its log-domain threshold and the box of
//   the pixels it can apply computed, once when it is staged
//   (blend_math.cuh); a warp owns an 8x4 block of pixels and passes over
//   every slot whose box misses it, found with one ballot per 32 slots:
//   most of them on a real view (a compact block meets fewer boxes than a
//   16x2 strip, and ran faster on the card);
// - the warp takes the slots it walks kStep at a time: first their alphas,
//   which do not depend on T, so that their loads and expf overlap, then
//   the blend in order, branch-free;
// - T, the colour sums (FMAs) and n_contrib stay in registers, and the
//   block leaves the tile as soon as all 256 pixels are done
//   (__syncthreads_count).
// Two pixels a thread ran no faster on the card, so a thread keeps one.
//
// Semantics held exactly (see pcp_tpu_torch/ops/composite.py): integer
// pixel coordinates, power = -0.5 (a dx^2 + c dy^2) - b dx dy with skip on
// power > 0, alpha = min(0.99, op exp(power)) skipped below 1/255, the slot
// whose T (1 - alpha) would fall below 1e-4 is not applied and stops the
// pixel, n_contrib = 1 + index of the last applied slot. Every decision and
// T round as the plain version's; only the colour sums' FMAs differ.
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "blend_math.cuh"

namespace {

using namespace blend;

constexpr int kBatch = kPix;          // rows staged per pass
constexpr int kStep = 2;              // slots whose alphas a warp takes at once
constexpr float kTEps = 1.0e-4f;

// At most 64 registers a thread: 4 blocks, 32 warps an SM (fewer spill,
// more ran slower on the card).
__global__ void __launch_bounds__(kPix, 4)
composite_fwd_kernel(const float* __restrict__ pack,
                     const int* __restrict__ gids,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     int tiles_x,
                     float* __restrict__ color,
                     float* __restrict__ t_fin,
                     int* __restrict__ n_contrib) {
  __shared__ float s_raw[2][kBatch * kNA];
  __shared__ float4 s_geo[kBatch];
  __shared__ float4 s_opa[kBatch];
  __shared__ float4 s_rgb[kBatch];
  __shared__ float4 s_box[kBatch];
  const Rows rows{s_geo, s_opa, s_rgb, s_box};

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // This warp's pixels: an 8x4 block of the tile, at (sx, sy).
  const int wx = 8 * ((tid >> 5) & 1), wy = 4 * (tid >> 6);
  const int lx = wx + (lane & 7), ly = wy + (lane >> 3);
  const int lane_pix = ly * kTile + lx;
  const float x0 = static_cast<float>((tile % tiles_x) * kTile + wx);
  const float sy = static_cast<float>((tile / tiles_x) * kTile + wy);
  const float px = static_cast<float>((tile % tiles_x) * kTile + lx);
  const float py = static_cast<float>((tile / tiles_x) * kTile + ly);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const int nb = (count + kBatch - 1) / kBatch;

  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int last = 0;
  bool done = false;

  RowIds<kBatch> ids;
  if (nb > 0) {
    ids.fetch(gids, start, min(kBatch, count), tid);
    ids.issue(s_raw[0], pack, tid);
    if (nb > 1) {
      ids.fetch(gids, start + kBatch, min(kBatch, count - kBatch), tid);
    }
  }
  for (int b = 0; b < nb; ++b) {
    const int buf = b & 1;
    const int base = b * kBatch;
    const int n = min(kBatch, count - base);
    cp_async_wait_all();
    // Barrier: batch b has landed, every thread has finished batch b - 1,
    // and the whole block leaves once all of its pixels are done.
    if (__syncthreads_count(done) == kPix) break;
    if (b + 1 < nb) {
      // s_raw[buf ^ 1] was last read before this barrier.
      ids.issue(s_raw[buf ^ 1], pack, tid);
      if (b + 2 < nb) {
        const int next = base + 2 * kBatch;
        ids.fetch(gids, start + next, min(kBatch, count - next), tid);
      }
    }
    if (tid < n) prepare_row(&s_raw[buf][tid * kNA], rows, tid);
    __syncthreads();
    // 32 slots at a time, each lane tests one slot's box against the
    // warp's strip; the warp walks only the slots whose box meets it, in
    // order, kStep at a time: first each slot's alpha (independent of T,
    // so the expf of the kStep slots overlap), then the blend in order. It
    // stops once all of its pixels are done.
    for (int c = 0; c < n; c += 32) {
      if (__all_sync(0xffffffffu, done)) break;
      const int jl = c + lane;
      const bool meets = jl < n && box_meets(s_box[jl], x0, x0 + 7.0f,
                                             sy, sy + 3.0f);
      unsigned m = __ballot_sync(0xffffffffu, meets);
      while (m) {
        int js[kStep];
        float al[kStep];
#pragma unroll
        for (int s = 0; s < kStep; ++s) {
          js[s] = m ? c + __ffs(m) - 1 : -1;
          m &= m - 1;
          const int j = max(js[s], c);
          const float4 opa = s_opa[j];
          float dx, dy;
          const float power = power_at(s_geo[j], opa.x, px, py, dx, dy);
          al[s] = js[s] >= 0 ? applied_alpha(power, opa) : 0.0f;
        }
#pragma unroll
        for (int s = 0; s < kStep; ++s) {
          const float alpha = al[s];
          const float test_t = T * (1.0f - alpha);
          const bool act = alpha > 0.0f && !done;
          const bool stop = act && test_t < kTEps;
          const bool apply = act && !stop;
          done = done || stop;
          const float w = apply ? alpha * T : 0.0f;
          const float4 rgb = s_rgb[max(js[s], c)];
          c0 = __fmaf_rn(rgb.x, w, c0);
          c1 = __fmaf_rn(rgb.y, w, c1);
          c2 = __fmaf_rn(rgb.z, w, c2);
          T = apply ? test_t : T;
          last = apply ? base + js[s] + 1 : last;
        }
      }
    }
  }
  cp_async_wait_all();   // nothing in flight when the block leaves

  const size_t pix = static_cast<size_t>(tile) * kPix + lane_pix;
  const size_t cbase = static_cast<size_t>(tile) * 3 * kPix + lane_pix;
  color[cbase] = c0;
  color[cbase + kPix] = c1;
  color[cbase + 2 * kPix] = c2;
  t_fin[pix] = T;
  n_contrib[pix] = last;
}

}  // namespace

extern "C" int composite_fwd(const void* pack, const void* gids,
                             const void* tile_start, const void* tile_count,
                             int num_tiles, int tiles_x, void* color,
                             void* t_fin, void* n_contrib, void* stream) {
  composite_fwd_kernel<<<num_tiles, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pack), static_cast<const int*>(gids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      tiles_x, static_cast<float*>(color), static_cast<float*>(t_fin),
      static_cast<int*>(n_contrib));
  return static_cast<int>(cudaGetLastError());
}
