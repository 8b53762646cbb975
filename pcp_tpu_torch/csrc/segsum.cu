// Per-Gaussian sums of per-pair gradient rows, for Hopper (sm_90a).
//
// Replaces: pcp_tpu/ops/segsum_pallas.py `sorted_segment_sum` -> `_kernel`
// (the pl.pallas_call at segsum_pallas.py:164; body :43-119). The TPU kernel
// reduces each block of 256 gids of gid-sorted rows with one-hot matmuls on
// the MXU, after the JAX package has put the per-pair rows in gid order.
// Here that reorder is folded into the reduction: Gaussian g's sum runs over
// rows[inv[j]] for j in [offsets[g], offsets[g + 1]), where the rows stay in
// the pair-list (tile-major) order the backward wrote them in and inv gives,
// for each Gaussian-major position j, the pair-list row that belongs there
// (`gathered_segment_sum`). inv is the inverse of the binning's sort
// permutation `order` (pair-list row i holds Gaussian-major position
// order[i]); a first kernel builds it with one int32 scatter, inv[order[i]] =
// i, into a scratch buffer the caller provides. The gid-sorted entry
// (`sorted_segment_sum`) is the sum kernel with inv the identity.
//
// Each output is the sum of its segment taken in Gaussian-major order, one
// row after the other, in fp64, and rounded once to fp32: no atomics, the
// same bits on every run, equal to a sequential fp64 scatter-add in that
// order rounded to fp32 (the plain version). An fp32 accumulator drifts by
// the rounding of every add: on the heaviest of 2000 steps of a 722k-point
// block at 1280x800 in 2^21 slots (on an H100) the sums sat 8.6e-7 of their
// sum of |terms| from the fp64 sum, and 1.0e-6 from fp32 atomic sums. Positions past offsets[n] (gid >= n)
// belong to no output and are never read.
//
// What bounds it: bytes. Each pair row (36 B) is read once, the permutation
// (8 B a pair) once, the n + 1 offsets once, and the n x 9 sums written once;
// there is one add per input value. A gathered row always touches two 32-B
// sectors: it starts at byte 36 r, which is 4 r mod 32 <= 28 bytes into a
// sector, and its last byte lies at most 28 + 35 = 63 bytes past that
// sector's start. So the memory system moves 64 B for a 36-B row, and more
// where the rows do not stay in the 50 MB L2 (2M pairs are 68 MB); the bound
// still counts 36. The inverse scatter writes 4 B to a random place per pair:
// its 7.5 MB at 2M pairs stay in L2 until the sum reads them.
//
// What the design does about it. One warp owns 32 consecutive Gaussians,
// whose segments form one contiguous range of Gaussian-major positions. It
// walks that range in chunks of kChunk rows: the chunk's inverse index is
// staged in shared memory with coalesced loads; then consecutive lanes load
// consecutive floats of the chunk's rows (one 32-lane load touches about
// four rows, where a lane per row would touch 32 lines per load), all of a
// lane's loads issued before any is used, and the values are staged in
// shared memory in Gaussian-major order; then each lane adds the rows of its
// own Gaussian, in order, into nine independent fp64 accumulators. The warp's
// 32 x 9 sums leave through shared memory as contiguous stores, so a run of
// Gaussians that own no pair costs two offset loads and a zero store each,
// and one thread does the work of a Gaussian where nine did. The block is
// held to 64 registers a thread (32 warps an SM), which keeps enough warps
// waiting on memory to cover the chain offsets -> inv -> rows.
//
// Plain C interface for ctypes. Each entry point launches on the caller's
// stream, allocates nothing and does not synchronise; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kNA = 9;
constexpr int kWarps = 8;                      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;                  // blocks an SM: <= 64 registers
// rows a warp stages at once: 32, so that a lane's 9 loads in flight and
// its 9 fp64 accumulators fit the 64 registers (at 64 rows, 18 loads, the
// kernel spilled 136 B a thread to local memory)
constexpr int kChunk = 32;
constexpr int kPerLane = kChunk * kNA / 32;    // loads a lane issues a chunk

static_assert(kChunk * kNA % 32 == 0, "a chunk is whole warp loads");
static_assert(kChunk >= 32, "the chunk buffer also stages the warp's sums");

__global__ void __launch_bounds__(kThreads)
segsum_invert_kernel(const long long* __restrict__ order, int m,
                     int* __restrict__ inv) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= m) return;
  const long long j = order[i];
  if (j >= 0 && j < m) inv[j] = static_cast<int>(i);   // never outside inv
}

template <bool kGather>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segsum_kernel(const float* __restrict__ rows, const int* __restrict__ inv,
              const int* __restrict__ offsets, int n,
              float* __restrict__ out) {
  __shared__ float stage_all[kWarps][kChunk * kNA];
  __shared__ int index_all[kWarps][kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * 32;
  if (g0 >= n) return;
  const int count = static_cast<int>(min(32LL, n - g0));
  float* stage = stage_all[warp];
  int* index = index_all[warp];

  // this lane's segment [lo, hi) and the warp's range [base, end)
  const int lo = offsets[g0 + min(lane, count)];
  const int hi = offsets[g0 + min(lane + 1, count)];
  const int base = __shfl_sync(0xffffffffu, lo, 0);
  const int end = __shfl_sync(0xffffffffu, hi, 31);

  double s[kNA];
#pragma unroll
  for (int p = 0; p < kNA; ++p) s[p] = 0.0;
  for (int c0 = base; c0 < end; c0 += kChunk) {
    const int cn = min(kChunk, end - c0);
    if (kGather) {
      for (int i = lane; i < cn; i += 32) index[i] = inv[c0 + i];
      __syncwarp();
    }
    const int nf = cn * kNA;
    float v[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int f = lane + 32 * q;
      if (f < nf) {
        const int i = static_cast<unsigned>(f) / kNA;
        const int r = kGather ? index[i] : c0 + i;
        v[q] = rows[static_cast<size_t>(r) * kNA + (f - i * kNA)];
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int f = lane + 32 * q;
      if (f < nf) stage[f] = v[q];
    }
    __syncwarp();
    const int a = max(lo, c0);
    const int b = min(hi, c0 + cn);
    for (int j = a; j < b; ++j) {
      const float* row = stage + (j - c0) * kNA;
#pragma unroll
      for (int p = 0; p < kNA; ++p) s[p] += static_cast<double>(row[p]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int p = 0; p < kNA; ++p) {
    stage[lane * kNA + p] = static_cast<float>(s[p]);
  }
  __syncwarp();
  float* dst = out + g0 * kNA;
  for (int i = lane; i < count * kNA; i += 32) dst[i] = stage[i];
}

int launch(const void* rows, const void* inv, const void* offsets, int n,
           void* out, void* stream) {
  const long long warps = (static_cast<long long>(n) + 31) / 32;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  if (blocks > 0) {
    const auto* r = static_cast<const float*>(rows);
    const auto* i = static_cast<const int*>(inv);
    const auto* o = static_cast<const int*>(offsets);
    auto* d = static_cast<float*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (inv != nullptr) {
      segsum_kernel<true><<<blocks, kThreads, 0, s>>>(r, i, o, n, d);
    } else {
      segsum_kernel<false><<<blocks, kThreads, 0, s>>>(r, i, o, n, d);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows (M, 9) f32 gid-sorted; offsets (n + 1,) int32; out (n, 9) f32.
extern "C" int sorted_segment_sum(const void* rows, const void* offsets, int n,
                                  void* out, void* stream) {
  return launch(rows, nullptr, offsets, n, out, stream);
}

// rows (m, 9) f32 in pair-list order; order (m,) int64, a permutation of
// [0, m): pair-list row i holds Gaussian-major position order[i]; inv (m,)
// int32 scratch, overwritten with the inverse of order; offsets (n + 1,)
// int32 over Gaussian-major positions; out (n, 9) f32.
extern "C" int gathered_segment_sum(const void* rows, const void* order, int m,
                                    void* inv, const void* offsets, int n,
                                    void* out, void* stream) {
  if (m > 0) {
    segsum_invert_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(order), m, static_cast<int*>(inv));
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return launch(rows, inv, offsets, n, out, stream);
}
