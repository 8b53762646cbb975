// sorted_segment_sum: per-Gaussian sums of gid-sorted gradient rows, for
// Hopper (sm_90a).
//
// Replaces: pcp_tpu/ops/segsum_pallas.py `sorted_segment_sum` -> `_kernel`
// (the pl.pallas_call at segsum_pallas.py:164; body :43-119). The TPU kernel
// reduces each block of 256 gids with one-hot matmuls on the MXU; here one
// thread owns one (Gaussian, plane) output: it reads its Gaussian's range
// [offsets[g], offsets[g + 1]) of the gid-sorted rows and sums that range in
// fp32, in order. Rows past offsets[n] (gid >= n) belong to no output and
// are never read. No atomics: the result is the same on every run and
// equals a sequential scatter-add in row order.
//
// What bounds it: bytes. Each of the M input rows (36 B) is read once, the
// n + 1 offsets once, and each of the n x 9 outputs written once; the adds
// are one per input value. What the design does about it: the 9 threads of
// a Gaussian are neighbours, so a row's 36 B are read by one warp in one
// transaction, and neighbouring Gaussians read neighbouring ranges. A
// skewed segment simply makes its 9 threads run longer.
//
// Plain C interface for ctypes. The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kNA = 9;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ rows, const int* __restrict__ offsets,
              int n, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * kNA) return;
  const int g = static_cast<int>(t / kNA);
  const int p = static_cast<int>(t - static_cast<long long>(g) * kNA);
  const int lo = offsets[g];
  const int hi = offsets[g + 1];
  float s = 0.0f;
  for (int i = lo; i < hi; ++i) s += rows[static_cast<size_t>(i) * kNA + p];
  out[t] = s;
}

}  // namespace

extern "C" int sorted_segment_sum(const void* rows, const void* offsets, int n,
                                  void* out, void* stream) {
  const long long total = static_cast<long long>(n) * kNA;
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  if (blocks > 0) {
    segsum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows), static_cast<const int*>(offsets), n,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
