// gather_pack: out[t, a, k] = pack[ids[t, k], a], an attribute gather by id
// in three layouts, for Hopper (sm_90a).
//
// Replaces: tools/exp_r2.py `exp_gather` -> `build` (the pl.pallas_call at
// exp_r2.py:80; bodies k1-k3 at :53-76). The TPU kernel gathers from a
// VMEM-resident pack one (TB, CH) block of ids per grid step. Here every
// output element is independent, so there is no block schedule to carry
// over: threads walk the (NT, NA, K) output directly, consecutive threads on
// consecutive k, so every store of a warp is one coalesced 128-B line.
//
//   row   (form2_row_take):  pack (N, NA); a thread owns one id and reads its
//                            NA-float row as NA / 4 float4 loads (64 B at
//                            NA = 16), then writes NA outputs.
//   col   (form1_col_take):  pack (N, NA); a thread owns one output and does
//                            one scalar load pack[id * NA + a].
//   plane (form3_lane_take): packT (NA, N); a thread owns one output and
//                            does one scalar load packT[a * N + id].
//
// What bounds it: bytes. The ids (4 B each) are read once, the output
// (4 * NT * NA * K B) written once, and each distinct pack row (4 * NA B)
// read once; there is no arithmetic. The row form moves a row in four
// 16-B loads per id; the col and plane forms make NA scalar loads per id
// whose sectors the other attributes' threads may or may not find in L1/L2.
// The three forms measure what row-major, strided-column and plane-major
// gathers cost on this card's L2 and HBM: the composite kernels gather one
// 36-B row per pair by id in the same way.
//
// An id outside [0, N) reads nothing and gives NaN, as jnp.take's fill
// mode does. Plain C interface for ctypes; each function launches on the
// caller's stream, allocates nothing, does not synchronise and returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float4* __restrict__ pack, const int* __restrict__ ids,
                   int n, int na4, int k, long long n_ids,
                   float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_ids) return;
  const int id = ids[i];
  const long long t = i / k;
  const long long kk = i - t * k;
  const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(n);
  float* dst = out + t * (4LL * na4) * k + kk;
  for (int q = 0; q < na4; ++q) {
    const float4 v = ok ? pack[static_cast<long long>(id) * na4 + q]
                        : make_float4(NAN, NAN, NAN, NAN);
    dst[(4LL * q + 0) * k] = v.x;
    dst[(4LL * q + 1) * k] = v.y;
    dst[(4LL * q + 2) * k] = v.z;
    dst[(4LL * q + 3) * k] = v.w;
  }
}

// col and plane: source element of (id, a) at id * stride_id + a * stride_a.
__global__ void __launch_bounds__(kThreads)
gather_strided_kernel(const float* __restrict__ src, const int* __restrict__ ids,
                      int n, int na, int k, long long stride_id,
                      long long stride_a, long long n_out,
                      float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const long long ta = i / k;          // t * na + a
  const long long kk = i - ta * k;
  const long long t = ta / na;
  const long long a = ta - t * na;
  const int id = ids[t * k + kk];
  out[i] = static_cast<unsigned>(id) < static_cast<unsigned>(n)
               ? src[id * stride_id + a * stride_a]
               : NAN;
}

int blocks_for(long long count) {
  return static_cast<int>((count + kThreads - 1) / kThreads);
}

}  // namespace

// pack (n, na) f32 with na % 4 == 0 and 16-B alignment; ids (nt, k) int32;
// out (nt, na, k) f32.
extern "C" int gather_pack_row(const void* pack, const void* ids, int n,
                               int na, int nt, int k, void* out,
                               void* stream) {
  const long long n_ids = static_cast<long long>(nt) * k;
  if (n_ids > 0) {
    gather_rows_kernel<<<blocks_for(n_ids), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(pack), static_cast<const int*>(ids), n,
        na / 4, k, n_ids, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// pack (n, na) f32; ids (nt, k) int32; out (nt, na, k) f32.
extern "C" int gather_pack_col(const void* pack, const void* ids, int n,
                               int na, int nt, int k, void* out,
                               void* stream) {
  const long long n_out = static_cast<long long>(nt) * na * k;
  if (n_out > 0) {
    gather_strided_kernel<<<blocks_for(n_out), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pack), static_cast<const int*>(ids), n, na,
        k, na, 1, n_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// packT (na, n) f32; ids (nt, k) int32; out (nt, na, k) f32.
extern "C" int gather_pack_plane(const void* packT, const void* ids, int n,
                                 int na, int nt, int k, void* out,
                                 void* stream) {
  const long long n_out = static_cast<long long>(nt) * na * k;
  if (n_out > 0) {
    gather_strided_kernel<<<blocks_for(n_out), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packT), static_cast<const int*>(ids), n,
        na, k, 1, n, n_out, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
