// gather_pack: out[t, a, k] = pack[ids[t, k], a], an attribute gather by id
// in three layouts, for Hopper (sm_90a).
//
// Replaces: tools/exp_r2.py `exp_gather` -> `build` (the pl.pallas_call at
// exp_r2.py:80; bodies k1-k3 at :53-76). The TPU kernel gathers from a
// VMEM-resident pack one (TB, CH) block of ids per grid step. Here every id
// is independent, so there is no block schedule to carry over: a thread
// owns an id (or, in the plane form, an id and two planes), consecutive
// threads take consecutive k, so every store of a warp is one coalesced
// 128-B line.
//
//   row   (form2_row_take):  pack (N, NA); the thread reads the id's NA-float
//                            row as NA / 4 float4 loads (64 B at NA = 16),
//                            then writes NA outputs.
//   col   (form1_col_take):  pack (N, NA), the same input as the row form.
//                            On the TPU the two bodies differ in how they
//                            slice VMEM (exp_r2.py:53-68); on this card the
//                            function and the best way to read it are the
//                            same, so col runs the row kernel.
//   plane (form3_lane_take): packT (NA, N); a thread owns an id and a pair
//                            of planes: it reads packT[a * N + id] for both
//                            and writes two outputs. The plane pair is the
//                            slowest index of the grid, so the blocks in
//                            flight read two planes (8 N bytes) at a time:
//                            at N = 2^20 those 8 MB stay in the 50 MB L2,
//                            where one thread per id reading all NA planes
//                            draws the whole 64 MB pack at random from HBM.
//
// What bounds it: bytes. The ids (4 B each) are read once, the output
// (4 * NT * NA * K B) written once, and each distinct pack row (4 * NA B)
// read once; there is no arithmetic. The row and col forms move a row in
// four 16-B loads per id. The plane form cannot do better than one 32-B
// sector per (id, plane): the NA values of an id lie N floats apart. So it
// moves 32 * NT * K * NA bytes, its sector floor, through L2; the byte
// bound does not see that. The grid order keeps that traffic in L2, so the
// pack is read from HBM about once.
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

// plane: kPlanes planes of one id a thread; blockIdx.x / blocks_per_group
// is the plane group.
constexpr int kPlanes = 2;

__global__ void __launch_bounds__(kThreads)
gather_planes_kernel(const float* __restrict__ packT,
                     const int* __restrict__ ids, int n, int na, int k,
                     long long n_ids, int blocks_per_group,
                     float* __restrict__ out) {
  const int group = blockIdx.x / blocks_per_group;
  const long long i =
      static_cast<long long>(blockIdx.x - group * blocks_per_group) * kThreads +
      threadIdx.x;
  if (i >= n_ids) return;
  const int id = ids[i];
  const long long t = i / k;
  const long long kk = i - t * k;
  const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(n);
  const int a0 = group * kPlanes;
  const float* src = packT + (ok ? id : 0);
  float* dst = out + t * na * k + kk;
  float v[kPlanes];
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    v[q] = NAN;
    if (ok && a0 + q < na) v[q] = src[static_cast<long long>(a0 + q) * n];
  }
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) {
    if (a0 + q < na) dst[static_cast<long long>(a0 + q) * k] = v[q];
  }
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

// pack (n, na) f32 with na % 4 == 0 and 16-B alignment; ids (nt, k) int32;
// out (nt, na, k) f32. The row kernel: see the note at the top.
extern "C" int gather_pack_col(const void* pack, const void* ids, int n,
                               int na, int nt, int k, void* out,
                               void* stream) {
  return gather_pack_row(pack, ids, n, na, nt, k, out, stream);
}

// packT (na, n) f32; ids (nt, k) int32; out (nt, na, k) f32.
extern "C" int gather_pack_plane(const void* packT, const void* ids, int n,
                                 int na, int nt, int k, void* out,
                                 void* stream) {
  const long long n_ids = static_cast<long long>(nt) * k;
  const int groups = (na + kPlanes - 1) / kPlanes;
  if (n_ids > 0 && groups > 0) {
    const int per_group = blocks_for(n_ids);
    gather_planes_kernel<<<per_group * groups, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(packT), static_cast<const int*>(ids), n,
        na, k, n_ids, per_group, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
