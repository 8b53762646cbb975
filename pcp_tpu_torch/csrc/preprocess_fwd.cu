// preprocess_fwd: a view's per-Gaussian preprocess, from the model's stored
// parameters to the rows the binning and the blend (B1) read, in one pass
// over device memory, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. On the TPU, XLA fused the same chain
// (pcp_tpu/ops/projection.py `preprocess` with the activation and the SH
// concatenation before it) into a few passes; run eagerly in PyTorch it is
// dozens of launches over every slot, each reading and writing full
// temporaries. This kernel is the render path's forward only: the training
// step keeps the autograd path (ops/projection.py).
//
// Per Gaussian slot it reads, in place:
//   xyz (N, 3); scaling (N, 3) log-scales, exp() * scaling_modifier here;
//   rotation (N, 4) unnormalised [w, x, y, z]; opacity (N, 1) logits,
//   sigmoid() * alive here; alive (N,) bool; f_dc (N, 3); f_rest (N, R, 3)
// and writes once:
//   pack (N, 9) [mx, my, conic a, b, c, r, g, b, opacity] (the blend's row,
//   ops/composite.pack_attributes), depths (N,), rect (N, 4) int32 tile
//   bounds [x0, y0, x1, y1), radii (N,), visible (N,) bool.
// The arithmetic is the plain version's fp32 operations in its order
// (G.opacity_act, G.scaling_act, utils/general.quat_to_rotmat,
// ops/projection.preprocess with its tight alpha >= 1/255 rect,
// utils/sh.eval_sh_color); the build's --fmad=false keeps every
// multiply-add two roundings, as the plain version's separate launches are,
// and the two norms sum their squares in the order torch.linalg.norm's
// reduction takes on the card (held bit for bit by the card tests).
// Python's double constants are rounded to float as PyTorch rounds a scalar
// operand (static_cast<float> of the double).
//
// What bounds it: bytes. At SH 3 a Gaussian reads 59 floats and a byte
// (237 B) and writes 15 words and a byte (61 B), for ~100 fp32 operations:
// far below the card's ~20 operations a byte. The rows are arrays of
// structures: f_rest is 45 floats (180 B) a Gaussian, so one thread per
// Gaussian loading its own row would make 45 scattered loads. Instead each
// block stages a chunk of kChunk Gaussians' rows of every strided input into
// shared memory with 16-byte cp.async copies (consecutive threads on
// consecutive 16-byte pieces), and each thread then reads its own row there:
// the strides (3, 45 words) are odd, so a warp's reads hit 32 banks; the
// quaternion is read as one float4. The opacity and alive flag, one word and
// one byte a Gaussian, are read straight into registers one chunk ahead. The
// pack rows (9 words) leave through shared memory as 16-byte stores; rect is
// one int4 a thread. A grid of a few persistent blocks per SM walks the
// chunks with two stages in flight: the next chunk's copies are started
// before the current chunk's arithmetic.
//
// Plain C interface for ctypes; launches on the caller's stream, allocates
// nothing, does not synchronise, returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;       // Gaussians a chunk, one a thread
constexpr int kThreads = kChunk;
constexpr int kPack = 9;
constexpr int kTile = 16;

// ops/projection.py and utils/sh.py constants, rounded as PyTorch rounds a
// Python float operand of a float32 tensor.
#define F32(x) static_cast<float>(x)
__constant__ float kSh[16] = {
    F32(0.28209479177387814),                       // C0
    F32(0.4886025119029199),                        // C1
    F32(1.0925484305920792), F32(-1.0925484305920792),
    F32(0.31539156525252005), F32(-1.0925484305920792),
    F32(0.5462742152960396),                        // C2[0..4]
    F32(-0.5900435899266435), F32(2.890611442640554),
    F32(-0.4570457994644658), F32(0.3731763325901154),
    F32(-0.4570457994644658), F32(1.445305721320277),
    F32(-0.5900435899266435),                       // C3[0..6]
    0.f, 0.f};

// torch.clamp_min / clamp_max / maximum / minimum: a NaN operand wins.
__device__ __forceinline__ float max_nan(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float min_nan(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  if (x != x || lo != lo || hi != hi) return __int_as_float(0x7fffffff);
  return fminf(fmaxf(x, lo), hi);
}
// projection._tile_index: clamp into [0, n], then truncate toward zero (a
// NaN truncates to 0, as the device's conversion gives it).
__device__ __forceinline__ int tile_index(float x, int n) {
  const float c = x != x ? x : fminf(fmaxf(x, 0.0f), static_cast<float>(n));
  return __float2int_rz(c);
}

// Gaussians of the chunk that starts at g0.
__host__ __device__ __forceinline__ int chunk_count(long long n,
                                                    long long g0) {
  return n - g0 < kChunk ? static_cast<int>(n - g0) : kChunk;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block copies `count` floats from src to dst (shared memory, 16-byte
// aligned): 16-byte pieces where src is 16-byte aligned, the rest by word.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int count) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < count; i += kThreads)
    cp_async4(dst + i, src + i);
}

struct Args {
  const float* xyz;
  const float* scaling;
  const float* rotation;
  const float* opacity;
  const unsigned char* alive;
  const float* f_dc;
  const float* f_rest;
  const float* viewmat;   // (4, 4) row-major, world to camera
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  long long n;
  int rest;               // R, f_rest rows a Gaussian
  int stage_rest;         // rows staged: R where sh_degree > 0, else 0
  int width, height, sh_degree;
  float scaling_modifier;
  int has_tan;
  float tanx, tany;
  float* pack;
  float* depths;
  int* rect;
  float* radii;
  unsigned char* visible;
};

// Shared-memory layout of one stage, in floats: rotation first (float4
// reads), then xyz, scaling, f_dc, f_rest; every part a multiple of 4.
struct Layout {
  int rot, xyz, scl, dc, rest, stage_floats;
  __host__ __device__ explicit Layout(int stage_rest) {
    rot = 0;
    xyz = rot + 4 * kChunk;
    scl = xyz + 3 * kChunk;
    dc = scl + 3 * kChunk;
    rest = dc + 3 * kChunk;
    stage_floats = rest + 3 * stage_rest * kChunk;
  }
};

__device__ __forceinline__ void load_chunk(const Args& a, const Layout& L,
                                           float* st, long long g0,
                                           int count) {
  stage(st + L.rot, a.rotation + 4 * g0, 4 * count);
  stage(st + L.xyz, a.xyz + 3 * g0, 3 * count);
  stage(st + L.scl, a.scaling + 3 * g0, 3 * count);
  stage(st + L.dc, a.f_dc + 3 * g0, 3 * count);
  if (a.stage_rest > 0)
    stage(st + L.rest, a.f_rest + 3LL * a.rest * g0, 3 * a.rest * count);
}

__global__ void __launch_bounds__(kThreads)
preprocess_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(a.stage_rest);
  float* out_rows = smem + 2 * L.stage_floats;   // kChunk * kPack

  const long long n_chunks = (a.n + kChunk - 1) / kChunk;
  const int t = threadIdx.x;

  // The view, the same for every Gaussian.
  float r[3][3], tr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) r[i][k] = __ldg(a.viewmat + 4 * i + k);
    tr[i] = __ldg(a.viewmat + 4 * i + 3);
  }
  const float fx = __ldg(a.fx), fy = __ldg(a.fy);
  const float cx = __ldg(a.cx), cy = __ldg(a.cy);
  const int w = a.width, h = a.height;
  // tan_fov default: 0.5 * w / fx, which PyTorch takes as reciprocal(fx) *
  // (0.5 * w) (Tensor.__rtruediv__)
  const float tanx = a.has_tan ? a.tanx : (1.0f / fx) * F32(0.5 * w);
  const float tany = a.has_tan ? a.tany : (1.0f / fy) * F32(0.5 * h);
  const float lim_x = tanx * F32(1.3);
  const float lim_y = tany * F32(1.3);
  float campos[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    campos[j] = -(r[0][j] * tr[0] + r[1][j] * tr[1] + r[2][j] * tr[2]);
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles_y = (h + kTile - 1) / kTile;
  const int deg = a.sh_degree;
  const float smod = a.scaling_modifier;

  long long chunk = blockIdx.x;
  float op_next = 0.0f;
  unsigned char alive_next = 0;
  if (chunk < n_chunks) {
    const long long g0 = chunk * kChunk;
    load_chunk(a, L, smem, g0, chunk_count(a.n, g0));
    if (g0 + t < a.n) {
      op_next = __ldg(a.opacity + g0 + t);
      alive_next = __ldg(a.alive + g0 + t);
    }
  }
  cp_async_commit();

  for (int it = 0; chunk < n_chunks; chunk += gridDim.x, ++it) {
    const long long g0 = chunk * kChunk;
    const int count = chunk_count(a.n, g0);
    const float op_logit = op_next;
    const unsigned char alive = alive_next;
    const long long next = chunk + gridDim.x;
    if (next < n_chunks) {
      const long long n0 = next * kChunk;
      load_chunk(a, L, smem + ((it + 1) & 1) * L.stage_floats, n0,
                 chunk_count(a.n, n0));
      if (n0 + t < a.n) {
        op_next = __ldg(a.opacity + n0 + t);
        alive_next = __ldg(a.alive + n0 + t);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* st = smem + (it & 1) * L.stage_floats;
    if (t < count) {
      const long long g = g0 + t;
      // activation (G.opacity_act * alive, G.scaling_act * modifier)
      const float op = (1.0f / (1.0f + expf(-op_logit))) *
                       (alive ? 1.0f : 0.0f);
      const float* xs = st + L.xyz + 3 * t;
      const float* ss = st + L.scl + 3 * t;
      const float x0 = xs[0], x1 = xs[1], x2 = xs[2];
      const float sk[3] = {expf(ss[0]) * smod, expf(ss[1]) * smod,
                           expf(ss[2]) * smod};

      // camera space, projection
      float pv[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        pv[i] = r[i][0] * x0 + r[i][1] * x1 + r[i][2] * x2 + tr[i];
      const float z = pv[2];
      const bool in_front = z > F32(0.2);
      const float zinv = 1.0f / (in_front ? z : 1.0f);
      const float mx = pv[0] * zinv * fx + cx;
      const float my = pv[1] * zinv * fy + cy;

      // EWA: M = T R(q) diag(s), T the Jacobian times the view rotation
      const float tx = clip_nan(pv[0] * zinv, -lim_x, lim_x) * z;
      const float ty = clip_nan(pv[1] * zinv, -lim_y, lim_y) * z;
      const float j00 = fx / z;
      const float j02 = -fx * tx / (z * z);
      const float j11 = fy / z;
      const float j12 = -fy * ty / (z * z);
      float T0[3], T1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T0[k] = j00 * r[0][k] + j02 * r[2][k];
        T1[k] = j11 * r[1][k] + j12 * r[2][k];
      }
      const float4 q = *reinterpret_cast<const float4*>(st + L.rot + 4 * t);
      // torch.linalg.norm's order over 4 values: (q0^2 + q2^2) + (q1^2 +
      // q3^2), a warp reduction's pairs
      const float qn =
          sqrtf((q.x * q.x + q.z * q.z) + (q.y * q.y + q.w * q.w)) +
          F32(1e-12);
      const float qw = q.x / qn, qx = q.y / qn, qy = q.z / qn, qz = q.w / qn;
      float R[3][3];
      R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
      R[0][1] = 2.0f * (qx * qy - qw * qz);
      R[0][2] = 2.0f * (qx * qz + qw * qy);
      R[1][0] = 2.0f * (qx * qy + qw * qz);
      R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
      R[1][2] = 2.0f * (qy * qz - qw * qx);
      R[2][0] = 2.0f * (qx * qz - qw * qy);
      R[2][1] = 2.0f * (qy * qz + qw * qx);
      R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);
      float M0[3], M1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        M0[k] = sk[k] * (T0[0] * R[0][k] + T0[1] * R[1][k] + T0[2] * R[2][k]);
        M1[k] = sk[k] * (T1[0] * R[0][k] + T1[1] * R[1][k] + T1[2] * R[2][k]);
      }
      const float ca = M0[0] * M0[0] + M0[1] * M0[1] + M0[2] * M0[2] + F32(0.3);
      const float cc = M1[0] * M1[0] + M1[1] * M1[1] + M1[2] * M1[2] + F32(0.3);
      const float cb = M0[0] * M1[0] + M0[1] * M1[1] + M0[2] * M1[2];
      const float det = ca * cc - cb * cb;
      const bool det_ok = det > 0.0f;
      const float det_safe = det_ok ? det : 1.0f;
      const float mid = 0.5f * (ca + cc);
      const float lam1 = mid + sqrtf(max_nan(mid * mid - det, F32(0.1)));
      const float radius = ceilf(3.0f * sqrtf(lam1));

      // SH -> clamped RGB (eval_sh_color), view direction from the camera
      float d[3];
      d[0] = x0 - campos[0];
      d[1] = x1 - campos[1];
      d[2] = x2 - campos[2];
      // torch.linalg.norm's order over 3 values: (d0^2 + d2^2) + d1^2
      const float dn = max_nan(sqrtf((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1]),
                               F32(1e-12));
      const float dx = d[0] / dn, dy = d[1] / dn, dz = d[2] / dn;
      const float* dc = st + L.dc + 3 * t;
      // SH coefficient k >= 1 of this Gaussian at rs[3 (k - 1)]
      const float* rs = st + L.rest + 3 * a.rest * t;
      float rgb[3];
      {
        float res[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) res[ch] = kSh[0] * dc[ch];
        if (deg >= 1) {
          const float f1 = kSh[1] * dy, f2 = kSh[1] * dz, f3 = kSh[1] * dx;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            res[ch] = res[ch] - f1 * rs[0 + ch] + f2 * rs[3 + ch] -
                      f3 * rs[6 + ch];
          if (deg >= 2) {
            const float xx = dx * dx, yy = dy * dy, zz = dz * dz;
            const float xy = dx * dy, yz = dy * dz, xz = dx * dz;
            const float f4 = kSh[2] * xy, f5 = kSh[3] * yz;
            const float f6 = kSh[4] * (2.0f * zz - xx - yy);
            const float f7 = kSh[5] * xz, f8 = kSh[6] * (xx - yy);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              res[ch] = res[ch] + f4 * rs[9 + ch] + f5 * rs[12 + ch] +
                        f6 * rs[15 + ch] + f7 * rs[18 + ch] + f8 * rs[21 + ch];
            if (deg >= 3) {
              const float f9 = kSh[7] * dy * (3.0f * xx - yy);
              const float f10 = kSh[8] * xy * dz;
              const float f11 = kSh[9] * dy * (4.0f * zz - xx - yy);
              const float f12 =
                  kSh[10] * dz * (2.0f * zz - 3.0f * xx - 3.0f * yy);
              const float f13 = kSh[11] * dx * (4.0f * zz - xx - yy);
              const float f14 = kSh[12] * dz * (xx - yy);
              const float f15 = kSh[13] * dx * (xx - 3.0f * yy);
#pragma unroll
              for (int ch = 0; ch < 3; ++ch)
                res[ch] = res[ch] + f9 * rs[24 + ch] + f10 * rs[27 + ch] +
                          f11 * rs[30 + ch] + f12 * rs[33 + ch] +
                          f13 * rs[36 + ch] + f14 * rs[39 + ch] +
                          f15 * rs[42 + ch];
            }
          }
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = max_nan(res[ch] + 0.5f, 0.0f);
      }

      // tile rect: the box of the alpha >= 1/255 ellipse
      const float q_cap = min_nan(
          2.0f * logf(max_nan(255.0f * op, F32(1.0 + 1e-6))), 9.0f);
      const float rx = sqrtf(q_cap * ca) + 0.5f;
      const float ry = sqrtf(q_cap * cc) + 0.5f;
      const float inv_tile = 1.0f / kTile;   // exact: PyTorch's x / 16
      const int rx0 = tile_index((mx - rx) * inv_tile, tiles_x);
      const int ry0 = tile_index((my - ry) * inv_tile, tiles_y);
      const int rx1 = tile_index((mx + rx + 16.0f - 1.0f) * inv_tile, tiles_x);
      const int ry1 = tile_index((my + ry + 16.0f - 1.0f) * inv_tile, tiles_y);
      const bool vis = in_front && det_ok &&
                       ((rx1 - rx0) * (ry1 - ry0) > 0) &&
                       (op > F32(1.0 / 255.0));

      float* row = out_rows + kPack * t;
      row[0] = mx;
      row[1] = my;
      row[2] = cc / det_safe;
      row[3] = -cb / det_safe;
      row[4] = ca / det_safe;
      row[5] = rgb[0];
      row[6] = rgb[1];
      row[7] = rgb[2];
      row[8] = vis ? op : 0.0f;
      a.depths[g] = z;
      a.radii[g] = vis ? radius : 0.0f;
      a.visible[g] = vis ? 1 : 0;
      reinterpret_cast<int4*>(a.rect)[g] =
          vis ? make_int4(rx0, ry0, rx1, ry1) : make_int4(0, 0, 0, 0);
    }
    __syncthreads();   // every thread's row is in out_rows, stage it & 1 read

    // the chunk's pack rows: count * 9 floats from a 16-byte aligned start
    float* dst = a.pack + kPack * g0;
    const int total = kPack * count;
    const int n4 = total >> 2;
    for (int i = t; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(out_rows)[i];
    for (int i = 4 * n4 + t; i < total; i += kThreads) dst[i] = out_rows[i];
  }
  cp_async_wait<0>();
}

}  // namespace

// xyz, scaling, f_dc (n, 3), rotation (n, 4), opacity (n, 1), f_rest
// (n, rest, 3) f32 and alive (n,) bool, contiguous; viewmat (4, 4) f32 and
// fx, fy, cx, cy f32 scalars on the card; tan_fov (tanx, tany) where has_tan,
// else 0.5 * size / focal. pack (n, 9) f32 and rect (n, 4) int32, both
// 16-byte aligned; depths, radii (n,) f32; visible (n,) bool.
extern "C" int preprocess_fwd(
    const void* xyz, const void* scaling, const void* rotation,
    const void* opacity, const void* alive, const void* f_dc,
    const void* f_rest, int rest, const void* viewmat, const void* fx,
    const void* fy, const void* cx, const void* cy, long long n, int width,
    int height, int sh_degree, float scaling_modifier, int has_tan,
    float tanx, float tany, void* pack, void* depths, void* rect, void* radii,
    void* visible, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.xyz = static_cast<const float*>(xyz);
  a.scaling = static_cast<const float*>(scaling);
  a.rotation = static_cast<const float*>(rotation);
  a.opacity = static_cast<const float*>(opacity);
  a.alive = static_cast<const unsigned char*>(alive);
  a.f_dc = static_cast<const float*>(f_dc);
  a.f_rest = static_cast<const float*>(f_rest);
  a.viewmat = static_cast<const float*>(viewmat);
  a.fx = static_cast<const float*>(fx);
  a.fy = static_cast<const float*>(fy);
  a.cx = static_cast<const float*>(cx);
  a.cy = static_cast<const float*>(cy);
  a.n = n;
  a.rest = rest;
  a.stage_rest = sh_degree > 0 ? rest : 0;
  a.width = width;
  a.height = height;
  a.sh_degree = sh_degree;
  a.scaling_modifier = scaling_modifier;
  a.has_tan = has_tan;
  a.tanx = tanx;
  a.tany = tany;
  a.pack = static_cast<float*>(pack);
  a.depths = static_cast<float*>(depths);
  a.rect = static_cast<int*>(rect);
  a.radii = static_cast<float*>(radii);
  a.visible = static_cast<unsigned char*>(visible);

  const Layout L(a.stage_rest);
  const int smem_bytes =
      static_cast<int>(sizeof(float)) * (2 * L.stage_floats + kChunk * kPack);
  cudaError_t err = cudaFuncSetAttribute(
      preprocess_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, preprocess_fwd_kernel,
                                                kThreads, smem_bytes);
  if (per_sm < 1) per_sm = 1;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(n_chunks < slots ? n_chunks : slots);
  preprocess_fwd_kernel<<<grid, kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
