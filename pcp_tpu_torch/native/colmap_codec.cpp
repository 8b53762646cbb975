// Native COLMAP binary codec.
//
// The reference parses sparse models with per-record Python struct loops
// (scene/colmap_loader.py:195-311) — minutes for multi-million-point
// reconstructions. This C++ codec (ctypes ABI, no deps beyond the C++
// stdlib) parses/serialises points3D.bin and images.bin at memory
// bandwidth; pcp_tpu.io.colmap uses it when built, with a pure-Python
// fallback.
//
// Layout (little-endian, colmap/src/colmap/scene/reconstruction_io.cc):
//   points3D.bin: u64 n; per pt: i64 id, f64 xyz[3], u8 rgb[3], f64 err,
//                 u64 track_len, (i32 image_id, i32 point2D_idx) * track_len
//   images.bin  : u64 n; per img: i32 id, f64 q[4], f64 t[3], i32 cam_id,
//                 name\0, u64 n2d, (f64 x, f64 y, i64 p3d_id) * n2d
//
// Two-pass API: *_count returns array sizes; caller allocates numpy
// buffers; *_parse fills them. All functions return 0 on success,
// negative on malformed input.

#include <cstdint>
#include <cstring>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  template <typename T>
  T read() {
    if (p + sizeof(T) > end) { ok = false; return T{}; }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }
  bool skip(size_t n) {
    if (p + n > end) { ok = false; return false; }
    p += n;
    return true;
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------- points3D

int colmap_points3d_count(const uint8_t* buf, uint64_t len,
                          uint64_t* n_points, uint64_t* total_track) {
  Cursor c{buf, buf + len};
  const uint64_t n = c.read<uint64_t>();
  uint64_t track = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    c.skip(8 + 24 + 3 + 8);  // id, xyz, rgb, error
    const uint64_t t = c.read<uint64_t>();
    track += t;
    c.skip(t * 8);
  }
  if (!c.ok) return -1;
  *n_points = n;
  *total_track = track;
  return 0;
}

int colmap_points3d_parse(const uint8_t* buf, uint64_t len,
                          int64_t* ids, double* xyz, uint8_t* rgb,
                          double* err, uint64_t* track_len,
                          int32_t* track_image_ids, int32_t* track_p2d) {
  Cursor c{buf, buf + len};
  const uint64_t n = c.read<uint64_t>();
  uint64_t toff = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    ids[i] = c.read<int64_t>();
    for (int k = 0; k < 3; ++k) xyz[i * 3 + k] = c.read<double>();
    for (int k = 0; k < 3; ++k) rgb[i * 3 + k] = c.read<uint8_t>();
    err[i] = c.read<double>();
    const uint64_t t = c.read<uint64_t>();
    track_len[i] = t;
    for (uint64_t k = 0; k < t && c.ok; ++k) {
      track_image_ids[toff] = c.read<int32_t>();
      track_p2d[toff] = c.read<int32_t>();
      ++toff;
    }
  }
  return c.ok ? 0 : -1;
}

uint64_t colmap_points3d_size(uint64_t n_points, uint64_t total_track) {
  return 8 + n_points * (8 + 24 + 3 + 8 + 8) + total_track * 8;
}

int colmap_points3d_write(uint8_t* out, uint64_t out_len,
                          uint64_t n_points,
                          const int64_t* ids, const double* xyz,
                          const uint8_t* rgb, const double* err,
                          const uint64_t* track_len,
                          const int32_t* track_image_ids,
                          const int32_t* track_p2d) {
  uint8_t* p = out;
  uint8_t* end = out + out_len;
  auto put = [&](const void* src, size_t n) -> bool {
    if (p + n > end) return false;
    std::memcpy(p, src, n);
    p += n;
    return true;
  };
  if (!put(&n_points, 8)) return -1;
  uint64_t toff = 0;
  for (uint64_t i = 0; i < n_points; ++i) {
    if (!put(&ids[i], 8)) return -1;
    if (!put(&xyz[i * 3], 24)) return -1;
    if (!put(&rgb[i * 3], 3)) return -1;
    if (!put(&err[i], 8)) return -1;
    if (!put(&track_len[i], 8)) return -1;
    for (uint64_t k = 0; k < track_len[i]; ++k, ++toff) {
      if (!put(&track_image_ids[toff], 4)) return -1;
      if (!put(&track_p2d[toff], 4)) return -1;
    }
  }
  return 0;
}

// ------------------------------------------------------------------ images

int colmap_images_count(const uint8_t* buf, uint64_t len,
                        uint64_t* n_images, uint64_t* total_p2d,
                        uint64_t* total_name_bytes) {
  Cursor c{buf, buf + len};
  const uint64_t n = c.read<uint64_t>();
  uint64_t p2d = 0, names = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    c.skip(4 + 32 + 24 + 4);  // id, qvec, tvec, camera_id
    while (c.ok) {            // name: NUL-terminated
      const uint8_t ch = c.read<uint8_t>();
      if (!c.ok || ch == 0) break;
      ++names;
    }
    ++names;                  // count the NUL so offsets are recoverable
    const uint64_t t = c.read<uint64_t>();
    p2d += t;
    c.skip(t * 24);
  }
  if (!c.ok) return -1;
  *n_images = n;
  *total_p2d = p2d;
  *total_name_bytes = names;
  return 0;
}

int colmap_images_parse(const uint8_t* buf, uint64_t len,
                        int32_t* ids, double* qvec, double* tvec,
                        int32_t* camera_ids, uint8_t* names,
                        uint64_t* n2d, double* xys, int64_t* p3d_ids) {
  Cursor c{buf, buf + len};
  const uint64_t n = c.read<uint64_t>();
  uint64_t noff = 0, poff = 0;
  for (uint64_t i = 0; i < n && c.ok; ++i) {
    ids[i] = c.read<int32_t>();
    for (int k = 0; k < 4; ++k) qvec[i * 4 + k] = c.read<double>();
    for (int k = 0; k < 3; ++k) tvec[i * 3 + k] = c.read<double>();
    camera_ids[i] = c.read<int32_t>();
    while (c.ok) {
      const uint8_t ch = c.read<uint8_t>();
      names[noff++] = ch;
      if (!c.ok || ch == 0) break;
    }
    const uint64_t t = c.read<uint64_t>();
    n2d[i] = t;
    for (uint64_t k = 0; k < t && c.ok; ++k, ++poff) {
      xys[poff * 2] = c.read<double>();
      xys[poff * 2 + 1] = c.read<double>();
      p3d_ids[poff] = c.read<int64_t>();
    }
  }
  return c.ok ? 0 : -1;
}

}  // extern "C"
