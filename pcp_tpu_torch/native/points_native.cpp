// Native point-cloud ops for the partition pipeline.
//
// radius_outlier_filter: exact open3d remove_radius_outlier semantics
// (keep points with >= nb neighbours within r, self excluded) — replaces
// the reference's open3d call (shen_partition_utils.py:28-55). The
// partition host has a single CPU core, so numpy formulations cost
// ~45 s at 5M points and accelerator offload pays ~1 min of remote
// compile per grid shape; this grid-hash + early-exit scan runs the same
// filter in a couple of seconds.
//
// Algorithm: quantize to cells of side r, sort point indices by cell id
// (one std::sort), then for each point scan its 27-cell neighbourhood with
// exact distance tests, stopping as soon as nb neighbours are found.
//
// ctypes ABI: all buffers caller-allocated numpy arrays.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct CellKey {
  int64_t id;
  int32_t idx;
  bool operator<(const CellKey& o) const { return id < o.id; }
};

}  // namespace

extern "C" {

// points: (n, 3) float32; keep: (n,) uint8 out. Returns 0 on success.
int radius_outlier_filter(const float* points, int64_t n, int32_t nb,
                          float radius, uint8_t* keep) {
  if (n <= 0) return 0;
  const double r = radius;
  const double r2 = r * r;

  // quantize
  double mn[3] = {points[0], points[1], points[2]};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d)
      mn[d] = std::min(mn[d], (double)points[3 * i + d]);

  std::vector<int32_t> q(3 * n);
  int64_t dims[3] = {1, 1, 1};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      int64_t c = (int64_t)std::floor((points[3 * i + d] - mn[d]) / r);
      q[3 * i + d] = (int32_t)c;
      dims[d] = std::max(dims[d], c + 1);
    }
  const int64_t sy = dims[2];
  const int64_t sx = dims[1] * dims[2];

  std::vector<CellKey> order(n);
  for (int64_t i = 0; i < n; ++i) {
    order[i].id = q[3 * i] * sx + q[3 * i + 1] * sy + q[3 * i + 2];
    order[i].idx = (int32_t)i;
  }
  std::sort(order.begin(), order.end());

  // segment starts per unique cell (ids sorted): binary search later
  std::vector<int64_t> uniq;
  std::vector<int64_t> start;
  uniq.reserve(n / 4);
  start.reserve(n / 4 + 1);
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || order[i].id != order[i - 1].id) {
      uniq.push_back(order[i].id);
      start.push_back(i);
    }
  }
  start.push_back(n);
  const int64_t ncells = (int64_t)uniq.size();

  for (int64_t ci = 0; ci < ncells; ++ci) {
    const int64_t cell = uniq[ci];
    const int64_t cz = cell % dims[2];
    const int64_t cy = (cell / dims[2]) % dims[1];
    const int64_t cx = cell / sx;

    // candidate segments: own cell FIRST (densest, so the early-exit
    // usually never leaves it), then the rest of the 27-neighbourhood
    int64_t seg_lo[27], seg_hi[27];
    int nseg = 0;
    seg_lo[nseg] = start[ci];
    seg_hi[nseg] = start[ci + 1];
    ++nseg;
    for (int ox = -1; ox <= 1; ++ox) {
      const int64_t x = cx + ox;
      if (x < 0 || x >= dims[0]) continue;
      for (int oy = -1; oy <= 1; ++oy) {
        const int64_t y = cy + oy;
        if (y < 0 || y >= dims[1]) continue;
        for (int oz = -1; oz <= 1; ++oz) {
          if (ox == 0 && oy == 0 && oz == 0) continue;
          const int64_t z = cz + oz;
          if (z < 0 || z >= dims[2]) continue;
          const int64_t id = x * sx + y * sy + z;
          auto it = std::lower_bound(uniq.begin(), uniq.end(), id);
          if (it != uniq.end() && *it == id) {
            const int64_t k = it - uniq.begin();
            seg_lo[nseg] = start[k];
            seg_hi[nseg] = start[k + 1];
            ++nseg;
          }
        }
      }
    }

    for (int64_t s = start[ci]; s < start[ci + 1]; ++s) {
      const int32_t i = order[s].idx;
      const float px = points[3 * i], py = points[3 * i + 1],
                  pz = points[3 * i + 2];
      int32_t cnt = -1;  // self will be counted once
      for (int g = 0; g < nseg && cnt < nb; ++g) {
        for (int64_t t = seg_lo[g]; t < seg_hi[g]; ++t) {
          const int32_t j = order[t].idx;
          const double dx = (double)points[3 * j] - px;
          const double dy = (double)points[3 * j + 1] - py;
          const double dz = (double)points[3 * j + 2] - pz;
          if (dx * dx + dy * dy + dz * dz <= r2) {
            if (++cnt >= nb) break;
          }
        }
      }
      keep[i] = cnt >= nb ? 1 : 0;
    }
  }
  return 0;
}

// Compact points by a keep mask: out (n_kept, 3), idx_out original indices.
// Returns the kept count.
int64_t compact_points(const float* points, const uint8_t* keep, int64_t n,
                       float* out, int64_t* idx_out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (keep[i]) {
      out[3 * m] = points[3 * i];
      out[3 * m + 1] = points[3 * i + 1];
      out[3 * m + 2] = points[3 * i + 2];
      idx_out[m] = i;
      ++m;
    }
  }
  return m;
}

// Balanced binary bisection on XY (density_partition.py:9-99 semantics):
// split along the longer axis at the median point while count > 1.2 *
// threshold and depth < max_depth. Outputs, per point, the leaf's index;
// per leaf: its id path (bit k of path = k-th split side), depth, and
// bounds. Returns the number of leaves (<= max_leaves) or -1 on overflow.
int bisect_xy(const float* xy, int64_t n, int64_t threshold, int max_depth,
              int64_t* order_out,        // (n,) point indices grouped by leaf
              int64_t* leaf_lo,          // (max_leaves,) segment starts
              uint32_t* leaf_path,       // (max_leaves,)
              int32_t* leaf_depth,       // (max_leaves,)
              float* leaf_bounds,        // (max_leaves, 4) xmin ymin xmax ymax
              int max_leaves) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  int n_leaves = 0;

  struct Task {
    int64_t lo, hi;
    uint32_t path;
    int depth;
    float b[4];
  };
  std::vector<Task> stack;
  float bx0 = xy[0], by0 = xy[1], bx1 = xy[0], by1 = xy[1];
  for (int64_t i = 0; i < n; ++i) {
    bx0 = std::min(bx0, xy[2 * i]);
    bx1 = std::max(bx1, xy[2 * i]);
    by0 = std::min(by0, xy[2 * i + 1]);
    by1 = std::max(by1, xy[2 * i + 1]);
  }
  stack.push_back({0, n, 0u, 0, {bx0, by0, bx1, by1}});

  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    const int64_t cnt = t.hi - t.lo;
    const bool split = cnt > (int64_t)(threshold * 1.2) && t.depth < max_depth;
    if (!split) {
      if (n_leaves >= max_leaves) return -1;
      leaf_lo[n_leaves] = t.lo;
      leaf_path[n_leaves] = t.path;
      leaf_depth[n_leaves] = t.depth;
      for (int d = 0; d < 4; ++d) leaf_bounds[4 * n_leaves + d] = t.b[d];
      ++n_leaves;
      continue;
    }
    const int axis = (t.b[2] - t.b[0] >= t.b[3] - t.b[1]) ? 0 : 1;
    const int64_t mid = t.lo + cnt / 2;
    std::nth_element(
        idx.begin() + t.lo, idx.begin() + mid, idx.begin() + t.hi,
        [&](int64_t a, int64_t b) {
          return xy[2 * a + axis] < xy[2 * b + axis];
        });
    const float cut = xy[2 * idx[mid] + axis];
    Task left = t, right = t;
    left.hi = mid;
    right.lo = mid;
    left.depth = right.depth = t.depth + 1;
    left.path = t.path;                       // "...0"
    right.path = t.path | (1u << t.depth);    // "...1"
    left.b[2 + axis] = cut;
    right.b[0 + axis] = cut;
    // push right first so leaves come out in "0 before 1" order
    stack.push_back(right);
    stack.push_back(left);
  }
  std::copy(idx.begin(), idx.end(), order_out);
  return n_leaves;
}

}  // extern "C"
