// Binned-SAH BVH builder (native host component).
//
// The reference engine offloads acceleration-structure builds to Metal's
// opaque native API (Game/RTAccelerationBuilder.swift); this is the
// engine's equivalent host-side native piece: a C++ binned surface-area-
// heuristic builder emitting the engine's preorder + skip-link topology
// (see swift_game_engine_tpu/render/bvh.py for the array contract).
// Exposed to Python via ctypes (no pybind11 in this image).
//
// Build: see native/build.sh  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
  float mn[3] = {1e30f, 1e30f, 1e30f};
  float mx[3] = {-1e30f, -1e30f, -1e30f};
  void grow(const float* lo, const float* hi) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], lo[k]);
      mx[k] = std::max(mx[k], hi[k]);
    }
  }
  void grow(const AABB& o) { grow(o.mn, o.mx); }
  float half_area() const {
    float dx = std::max(mx[0] - mn[0], 0.f);
    float dy = std::max(mx[1] - mn[1], 0.f);
    float dz = std::max(mx[2] - mn[2], 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* tri_min;
  const float* tri_max;
  std::vector<float> centroid;
  std::vector<int64_t> order;
  int leaf_size;
  static constexpr int kBins = 16;

  // output (preorder)
  std::vector<int32_t> skip, first_tri, tri_count, left, right, parent, depth;

  int emit(int par, int dep, int start, int count, bool is_right) {
    int idx = static_cast<int>(skip.size());
    skip.push_back(-1);
    first_tri.push_back(start);
    tri_count.push_back(0);
    left.push_back(-1);
    right.push_back(-1);
    parent.push_back(par);
    depth.push_back(dep);
    if (par >= 0) {
      if (is_right) right[par] = idx; else left[par] = idx;
    }
    return idx;
  }

  void build(int par, int dep, int start, int count, bool is_right) {
    int idx = emit(par, dep, start, count, is_right);
    if (count <= leaf_size) {
      tri_count[idx] = count;
      return;
    }

    // centroid bounds
    AABB cb;
    for (int i = start; i < start + count; ++i) {
      const float* c = &centroid[order[i] * 3];
      cb.grow(c, c);
    }
    int axis = 0;
    float ext[3] = {cb.mx[0] - cb.mn[0], cb.mx[1] - cb.mn[1], cb.mx[2] - cb.mn[2]};
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] <= 1e-12f) {
      mid = start + count / 2;  // degenerate: halve
    } else {
      // binned SAH along the widest centroid axis
      AABB bin_bounds[kBins];
      int bin_count[kBins] = {0};
      const float k = kBins * (1.0f - 1e-6f) / ext[axis];
      for (int i = start; i < start + count; ++i) {
        int64_t t = order[i];
        int b = static_cast<int>(k * (centroid[t * 3 + axis] - cb.mn[axis]));
        b = std::min(std::max(b, 0), kBins - 1);
        ++bin_count[b];
        bin_bounds[b].grow(&tri_min[t * 3], &tri_max[t * 3]);
      }
      // sweep for best split
      AABB right_acc[kBins];
      AABB acc;
      for (int b = kBins - 1; b >= 1; --b) {
        acc.grow(bin_bounds[b]);
        right_acc[b] = acc;
      }
      AABB left_acc;
      int left_n = 0;
      float best_cost = 1e30f;
      int best_bin = -1;
      for (int b = 1; b < kBins; ++b) {
        left_acc.grow(bin_bounds[b - 1]);
        left_n += bin_count[b - 1];
        int right_n = count - left_n;
        if (left_n == 0 || right_n == 0) continue;
        float cost = left_acc.half_area() * left_n +
                     right_acc[b].half_area() * right_n;
        if (cost < best_cost) {
          best_cost = cost;
          best_bin = b;
        }
      }
      if (best_bin < 0) {
        mid = start + count / 2;
        std::nth_element(order.begin() + start,
                         order.begin() + mid,
                         order.begin() + start + count,
                         [&](int64_t a, int64_t b) {
                           return centroid[a * 3 + axis] < centroid[b * 3 + axis];
                         });
      } else {
        const float split = cb.mn[axis] + best_bin * ext[axis] / kBins;
        auto it = std::partition(order.begin() + start,
                                 order.begin() + start + count,
                                 [&](int64_t t) {
                                   return centroid[t * 3 + axis] < split;
                                 });
        mid = static_cast<int>(it - order.begin());
        if (mid == start || mid == start + count) mid = start + count / 2;
      }
    }

    build(idx, dep + 1, start, mid - start, false);
    build(idx, dep + 1, mid, start + count - mid, true);
  }
};

}  // namespace

extern "C" {

// Returns the node count. Caller passes output buffers sized 2*ceil(T/1)+1
// (2T is a safe upper bound on node count).
int32_t build_bvh_sah(const float* tri_min, const float* tri_max, int64_t t,
                      int32_t leaf_size,
                      int32_t* out_skip, int32_t* out_first, int32_t* out_count,
                      int32_t* out_left, int32_t* out_right,
                      int32_t* out_parent, int32_t* out_depth,
                      int64_t* out_order) {
  Builder b;
  b.tri_min = tri_min;
  b.tri_max = tri_max;
  b.leaf_size = leaf_size;
  b.centroid.resize(t * 3);
  b.order.resize(t);
  for (int64_t i = 0; i < t; ++i) {
    b.order[i] = i;
    for (int k = 0; k < 3; ++k)
      b.centroid[i * 3 + k] = 0.5f * (tri_min[i * 3 + k] + tri_max[i * 3 + k]);
  }
  size_t reserve = static_cast<size_t>(2 * t / std::max(leaf_size / 2, 1) + 64);
  b.skip.reserve(reserve);
  b.build(-1, 0, 0, static_cast<int>(t), false);

  const int m = static_cast<int>(b.skip.size());
  // skip links: skip(left)=right sibling, skip(right)=skip(parent)
  for (int i = 0; i < m; ++i) {
    int p = b.parent[i];
    if (p < 0) b.skip[i] = -1;
    else if (b.left[p] == i) b.skip[i] = b.right[p];
    else b.skip[i] = b.skip[p];
  }
  std::memcpy(out_skip, b.skip.data(), m * 4);
  std::memcpy(out_first, b.first_tri.data(), m * 4);
  std::memcpy(out_count, b.tri_count.data(), m * 4);
  std::memcpy(out_left, b.left.data(), m * 4);
  std::memcpy(out_right, b.right.data(), m * 4);
  std::memcpy(out_parent, b.parent.data(), m * 4);
  std::memcpy(out_depth, b.depth.data(), m * 4);
  std::memcpy(out_order, b.order.data(), t * 8);
  return m;
}

}  // extern "C"
