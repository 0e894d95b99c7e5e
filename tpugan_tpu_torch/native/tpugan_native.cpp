// Native host-side data-loader kernels of the port's input pipeline: its
// own copy of native/tpugan_native.cpp, the JAX package's library (bound
// by tpugan_tpu/data/native.py), with the same four extern "C" entry
// points and the same arithmetic in the same order, so that built with the
// same compiler and flags on the same machine it returns that library's
// bits. The port never loads native/libtpugan_native.so.
//
// Greedy farthest point sampling and the seed-kNN patch are the loader's
// hot loops (data/sampling.py : farthest_point_sampling and
// sample_patch_with_fps); radius counting and voxel downsampling complete
// the JAX library's set. Each runs in plain C++ on the host, called through
// ctypes, which releases the GIL for the call, so the prefetch thread's
// sampling overlaps the step on the card.
//
// Build: tpugan_tpu_torch/data/native.py compiles this file at first use
// with $CXX (else g++) and native/Makefile's flags
// (-O3 -std=c++17 -fPIC -shared -march=native) into tpugan_tpu_torch/_build/.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Greedy farthest point sampling. pts: [n,3] f32, out_idx: [k] i64.
void tpugan_fps(const float* pts, int64_t n, int64_t k, int64_t start,
                int64_t* out_idx) {
  std::vector<float> min_d(n);
  out_idx[0] = start;
  const float* s = pts + 3 * start;
  for (int64_t i = 0; i < n; ++i) {
    float dx = pts[3 * i] - s[0], dy = pts[3 * i + 1] - s[1],
          dz = pts[3 * i + 2] - s[2];
    min_d[i] = dx * dx + dy * dy + dz * dz;
  }
  for (int64_t j = 1; j < k; ++j) {
    int64_t best = 0;
    float best_d = -1.f;
    for (int64_t i = 0; i < n; ++i) {
      if (min_d[i] > best_d) {
        best_d = min_d[i];
        best = i;
      }
    }
    out_idx[j] = best;
    const float* b = pts + 3 * best;
    for (int64_t i = 0; i < n; ++i) {
      float dx = pts[3 * i] - b[0], dy = pts[3 * i + 1] - b[1],
            dz = pts[3 * i + 2] - b[2];
      float d = dx * dx + dy * dy + dz * dz;
      if (d < min_d[i]) min_d[i] = d;
    }
  }
}

// k nearest points to a seed point, ascending by distance (the KDTree patch
// query of train_utils.py:118-123). out_idx: [k] i64.
void tpugan_knn_patch(const float* pts, int64_t n, int64_t seed, int64_t k,
                      int64_t* out_idx) {
  const float* s = pts + 3 * seed;
  std::vector<std::pair<float, int64_t>> d(n);
  for (int64_t i = 0; i < n; ++i) {
    float dx = pts[3 * i] - s[0], dy = pts[3 * i + 1] - s[1],
          dz = pts[3 * i + 2] - s[2];
    d[i] = {dx * dx + dy * dy + dz * dz, i};
  }
  if (k > n) k = n;
  std::partial_sort(d.begin(), d.begin() + k, d.end());
  for (int64_t j = 0; j < k; ++j) out_idx[j] = d[j].second;
}

struct CellHash {
  size_t operator()(const std::array<int64_t, 3>& c) const {
    return (size_t)(c[0] * 73856093LL ^ c[1] * 19349663LL ^ c[2] * 83492791LL);
  }
};

// Per-point neighbor counts within radius via a uniform grid hash
// (reference train_utils.py:269-272; counts include the point itself, like
// scipy query_ball_point).
void tpugan_radius_count(const float* pts, int64_t n, float radius,
                         int32_t* counts) {
  const float r2 = radius * radius;
  const float cell = radius;
  std::unordered_map<std::array<int64_t, 3>, std::vector<int64_t>, CellHash>
      grid;
  grid.reserve(n);
  auto key = [&](const float* p) {
    return std::array<int64_t, 3>{(int64_t)std::floor(p[0] / cell),
                                  (int64_t)std::floor(p[1] / cell),
                                  (int64_t)std::floor(p[2] / cell)};
  };
  for (int64_t i = 0; i < n; ++i) grid[key(pts + 3 * i)].push_back(i);
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    auto c = key(p);
    int32_t cnt = 0;
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = grid.find({c[0] + dx, c[1] + dy, c[2] + dz});
          if (it == grid.end()) continue;
          for (int64_t j : it->second) {
            const float* q = pts + 3 * j;
            float ddx = p[0] - q[0], ddy = p[1] - q[1], ddz = p[2] - q[2];
            if (ddx * ddx + ddy * ddy + ddz * ddz <= r2) ++cnt;
          }
        }
    counts[i] = cnt;
  }
}

// Voxel-grid downsample to per-voxel centroids (reference
// train_utils.py:13-30 via Open3D). Returns the number of voxels written;
// out must hold at least n*3 floats.
int64_t tpugan_voxel_downsample(const float* pts, int64_t n, float voxel,
                                float* out) {
  float mins[3] = {1e30f, 1e30f, 1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) mins[d] = std::min(mins[d], pts[3 * i + d]);
  std::unordered_map<std::array<int64_t, 3>, std::array<double, 4>, CellHash>
      acc;
  acc.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    std::array<int64_t, 3> c;
    for (int d = 0; d < 3; ++d)
      c[d] = (int64_t)std::floor((pts[3 * i + d] - mins[d]) / voxel);
    auto& a = acc[c];
    for (int d = 0; d < 3; ++d) a[d] += pts[3 * i + d];
    a[3] += 1.0;
  }
  int64_t m = 0;
  for (auto& kv : acc) {
    for (int d = 0; d < 3; ++d)
      out[3 * m + d] = (float)(kv.second[d] / kv.second[3]);
    ++m;
  }
  return m;
}

}  // extern "C"
