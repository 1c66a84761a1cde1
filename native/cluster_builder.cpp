// Native cluster builder: the production acceleration-structure build
// for raytrace (models/scene.py -> accel/builder.build_clusters_bvh).
//
// BVH-style clustering by recursive EXACT median partition of primitive
// centroids along the widest axis (std::nth_element), leaves of
// ~leaf_target primitives, no straddler duplication. This replaces
// the reference's KD-tree build (src/accel/kdtree.rs:
// 26-56 and the flattened GPU variant gpu_structs.rs:628-715): the
// traversal consumers (ops/pallas/hit_kernel.py and the XLA cluster
// walk) want dense equal-width clusters rather than a node tree, and
// spatial-median KD splits with straddler duplication measured ~16x
// primitive duplication on the reference's biplane asset.
//
// C ABI (ctypes; no pybind11 in this image). Caller pre-computes the
// leaf count (deterministic: n splits into n/2 | n-n/2 until
// <= leaf_target) and pre-allocates:
//   cp: (n_clusters, width) int32, pre-filled -1
//   cl, ch: (n_clusters, 3) float32
// Leaves are emitted in DFS order (left child first) = spatially
// local, which build-time supercluster grouping relies on.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" void cluster_build(
    const float* lo, const float* hi, int32_t m,
    int32_t leaf_target, int32_t width,
    int32_t* cp, float* cl, float* ch, int32_t* n_out) {
  std::vector<int32_t> ids(m);
  for (int32_t i = 0; i < m; ++i) ids[i] = i;
  std::vector<float> cent(static_cast<size_t>(m) * 3);
  for (int32_t i = 0; i < m; ++i)
    for (int a = 0; a < 3; ++a)
      cent[3 * static_cast<size_t>(i) + a] =
          0.5f * (lo[3 * static_cast<size_t>(i) + a] +
                  hi[3 * static_cast<size_t>(i) + a]);

  struct Range { int32_t b, e; };
  std::vector<Range> stack;
  stack.push_back({0, m});
  int32_t C = 0;
  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    int32_t n = r.e - r.b;
    if (n <= leaf_target) {
      float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
      float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
      for (int32_t i = 0; i < n; ++i) {
        int32_t id = ids[r.b + i];
        cp[static_cast<size_t>(C) * width + i] = id;
        for (int a = 0; a < 3; ++a) {
          mn[a] = std::min(mn[a], lo[3 * static_cast<size_t>(id) + a]);
          mx[a] = std::max(mx[a], hi[3 * static_cast<size_t>(id) + a]);
        }
      }
      for (int a = 0; a < 3; ++a) {
        cl[static_cast<size_t>(C) * 3 + a] = n ? mn[a] : 0.0f;
        ch[static_cast<size_t>(C) * 3 + a] = n ? mx[a] : 0.0f;
      }
      ++C;
      continue;
    }
    // widest centroid axis
    float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int32_t i = r.b; i < r.e; ++i) {
      const float* c = &cent[3 * static_cast<size_t>(ids[i])];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], c[a]);
        mx[a] = std::max(mx[a], c[a]);
      }
    }
    int axis = 0;
    float best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a)
      if (mx[a] - mn[a] > best) { best = mx[a] - mn[a]; axis = a; }
    int32_t mid = n / 2;
    std::nth_element(
        ids.begin() + r.b, ids.begin() + r.b + mid, ids.begin() + r.e,
        [&](int32_t a, int32_t b) {
          return cent[3 * static_cast<size_t>(a) + axis] <
                 cent[3 * static_cast<size_t>(b) + axis];
        });
    // right pushed first so the LEFT half is processed next (DFS order)
    stack.push_back({r.b + mid, r.e});
    stack.push_back({r.b, r.b + mid});
  }
  *n_out = C;
}
