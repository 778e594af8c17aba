// Fast union-find for feature-track building.
//
// Capability parity: the track-chaining stage of COLMAP's C++
// point_triangulator (the reference delegates it via subprocess,
// hloc/triangulation.py:129). On Aachen-scale maps the match graph has
// millions of edges; this keeps the host-side pass in native code while
// the geometry runs on the device.
//
// C ABI, consumed from Python via ctypes (see sfd2_torch/native/__init__.py).

#include <cstdint>
#include <vector>

namespace {

int64_t find_root(std::vector<int64_t>& parent, int64_t i) {
  while (parent[i] != i) {
    parent[i] = parent[parent[i]];  // path halving
    i = parent[i];
  }
  return i;
}

}  // namespace

extern "C" {

// Union the given edges over n_nodes elements; writes each node's final
// root id into out_roots (length n_nodes). Returns the number of distinct
// roots.
int64_t uf_build(int64_t n_nodes, int64_t n_edges, const int64_t* edges_a,
                 const int64_t* edges_b, int64_t* out_roots) {
  std::vector<int64_t> parent(n_nodes);
  std::vector<int32_t> rank(n_nodes, 0);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t ra = find_root(parent, edges_a[e]);
    int64_t rb = find_root(parent, edges_b[e]);
    if (ra == rb) continue;
    if (rank[ra] < rank[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    if (rank[ra] == rank[rb]) ++rank[ra];
  }

  int64_t n_roots = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    out_roots[i] = find_root(parent, i);
    if (out_roots[i] == i) ++n_roots;
  }
  return n_roots;
}

}  // extern "C"
