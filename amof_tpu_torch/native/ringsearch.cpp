// Primitive / King's ring enumeration on a periodic bonded graph.
//
// Native replacement for the RINGS Fortran binary the reference shells
// out to (amof/ring/core.py:249-265; SURVEY.md native checklist #4),
// implementing the ring definitions of Le Roux & Jund, Comput. Mater.
// Sci. 49 (2010) 70 and Franzblau, PRB 44 (1991) 4925:
//
//   * King ring: for a node s and each pair of its neighbors (u, v),
//     the shortest path u->v avoiding s closed through s.
//   * Primitive (SP) ring: a cycle containing, for every pair of its
//     nodes, a shortest path of the full graph ("no shortcuts").
//
// Periodic boundaries: the graph is the quotient graph of the crystal;
// every edge carries the integer image shift of its j endpoint. A closed
// node sequence is a true ring only if its accumulated winding is zero —
// cycles with nonzero winding are infinite periodic paths, not rings,
// and are rejected. (The shortcut test uses quotient-graph distances,
// exact whenever rings are smaller than the cell — the regime the
// reference operates in.)
//
// Enumeration: every primitive ring of even size 2k consists of two
// disjoint shortest paths between nodes at distance k; every odd ring
// 2k+1 is two disjoint shortest paths from s to the ends of an edge
// (u,v) with d(s,u)=d(s,v)=k. Shortest paths are enumerated on the BFS
// DAG with their shift sums.
//
// The "potentially undiscovered rings" diagnostic counts King searches
// whose closure exceeds the current depth limit but stays connected
// without the center — the condition driving the reference's adaptive
// depth loop (amof/ring/core.py:251-265).
//
// C ABI for ctypes; no external dependencies.

#include <cstdint>
#include <cstring>
#include <queue>
#include <set>
#include <vector>

namespace {

struct Graph {
  int n;
  const int32_t* off;    // CSR offsets [n+1]
  const int32_t* idx;    // CSR adjacency (edge-resolved: parallel edges
                         // through different images appear separately)
  const int32_t* shift;  // packed image shift per edge (or nullptr)
  int deg(int u) const { return off[u + 1] - off[u]; }
};

// packed representation of the zero shift ((0+128) in each byte lane)
constexpr int32_t kPackedZero = (128 << 16) | (128 << 8) | 128;

inline int32_t shift_of(const Graph& g, int e) {
  return g.shift ? g.shift[e] : kPackedZero;
}

// packed shifts add component-wise because each component is biased by
// +128 within its own byte lane; we store sums as plain int64 of the
// three unpacked components to avoid overflow games.
inline void unpack(int32_t s, int* v) {
  v[0] = ((s >> 16) & 0xff) - 128;
  v[1] = ((s >> 8) & 0xff) - 128;
  v[2] = (s & 0xff) - 128;
}

struct Shift3 {
  int x = 0, y = 0, z = 0;
  void add(int32_t packed, int sign) {
    int v[3];
    unpack(packed, v);
    x += sign * v[0];
    y += sign * v[1];
    z += sign * v[2];
  }
  bool zero() const { return x == 0 && y == 0 && z == 0; }
  bool operator==(const Shift3& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

// BFS distances from src, optionally with one node removed.
void bfs(const Graph& g, int src, int skip, uint16_t* dist) {
  const uint16_t INF = 0xffff;
  for (int i = 0; i < g.n; ++i) dist[i] = INF;
  if (src == skip) return;
  std::queue<int> q;
  dist[src] = 0;
  q.push(src);
  while (!q.empty()) {
    int u = q.front();
    q.pop();
    for (int e = g.off[u]; e < g.off[u + 1]; ++e) {
      int v = g.idx[e];
      if (v == skip) continue;
      if (dist[v] == INF) {
        dist[v] = dist[u] + 1;
        q.push(v);
      }
    }
  }
}

struct Path {
  std::vector<int> nodes;  // src .. dst
  Shift3 shift;            // accumulated shift along src -> dst
};

// Enumerate all shortest paths src -> dst on the BFS DAG of distances
// FROM src, with shift sums. Parallel edges yield distinct paths.
void shortest_paths(const Graph& g, const uint16_t* dist, int src, int dst,
                    int max_paths, std::vector<Path>* out) {
  struct Fr {
    int node;
    int next_edge;  // offset within node's edge list
    Shift3 acc;     // shift accumulated from dst DOWN TO this node
  };
  std::vector<Fr> frames;
  frames.push_back({dst, 0, Shift3{}});
  std::vector<int> path{dst};
  while (!frames.empty()) {
    if ((int)out->size() >= max_paths) return;
    Fr& f = frames.back();
    int u = f.node;
    if (dist[u] == 0) {
      Path p;
      p.nodes.assign(path.rbegin(), path.rend());
      // acc holds shifts of edges traversed dst->..->src in the v->u
      // direction; path direction src->dst negates it
      p.shift = Shift3{};
      p.shift.x = -f.acc.x;
      p.shift.y = -f.acc.y;
      p.shift.z = -f.acc.z;
      out->push_back(p);
      frames.pop_back();
      path.pop_back();
      continue;
    }
    bool descended = false;
    while (f.next_edge < g.deg(u)) {
      int e = g.off[u] + f.next_edge++;
      int v = g.idx[e];
      if (dist[v] + 1 == dist[u]) {
        Shift3 acc = f.acc;
        acc.add(shift_of(g, e), +1);  // edge u->v carries shift(u->v)
        frames.push_back({v, 0, acc});
        path.push_back(v);
        descended = true;
        break;
      }
    }
    if (!descended) {
      frames.pop_back();
      path.pop_back();
    }
  }
}

std::vector<int> canonical(const std::vector<int>& cyc) {
  int n = cyc.size();
  int mpos = 0;
  for (int i = 1; i < n; ++i)
    if (cyc[i] < cyc[mpos]) mpos = i;
  std::vector<int> fwd(n), bwd(n);
  for (int i = 0; i < n; ++i) fwd[i] = cyc[(mpos + i) % n];
  for (int i = 0; i < n; ++i) bwd[i] = cyc[(mpos - i + n) % n];
  return fwd <= bwd ? fwd : bwd;
}

bool is_primitive(const std::vector<int>& cyc, const uint16_t* dist, int n) {
  int m = cyc.size();
  for (int i = 0; i < m; ++i)
    for (int j = i + 1; j < m; ++j) {
      int ring_d = j - i;
      if (m - ring_d < ring_d) ring_d = m - ring_d;
      if ((int)dist[(size_t)cyc[i] * n + cyc[j]] < ring_d) return false;
    }
  return true;
}

bool distinct_nodes(const std::vector<int>& cyc) {
  std::set<int> s(cyc.begin(), cyc.end());
  return s.size() == cyc.size();
}

}  // namespace

extern "C" {

// Returns the number of rings found (<= max_rings). edge_shift: packed
// ((sx+128)<<16 | (sy+128)<<8 | (sz+128)) image shift per CSR edge, or
// nullptr for a non-periodic graph. dist: optional [n*n] uint16 distance
// matrix (nullptr -> computed here).
int ring_census(int n, const int32_t* adj_off, const int32_t* adj_idx,
                const int32_t* edge_shift, const uint16_t* dist_in,
                int max_size, int max_paths, int max_rings,
                int32_t* ring_sizes, int32_t* ring_nodes,
                int32_t* potentially_undiscovered, int32_t* king_count) {
  Graph g{n, adj_off, adj_idx, edge_shift};
  std::vector<uint16_t> dist_buf;
  const uint16_t* dist = dist_in;
  if (!dist) {
    dist_buf.resize((size_t)n * n);
    for (int s = 0; s < n; ++s) bfs(g, s, -1, &dist_buf[(size_t)s * n]);
    dist = dist_buf.data();
  }

  std::set<std::vector<int>> rings;
  std::set<std::vector<int>> king_rings;
  int undiscovered = 0;

  std::vector<uint16_t> dist_skip(n);
  std::vector<Path> paths_u, paths_v;

  int half = max_size / 2;

  for (int s = 0; s < n; ++s) {
    const uint16_t* ds = dist + (size_t)s * n;

    // --- King rings + undiscovered diagnostic ------------------------
    for (int e1 = g.off[s]; e1 < g.off[s + 1]; ++e1) {
      int u = g.idx[e1];
      if (u == s) continue;
      bfs(g, u, s, dist_skip.data());
      for (int e2 = e1 + 1; e2 < g.off[s + 1]; ++e2) {
        int v = g.idx[e2];
        if (v == s || (v == u && shift_of(g, e1) == shift_of(g, e2)))
          continue;
        uint16_t duv = dist_skip[v];
        if (duv == 0xffff) continue;
        int ring_size = duv + 2;
        if (ring_size > max_size) {
          ++undiscovered;
          continue;
        }
        paths_u.clear();
        shortest_paths(g, dist_skip.data(), u, v, 1, &paths_u);
        if (!paths_u.empty()) {
          std::vector<int> cyc = paths_u[0].nodes;
          cyc.push_back(s);
          if (distinct_nodes(cyc)) king_rings.insert(canonical(cyc));
        }
      }
    }

    // --- primitive rings: even seeds (s, m) ---------------------------
    for (int m = s + 1; m < n; ++m) {
      int k = ds[m];
      if (k < 2 || k > half) continue;
      paths_u.clear();
      shortest_paths(g, ds, s, m, max_paths, &paths_u);
      for (size_t a = 0; a < paths_u.size(); ++a)
        for (size_t b = a + 1; b < paths_u.size(); ++b) {
          if (!(paths_u[a].shift == paths_u[b].shift)) continue;  // winding
          std::vector<int> cyc(paths_u[a].nodes.begin(),
                               paths_u[a].nodes.end() - 1);
          for (auto it = paths_u[b].nodes.rbegin();
               it + 1 != paths_u[b].nodes.rend(); ++it)
            cyc.push_back(*it);
          if ((int)cyc.size() != 2 * k) continue;
          if (!distinct_nodes(cyc)) continue;
          if (!is_primitive(cyc, dist, n)) continue;
          rings.insert(canonical(cyc));
        }
    }
    // --- primitive rings: odd seeds (s, edge (u,v)) -------------------
    for (int u = 0; u < n; ++u) {
      int k = ds[u];
      if (k < 1 || k == 0xffff || 2 * k + 1 > max_size) continue;
      for (int e = g.off[u]; e < g.off[u + 1]; ++e) {
        int v = g.idx[e];
        if (v < u) continue;
        if (v == u && !g.shift) continue;
        if (ds[v] != k) continue;
        paths_u.clear();
        paths_v.clear();
        shortest_paths(g, ds, s, u, max_paths, &paths_u);
        shortest_paths(g, ds, s, v, max_paths, &paths_v);
        for (auto& pu : paths_u)
          for (auto& pv : paths_v) {
            // winding: shift(s->u) + shift(u->v edge) - shift(s->v) == 0
            Shift3 total = pu.shift;
            total.add(shift_of(g, e), +1);
            Shift3 expect = pv.shift;
            if (!(total == expect)) continue;
            bool ok = true;
            std::set<int> seen(pu.nodes.begin() + 1, pu.nodes.end());
            for (size_t i = 1; i < pv.nodes.size(); ++i)
              if (seen.count(pv.nodes[i])) {
                ok = false;
                break;
              }
            if (!ok) continue;
            std::vector<int> cyc(pu.nodes.begin(), pu.nodes.end());
            for (auto it = pv.nodes.rbegin(); it + 1 != pv.nodes.rend(); ++it)
              cyc.push_back(*it);
            if ((int)cyc.size() != 2 * k + 1) continue;
            if (!distinct_nodes(cyc)) continue;
            if (!is_primitive(cyc, dist, n)) continue;
            rings.insert(canonical(cyc));
          }
      }
    }
  }

  *potentially_undiscovered = undiscovered;
  *king_count = (int32_t)king_rings.size();

  int count = 0, node_pos = 0;
  for (const auto& r : rings) {
    if (count >= max_rings) break;
    ring_sizes[count] = (int32_t)r.size();
    for (int v : r) ring_nodes[node_pos++] = v;
    ++count;
  }
  return count;
}

}  // extern "C"
