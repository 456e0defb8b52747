// Native graph partitioner: the framework's replacement for the Metis /
// KaHyPar C/C++ libraries the reference delegates to (reference:
// src/partitioning.jl MetisPartitioner :29, hypergraph partitioning
// :244-500; ext KaHyPar usage). Used for domain decomposition and for the
// thread/block-partitioned preconditioners.
//
// Algorithm (Metis-style multilevel):
//   1. coarsen by heavy-edge matching until ~16 nodes/block remain,
//   2. partition the coarsest graph by BFS region growing from
//      farthest-point seeds (weighted balance),
//   3. project back level by level, running weighted boundary
//      Kernighan-Lin refinement (edge-weight gains, node-weight balance
//      window) after every projection.
// Deterministic (no randomness).
//
// C ABI (ctypes):
//   int jutul_partition(const long long* face_neighbors, long long n_faces,
//                       long long n_cells, long long n_blocks,
//                       const double* cell_weights /*nullable*/,
//                       long long* out_part);
// Returns 0 on success.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <tuple>
#include <vector>

namespace {

struct CSR {
  std::vector<int64_t> start;
  std::vector<int64_t> adj;
};

CSR build_csr(const int64_t* nb, int64_t n_faces, int64_t n_cells) {
  std::vector<int64_t> deg(n_cells, 0);
  for (int64_t f = 0; f < n_faces; ++f) {
    ++deg[nb[2 * f]];
    ++deg[nb[2 * f + 1]];
  }
  CSR g;
  g.start.assign(n_cells + 1, 0);
  for (int64_t c = 0; c < n_cells; ++c) g.start[c + 1] = g.start[c] + deg[c];
  g.adj.assign(g.start[n_cells], 0);
  std::vector<int64_t> fill(n_cells, 0);
  for (int64_t f = 0; f < n_faces; ++f) {
    int64_t a = nb[2 * f], b = nb[2 * f + 1];
    g.adj[g.start[a] + fill[a]++] = b;
    g.adj[g.start[b] + fill[b]++] = a;
  }
  return g;
}

// Weighted graph for the multilevel hierarchy.
struct WG {
  int64_t n = 0;
  std::vector<int64_t> start, adj;
  std::vector<double> ewt;  // edge weights, parallel to adj
  std::vector<double> nwt;  // node weights
};

WG from_faces(const int64_t* nb, int64_t n_faces, int64_t n_cells,
              const double* cell_weights) {
  CSR g = build_csr(nb, n_faces, n_cells);
  WG w;
  w.n = n_cells;
  w.start = std::move(g.start);
  w.adj = std::move(g.adj);
  w.ewt.assign(w.adj.size(), 1.0);
  w.nwt.assign(n_cells, 1.0);
  if (cell_weights)
    for (int64_t c = 0; c < n_cells; ++c) w.nwt[c] = cell_weights[c];
  return w;
}

// BFS distance from a seed (unweighted), used for farthest-point seeding.
int64_t farthest_from_wg(const WG& g, int64_t seed,
                         std::vector<int64_t>& dist) {
  dist.assign(g.n, -1);
  std::queue<int64_t> q;
  q.push(seed);
  dist[seed] = 0;
  int64_t far = seed;
  while (!q.empty()) {
    int64_t c = q.front();
    q.pop();
    if (dist[c] > dist[far]) far = c;
    for (int64_t i = g.start[c]; i < g.start[c + 1]; ++i) {
      int64_t j = g.adj[i];
      if (dist[j] < 0) {
        dist[j] = dist[c] + 1;
        q.push(j);
      }
    }
  }
  return far;
}

// Heavy-edge matching (Metis HEM): visit nodes in ascending degree,
// match each with its heaviest unmatched neighbor. Returns the coarse
// node count; cmap maps fine -> coarse ids.
int64_t heavy_edge_match(const WG& g, std::vector<int64_t>& cmap) {
  std::vector<int64_t> order(g.n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return (g.start[a + 1] - g.start[a]) < (g.start[b + 1] - g.start[b]);
  });
  cmap.assign(g.n, -1);
  int64_t nc = 0;
  for (int64_t v : order) {
    if (cmap[v] >= 0) continue;
    int64_t best = -1;
    double bw = -1.0;
    for (int64_t i = g.start[v]; i < g.start[v + 1]; ++i) {
      int64_t j = g.adj[i];
      if (cmap[j] < 0 && j != v && g.ewt[i] > bw) {
        bw = g.ewt[i];
        best = j;
      }
    }
    cmap[v] = nc;
    if (best >= 0) cmap[best] = nc;
    ++nc;
  }
  return nc;
}

// Contract matched pairs into the coarse weighted graph (summed edge and
// node weights; parallel coarse edges merged by sort).
WG contract(const WG& g, const std::vector<int64_t>& cmap, int64_t nc) {
  WG c;
  c.n = nc;
  c.nwt.assign(nc, 0.0);
  for (int64_t v = 0; v < g.n; ++v) c.nwt[cmap[v]] += g.nwt[v];
  // each undirected fine edge appears twice in CSR; keep cu < cv once
  std::vector<std::tuple<int64_t, int64_t, double>> tr;
  tr.reserve(g.adj.size() / 2);
  for (int64_t u = 0; u < g.n; ++u) {
    int64_t cu = cmap[u];
    for (int64_t i = g.start[u]; i < g.start[u + 1]; ++i) {
      int64_t cv = cmap[g.adj[i]];
      if (cu < cv) tr.emplace_back(cu, cv, g.ewt[i]);
    }
  }
  std::sort(tr.begin(), tr.end(),
            [](const auto& a, const auto& b) {
              return std::get<0>(a) != std::get<0>(b)
                         ? std::get<0>(a) < std::get<0>(b)
                         : std::get<1>(a) < std::get<1>(b);
            });
  // merge duplicates, count degrees
  std::vector<std::tuple<int64_t, int64_t, double>> ed;
  ed.reserve(tr.size());
  for (const auto& t : tr) {
    if (!ed.empty() && std::get<0>(ed.back()) == std::get<0>(t) &&
        std::get<1>(ed.back()) == std::get<1>(t))
      std::get<2>(ed.back()) += std::get<2>(t);
    else
      ed.push_back(t);
  }
  std::vector<int64_t> deg(nc, 0);
  for (const auto& t : ed) {
    ++deg[std::get<0>(t)];
    ++deg[std::get<1>(t)];
  }
  c.start.assign(nc + 1, 0);
  for (int64_t v = 0; v < nc; ++v) c.start[v + 1] = c.start[v] + deg[v];
  c.adj.assign(c.start[nc], 0);
  c.ewt.assign(c.start[nc], 0.0);
  std::vector<int64_t> fill(nc, 0);
  for (const auto& t : ed) {
    int64_t a = std::get<0>(t), b = std::get<1>(t);
    double w = std::get<2>(t);
    c.adj[c.start[a] + fill[a]] = b;
    c.ewt[c.start[a] + fill[a]++] = w;
    c.adj[c.start[b] + fill[b]] = a;
    c.ewt[c.start[b] + fill[b]++] = w;
  }
  return c;
}

// BFS region growing from farthest-point seeds (weighted balance). Each
// block's target is its fair share of the REMAINING weight: with heavy
// coarse nodes a fixed target lets early blocks overshoot and starve the
// late ones (observed: an empty block at 1M cells / 64 blocks on the
// 512-node coarsest level).
void grow_blocks(const WG& g, int64_t n_blocks, std::vector<int64_t>& part,
                 std::vector<double>& block_w, double total) {
  part.assign(g.n, -1);
  block_w.assign(n_blocks, 0.0);
  double remaining = total;
  std::vector<int64_t> dist;
  int64_t seed = farthest_from_wg(g, 0, dist);
  for (int64_t b = 0; b < n_blocks; ++b) {
    const double target =
        remaining / static_cast<double>(n_blocks - b);
    if (part[seed] >= 0) {
      int64_t cand = -1;
      for (int64_t c = 0; c < g.n; ++c)
        if (part[c] < 0) {
          cand = c;
          break;
        }
      if (cand < 0) break;
      seed = cand;
    }
    std::queue<int64_t> q;
    q.push(seed);
    while (block_w[b] < target) {
      if (q.empty()) {
        // the BFS died in an enclosed pocket before the block reached
        // target (observed: a size-1 block on a 320-cell mesh) — keep
        // FILLING THIS BLOCK from a fresh unassigned seed; a possibly
        // disconnected block beats a starved one, and the KL pass
        // tidies the boundary afterwards
        int64_t cand = -1;
        for (int64_t c2 = 0; c2 < g.n; ++c2)
          if (part[c2] < 0) {
            cand = c2;
            break;
          }
        if (cand < 0) break;
        q.push(cand);
      }
      int64_t c = q.front();
      q.pop();
      if (part[c] >= 0) continue;
      part[c] = b;
      block_w[b] += g.nwt[c];
      for (int64_t i = g.start[c]; i < g.start[c + 1]; ++i)
        if (part[g.adj[i]] < 0) q.push(g.adj[i]);
    }
    remaining -= block_w[b];
    seed = -1;
    while (!q.empty()) {
      int64_t c = q.front();
      q.pop();
      if (part[c] < 0) {
        seed = c;
        break;
      }
    }
    if (seed < 0) {
      for (int64_t c = 0; c < g.n; ++c)
        if (part[c] < 0) {
          seed = c;
          break;
        }
      if (seed < 0) break;
    }
  }
  // sweep leftovers into the last block (disconnected graphs)
  for (int64_t c = 0; c < g.n; ++c)
    if (part[c] < 0) {
      part[c] = n_blocks - 1;
      block_w[n_blocks - 1] += g.nwt[c];
    }
}

// Weighted boundary KL refinement: move boundary nodes to the adjacent
// block with the largest EDGE-WEIGHT gain, within a node-weight balance
// window. The LOWER bound stops the drain that could empty a small block
// (observed on a 320-cell mesh before the bound existed).
void refine(const WG& g, int64_t n_blocks, std::vector<int64_t>& part,
            std::vector<double>& block_w, double target, int passes) {
  const double max_w = 1.10 * target;
  const double min_w = 0.75 * target;
  for (int pass = 0; pass < passes; ++pass) {
    int64_t moved = 0;
    for (int64_t c = 0; c < g.n; ++c) {
      int64_t pb = part[c];
      int64_t best_b = pb;
      double same = 0.0;
      std::vector<std::pair<int64_t, double>> counts;
      for (int64_t i = g.start[c]; i < g.start[c + 1]; ++i) {
        int64_t ob = part[g.adj[i]];
        if (ob == pb) {
          same += g.ewt[i];
          continue;
        }
        bool found = false;
        for (auto& pr : counts)
          if (pr.first == ob) {
            pr.second += g.ewt[i];
            found = true;
            break;
          }
        if (!found) counts.emplace_back(ob, g.ewt[i]);
      }
      double best_gain = 1e-12;
      for (auto& pr : counts) {
        double gain = pr.second - same;
        if (gain > best_gain && block_w[pr.first] + g.nwt[c] <= max_w &&
            block_w[pb] - g.nwt[c] >= min_w) {
          best_gain = gain;
          best_b = pr.first;
        }
      }
      if (best_b != pb) {
        part[c] = best_b;
        block_w[pb] -= g.nwt[c];
        block_w[best_b] += g.nwt[c];
        ++moved;
      }
    }
    if (moved == 0) break;
  }
}

}  // namespace

extern "C" int jutul_partition(const int64_t* face_neighbors, int64_t n_faces,
                               int64_t n_cells, int64_t n_blocks,
                               const double* cell_weights,
                               int64_t* out_part) {
  if (n_cells <= 0 || n_blocks <= 0) return 1;
  if (n_blocks == 1) {
    std::memset(out_part, 0, sizeof(int64_t) * n_cells);
    return 0;
  }
  // 1. coarsen: heavy-edge matching until ~16 nodes/block (or stall)
  std::vector<WG> levels;
  levels.push_back(from_faces(face_neighbors, n_faces, n_cells,
                              cell_weights));
  const double total = std::accumulate(levels[0].nwt.begin(),
                                       levels[0].nwt.end(), 0.0);
  const double target = total / static_cast<double>(n_blocks);
  std::vector<std::vector<int64_t>> maps;
  const int64_t coarse_stop = std::max<int64_t>(16 * n_blocks, 512);
  while (levels.back().n > coarse_stop && (int64_t)levels.size() < 30) {
    std::vector<int64_t> cmap;
    int64_t nc = heavy_edge_match(levels.back(), cmap);
    if (nc > levels.back().n * 9 / 10) break;  // matching stalled
    WG cg = contract(levels.back(), cmap, nc);
    maps.push_back(std::move(cmap));
    levels.push_back(std::move(cg));
  }

  // 2. partition the coarsest level
  std::vector<int64_t> part;
  std::vector<double> block_w;
  grow_blocks(levels.back(), n_blocks, part, block_w, total);
  refine(levels.back(), n_blocks, part, block_w, target, 10);

  // 3. uncoarsen, refining after every projection (block weights are
  // invariant under projection — the coarse node carries its children's
  // total weight)
  for (int64_t l = (int64_t)maps.size() - 1; l >= 0; --l) {
    const auto& cmap = maps[l];
    std::vector<int64_t> fine(levels[l].n);
    for (int64_t v = 0; v < levels[l].n; ++v) fine[v] = part[cmap[v]];
    part = std::move(fine);
    refine(levels[l], n_blocks, part, block_w, target, 6);
  }

  std::memcpy(out_part, part.data(), sizeof(int64_t) * n_cells);
  return 0;
}

// Reverse Cuthill-McKee ordering for bandwidth reduction — the reference
// uses SymRCM for cache locality (SURVEY.md hard parts (c)); on TPU the
// same ordering improves gather locality of the cell axis.
extern "C" int jutul_rcm(const int64_t* face_neighbors, int64_t n_faces,
                         int64_t n_cells, int64_t* out_perm) {
  CSR g = build_csr(face_neighbors, n_faces, n_cells);
  // BFS distance helper over the unweighted CSR
  auto far_from = [&](int64_t seed, std::vector<int64_t>& dist) {
    dist.assign(n_cells, -1);
    std::queue<int64_t> q;
    q.push(seed);
    dist[seed] = 0;
    int64_t far = seed;
    while (!q.empty()) {
      int64_t c = q.front();
      q.pop();
      if (dist[c] > dist[far]) far = c;
      for (int64_t i = g.start[c]; i < g.start[c + 1]; ++i) {
        int64_t j = g.adj[i];
        if (dist[j] < 0) {
          dist[j] = dist[c] + 1;
          q.push(j);
        }
      }
    }
    return far;
  };
  std::vector<int64_t> order;
  order.reserve(n_cells);
  std::vector<char> seen(n_cells, 0);
  std::vector<int64_t> dist;
  for (int64_t root = 0; root < n_cells; ++root) {
    if (seen[root]) continue;
    // peripheral-ish start
    int64_t s = far_from(root, dist);
    std::queue<int64_t> q;
    if (seen[s]) s = root;
    q.push(s);
    seen[s] = 1;
    while (!q.empty()) {
      int64_t c = q.front();
      q.pop();
      order.push_back(c);
      // visit neighbors in degree order
      std::vector<std::pair<int64_t, int64_t>> nb;
      for (int64_t i = g.start[c]; i < g.start[c + 1]; ++i) {
        int64_t j = g.adj[i];
        if (!seen[j]) nb.emplace_back(g.start[j + 1] - g.start[j], j);
      }
      std::sort(nb.begin(), nb.end());
      for (auto& pr : nb) {
        if (!seen[pr.second]) {
          seen[pr.second] = 1;
          q.push(pr.second);
        }
      }
    }
  }
  // reverse
  for (int64_t i = 0; i < n_cells; ++i)
    out_perm[i] = order[n_cells - 1 - i];
  return 0;
}

// Vanek-style greedy aggregation for AMG (counterpart of the aggregation
// step inside the reference's AlgebraicMultigrid/AMGCL native engines).
// Pass 1 seeds aggregates from nodes with untouched neighborhoods; pass 2
// attaches leftovers to an adjacent aggregate. Returns n_aggregates.
extern "C" int64_t jutul_aggregate(const int64_t* ell_cols, int64_t n,
                                   int64_t S, int64_t* out_agg) {
  for (int64_t i = 0; i < n; ++i) out_agg[i] = -1;
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (out_agg[i] >= 0) continue;
    bool free_nbhd = true;
    for (int64_t s = 0; s < S; ++s) {
      if (out_agg[ell_cols[i * S + s]] >= 0) {
        free_nbhd = false;
        break;
      }
    }
    if (free_nbhd) {
      out_agg[i] = n_agg;
      for (int64_t s = 0; s < S; ++s) out_agg[ell_cols[i * S + s]] = n_agg;
      ++n_agg;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (out_agg[i] >= 0) continue;
    int64_t found = -1;
    for (int64_t s = 0; s < S; ++s) {
      int64_t a = out_agg[ell_cols[i * S + s]];
      if (a >= 0) {
        found = a;
        break;
      }
    }
    out_agg[i] = (found >= 0) ? found : n_agg++;
  }
  return n_agg;
}
