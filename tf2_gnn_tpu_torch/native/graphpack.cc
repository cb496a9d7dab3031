// graphpack — the host-side data engine of the PyTorch port.
//
// The port's own copy of the JAX package's engine (``native/src/graphpack.cc``
// there), kept byte for byte below this header so both give the same arrays:
// adjacency expansion (backward edges / self loops / in-degrees), padded
// mega-batch assembly in single memcpy passes, target-sorted edge reordering,
// the chunked scatter planner, the block-pair planner and reverse
// Cuthill-McKee ordering. Exposed through a plain C ABI consumed via ctypes
// (tf2_gnn_tpu_torch/native/__init__.py); every function writes into
// caller-allocated numpy buffers so no allocation crosses the boundary.
//
// Build: at first use, ``g++ -O3 -std=c++17 -fPIC -shared`` into
// build/tf2_gnn_tpu_torch/ (tf2_gnn_tpu_torch/native/__init__.py::build).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Adjacency preprocessing.
//
// For one forward edge type: writes the processed edge list (forward edges
// plus flipped edges appended when tied) into out (int32 [cap, 2]).
// Returns the number of edges written.
int64_t gp_expand_edges(const int32_t* edges, int64_t num_edges, int tied,
                        int32_t* out) {
  // forward copy
  std::memcpy(out, edges, sizeof(int32_t) * 2 * num_edges);
  if (!tied) return num_edges;
  int32_t* flip = out + 2 * num_edges;
  for (int64_t e = 0; e < num_edges; ++e) {
    flip[2 * e] = edges[2 * e + 1];
    flip[2 * e + 1] = edges[2 * e];
  }
  return 2 * num_edges;
}

// Flipped copy of an edge list (the fresh backward type for untied types).
void gp_flip_edges(const int32_t* edges, int64_t num_edges, int32_t* out) {
  for (int64_t e = 0; e < num_edges; ++e) {
    out[2 * e] = edges[2 * e + 1];
    out[2 * e + 1] = edges[2 * e];
  }
}

// Self-loop edge list [num_nodes, 2].
void gp_self_loops(int64_t num_nodes, int32_t* out) {
  for (int64_t v = 0; v < num_nodes; ++v) {
    out[2 * v] = static_cast<int32_t>(v);
    out[2 * v + 1] = static_cast<int32_t>(v);
  }
}

// Per-type in-degree table: counts[num_nodes] (float64, matches the numpy
// implementation's dtype) for one edge type.
void gp_in_degrees(const int32_t* edges, int64_t num_edges, int64_t num_nodes,
                   double* counts) {
  std::memset(counts, 0, sizeof(double) * num_nodes);
  for (int64_t e = 0; e < num_edges; ++e) {
    int32_t t = edges[2 * e + 1];
    if (t >= 0 && t < num_nodes) counts[t] += 1.0;
  }
}

// ---------------------------------------------------------------------------
// Padded batch assembly.
//
// Concatenate per-graph node features into the padded [v_pad, feat_dim]
// buffer and fill node_to_graph. `features` is an array of num_graphs
// pointers; graph_num_nodes gives each graph's node count. The padding rows
// are zeroed and map to pad_graph_id.
void gp_pack_nodes(const float** features, const int32_t* graph_num_nodes,
                   int64_t num_graphs, int64_t feat_dim, int64_t v_pad,
                   int32_t pad_graph_id, float* node_features_out,
                   int32_t* node_to_graph_out) {
  int64_t offset = 0;
  for (int64_t g = 0; g < num_graphs; ++g) {
    int64_t n = graph_num_nodes[g];
    std::memcpy(node_features_out + offset * feat_dim, features[g],
                sizeof(float) * n * feat_dim);
    std::fill(node_to_graph_out + offset, node_to_graph_out + offset + n,
              static_cast<int32_t>(g));
    offset += n;
  }
  std::memset(node_features_out + offset * feat_dim, 0,
              sizeof(float) * (v_pad - offset) * feat_dim);
  std::fill(node_to_graph_out + offset, node_to_graph_out + v_pad,
            pad_graph_id);
}

// Concatenate one edge type across graphs with node-index offsetting, into
// split src/tgt arrays padded to `budget` with pad_node. `edges` is an array
// of num_graphs pointers to int32 [count_g, 2]; counts gives count_g.
// Returns total real edges written (or -1 if budget overflows).
int64_t gp_pack_edges(const int32_t** edges, const int64_t* counts,
                      const int32_t* graph_num_nodes, int64_t num_graphs,
                      int64_t budget, int32_t pad_node, int32_t* src_out,
                      int32_t* tgt_out) {
  int64_t written = 0;
  int64_t node_offset = 0;
  for (int64_t g = 0; g < num_graphs; ++g) {
    int64_t c = counts[g];
    if (written + c > budget) return -1;
    const int32_t* e = edges[g];
    for (int64_t i = 0; i < c; ++i) {
      src_out[written + i] = e[2 * i] + static_cast<int32_t>(node_offset);
      tgt_out[written + i] = e[2 * i + 1] + static_cast<int32_t>(node_offset);
    }
    written += c;
    node_offset += graph_num_nodes[g];
  }
  std::fill(src_out + written, src_out + budget, pad_node);
  std::fill(tgt_out + written, tgt_out + budget, pad_node);
  return written;
}

// Zero-pad a label array [rows_real, cols] (float32) to [rows_pad, cols].
void gp_pack_labels(const float** labels, const int32_t* rows_per_graph,
                    int64_t num_graphs, int64_t cols, int64_t rows_pad,
                    float* out) {
  int64_t offset = 0;
  for (int64_t g = 0; g < num_graphs; ++g) {
    int64_t n = rows_per_graph[g];
    std::memcpy(out + offset * cols, labels[g], sizeof(float) * n * cols);
    offset += n;
  }
  std::memset(out + offset * cols, 0, sizeof(float) * (rows_pad - offset) * cols);
}

// ---------------------------------------------------------------------------
// Target-sorted edge reordering (stable) — the layout the Pallas
// sorted-segment kernels want. Writes the permutation applied.
void gp_sort_by_target(const int32_t* src, const int32_t* tgt, int64_t count,
                       int32_t* src_out, int32_t* tgt_out, int32_t* perm_out) {
  std::vector<int32_t> perm(count);
  std::iota(perm.begin(), perm.end(), 0);
  std::stable_sort(perm.begin(), perm.end(),
                   [tgt](int32_t a, int32_t b) { return tgt[a] < tgt[b]; });
  for (int64_t i = 0; i < count; ++i) {
    src_out[i] = src[perm[i]];
    tgt_out[i] = tgt[perm[i]];
    perm_out[i] = perm[i];
  }
}

// ---------------------------------------------------------------------------
// Chunked scatter plan for the Pallas sorted-segment kernel
// (tf2_gnn_tpu/ops/spmm_pallas.py). Walks value-sorted edges and splits them
// into chunks of <= chunk_edges edges whose values share one node block of
// block_nodes rows. perm/rel must be pre-filled by the caller with -1 /
// block_nodes sentinels (sized num_chunks * chunk_edges); block_ids sized
// num_chunks. Returns chunks used, or -1 on overflow.
int64_t gp_scatter_plan(const int32_t* sorted_vals, const int32_t* order,
                        int64_t n, int64_t num_chunks, int64_t chunk_edges,
                        int64_t block_nodes, int32_t* perm, int32_t* rel,
                        int32_t* block_ids) {
  std::fill(perm, perm + num_chunks * chunk_edges, -1);
  std::fill(rel, rel + num_chunks * chunk_edges,
            static_cast<int32_t>(block_nodes));
  std::fill(block_ids, block_ids + num_chunks, 0);
  int64_t chunk = 0, pos = 0;
  int64_t current_block = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t block = sorted_vals[i] / block_nodes;
    if (current_block == -1) {
      current_block = block;
      block_ids[chunk] = static_cast<int32_t>(block);
    } else if (block != current_block || pos == chunk_edges) {
      ++chunk;
      pos = 0;
      current_block = block;
      if (chunk >= num_chunks) return -1;
      block_ids[chunk] = static_cast<int32_t>(block);
    }
    int64_t slot = chunk * chunk_edges + pos;
    perm[slot] = order[i];
    rel[slot] = static_cast<int32_t>(sorted_vals[i] - current_block * block_nodes);
    ++pos;
  }
  if (current_block >= 0) {
    for (int64_t c = chunk + 1; c < num_chunks; ++c)
      block_ids[c] = block_ids[chunk];
  }
  return chunk + 1;
}

// ---------------------------------------------------------------------------
// Block-pair plan for one direction (tf2_gnn_tpu/ops/pair_spmm.py
// ``_plan_one_direction``'s no-spill fast path). Edges are stable-counting-
// sorted by (tgt_block, src_block); each (tgt_block, src_block) pair's
// edges fill consecutive E_C-slot chunks; runs of equal tgt_block start at
// group-aligned chunk indices; padding chunks inherit the previous real
// chunk's blocks (tgt non-decreasing) so downstream revisit logic sees
// them as zero-contribution revisits. Exactly matches the numpy planner's
// layout (same stable order), which remains the spill fallback.
//
// rel_src/rel_tgt sized budget*e_c (filled with the blk sentinel here),
// src_blk/tgt_blk sized budget, edge_slot sized n (-1 never written here).
// Returns chunks used, or -1 when the budget would overflow (caller falls
// back to the numpy spill path).
int64_t gp_pair_plan(const int32_t* src, const int32_t* tgt, int64_t n,
                     int64_t budget, int64_t group, int64_t blk, int64_t e_c,
                     int32_t* rel_src, int32_t* rel_tgt, int32_t* src_blk,
                     int32_t* tgt_blk, int64_t* edge_slot) {
  std::fill(rel_src, rel_src + budget * e_c, static_cast<int32_t>(blk));
  std::fill(rel_tgt, rel_tgt + budget * e_c, static_cast<int32_t>(blk));
  std::fill(src_blk, src_blk + budget, 0);
  std::fill(tgt_blk, tgt_blk + budget, 0);
  std::fill(edge_slot, edge_slot + n, static_cast<int64_t>(-1));
  if (n == 0) return 0;

  // blk is a power of two in practice (BLOCK_NODES=128) — shift instead of
  // dividing per edge (runtime int division costs ~10 ms alone at 211k
  // edges on a 1-CPU host).
  int shift = 0;
  while ((int64_t{1} << shift) < blk) ++shift;
  const bool pow2 = (int64_t{1} << shift) == blk;
  std::vector<int32_t> sbv(n), tbv(n);
  int32_t max_sb = 0, max_tb = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t sb = pow2 ? (src[i] >> shift)
                            : src[i] / static_cast<int32_t>(blk);
    const int32_t tb = pow2 ? (tgt[i] >> shift)
                            : tgt[i] / static_cast<int32_t>(blk);
    sbv[i] = sb;
    tbv[i] = tb;
    if (sb > max_sb) max_sb = sb;
    if (tb > max_tb) max_tb = tb;
  }
  const int64_t sb_span = static_cast<int64_t>(max_sb) + 1;
  const int64_t num_keys = (static_cast<int64_t>(max_tb) + 1) * sb_span;

  // Stable counting sort by key = tb * sb_span + sb.
  std::vector<int64_t> key(n);
  std::vector<int64_t> cnt(num_keys + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    key[i] = static_cast<int64_t>(tbv[i]) * sb_span + sbv[i];
    ++cnt[key[i] + 1];
  }
  for (int64_t k = 0; k < num_keys; ++k) cnt[k + 1] += cnt[k];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cursor(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[key[i]]++] = i;
  }

  // Walk sorted edges: new pair -> new chunk; new tgt run -> group-aligned
  // chunk start (skipped padding chunks inherit the previous blocks).
  int64_t chunk = -1, pos = 0;
  int64_t cur_key = -1, cur_tb = -1;
  int32_t last_sb = 0, last_tb = 0;
  for (int64_t s = 0; s < n; ++s) {
    const int64_t i = order[s];
    const int64_t k = key[i];
    const int32_t sb = sbv[i];
    const int32_t tb = tbv[i];
    if (k != cur_key) {
      int64_t next = chunk + 1;
      if (tb != cur_tb) {  // new run starts group-aligned
        next = ((next + group - 1) / group) * group;
        cur_tb = tb;
      }
      for (int64_t c = chunk + 1; c < next && c < budget; ++c) {
        src_blk[c] = last_sb;
        tgt_blk[c] = last_tb;
      }
      chunk = next;
      pos = 0;
      cur_key = k;
    } else if (pos == e_c) {
      ++chunk;
      pos = 0;
    }
    if (chunk >= budget) return -1;
    if (pos == 0) {
      src_blk[chunk] = sb;
      tgt_blk[chunk] = tb;
      last_sb = sb;
      last_tb = tb;
    }
    const int64_t slot = chunk * e_c + pos;
    rel_src[slot] = src[i] - sb * static_cast<int32_t>(blk);
    rel_tgt[slot] = tgt[i] - tb * static_cast<int32_t>(blk);
    edge_slot[i] = slot;
    ++pos;
  }
  // The final run also pads to a group multiple; remaining budget chunks
  // inherit the last real blocks (matches the numpy fill).
  for (int64_t c = chunk + 1; c < budget; ++c) {
    src_blk[c] = last_sb;
    tgt_blk[c] = last_tb;
  }
  const int64_t used = ((chunk + 1 + group - 1) / group) * group;
  return used <= budget ? used : -1;
}

// Count-only twin of gp_pair_plan: the run-aligned chunk total this
// direction needs (the dataset's padding-config derivation walks every
// batch once at load time). No output arrays, no budget.
int64_t gp_pair_plan_count(const int32_t* src, const int32_t* tgt, int64_t n,
                           int64_t group, int64_t blk, int64_t e_c) {
  if (n == 0) return 0;
  int shift = 0;
  while ((int64_t{1} << shift) < blk) ++shift;
  const bool pow2 = (int64_t{1} << shift) == blk;
  int32_t max_sb = 0, max_tb = 0;
  std::vector<int32_t> sbv(n), tbv(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t sb = pow2 ? (src[i] >> shift)
                            : src[i] / static_cast<int32_t>(blk);
    const int32_t tb = pow2 ? (tgt[i] >> shift)
                            : tgt[i] / static_cast<int32_t>(blk);
    sbv[i] = sb;
    tbv[i] = tb;
    if (sb > max_sb) max_sb = sb;
    if (tb > max_tb) max_tb = tb;
  }
  const int64_t sb_span = static_cast<int64_t>(max_sb) + 1;
  const int64_t num_keys = (static_cast<int64_t>(max_tb) + 1) * sb_span;
  // Per-pair edge counts + per-run chunk sums (no per-edge sort needed).
  std::vector<int64_t> per_key(num_keys, 0);
  for (int64_t i = 0; i < n; ++i)
    ++per_key[static_cast<int64_t>(tbv[i]) * sb_span + sbv[i]];
  int64_t total = 0;
  for (int64_t tb = 0; tb <= max_tb; ++tb) {
    int64_t run = 0;
    for (int64_t sb = 0; sb < sb_span; ++sb) {
      const int64_t c = per_key[tb * sb_span + sb];
      if (c) run += (c + e_c - 1) / e_c;
    }
    total += ((run + group - 1) / group) * group;
  }
  return total;
}

// Locality-aware node reordering: reverse Cuthill-McKee over the undirected
// union of all edge types (self loops dropped). ``edges`` is the int32
// [num_edges, 2] concatenation of every type's edge list; writes ``perm``
// (int32 [num_nodes]) with perm[new_pos] = old_id. Components are entered
// in increasing (degree, id) order of their seed; each BFS level visits
// unvisited neighbours deduplicated and sorted by (degree, id) — exactly
// the numpy fallback's semantics (parallel/reorder.py), so the two are
// byte-identical and equivalence-tested.
void gp_rcm_order(const int32_t* edges, int64_t num_edges, int64_t num_nodes,
                  int32_t* perm) {
  std::vector<int64_t> deg(num_nodes, 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v) continue;
    ++deg[u];
    ++deg[v];
  }
  std::vector<int64_t> off(num_nodes + 1, 0);
  for (int64_t i = 0; i < num_nodes; ++i) off[i + 1] = off[i] + deg[i];
  std::vector<int32_t> adj(off[num_nodes]);
  std::vector<int64_t> fill(off.begin(), off.end() - 1);
  for (int64_t e = 0; e < num_edges; ++e) {
    const int32_t u = edges[2 * e], v = edges[2 * e + 1];
    if (u == v) continue;
    adj[fill[u]++] = v;
    adj[fill[v]++] = u;
  }
  std::vector<int32_t> seeds(num_nodes);
  std::iota(seeds.begin(), seeds.end(), 0);
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](int32_t a, int32_t b) { return deg[a] < deg[b]; });
  std::vector<uint8_t> seen(num_nodes, 0);
  std::vector<int32_t> nb;
  int64_t pos = 0;
  for (const int32_t start : seeds) {
    if (seen[start]) continue;
    seen[start] = 1;
    perm[pos++] = start;
    int64_t head = pos - 1;
    while (head < pos) {
      const int32_t u = perm[head++];
      nb.clear();
      for (int64_t i = off[u]; i < off[u + 1]; ++i) {
        const int32_t w = adj[i];
        if (!seen[w]) {
          seen[w] = 1;  // marks dedupe within this neighbour list too
          nb.push_back(w);
        }
      }
      std::sort(nb.begin(), nb.end(), [&](int32_t a, int32_t b) {
        return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
      });
      for (const int32_t w : nb) perm[pos++] = w;
    }
  }
  std::reverse(perm, perm + num_nodes);
}

}  // extern "C"
