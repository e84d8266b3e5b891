// nlsh_tpu native HNSW baseline.
//
// The reference's recall/QPS yardstick is the external C++ hnswlib
// (reference nlsh/trainers/hnsw.py:7,28-34: cosine space, M=10,
// ef_construction=500, ef=40) — a package this image cannot install
// (no pip/network).  This is an independent implementation of the
// HNSW algorithm (Malkov & Yashunin 2016, arXiv:1603.09320) written
// for that baseline role: Algorithm 1/2 insertion with the
// Algorithm 4 neighbor-selection heuristic (extendCandidates=false,
// keepPrunedConnections=true) and Algorithm 5 layered search.
//
// Scope decisions (it is a measurement yardstick, not a product
// engine): single-threaded (this image exposes ONE core), float32
// only, no deletes, no persistence.  The searcher reports per-query
// visited-node counts so `query_size` is comparable with the learned
// index's candidate counts — the reference relied on an hnswlib FORK
// for exactly this (nlsh/trainers/hnsw.py:52).
//
// Exported as plain extern "C" symbols (ctypes path, zero deps),
// compiled into libnlsh_native.so next to the packing kernels.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

namespace {

// (distance, node) pairs ordered for the two heap roles in Alg. 2:
// candidates = min-heap by distance, result set W = max-heap.
using DistNode = std::pair<float, uint32_t>;

struct HnswIndex {
  int dim = 0;
  int space = 0;  // 0 = cosine (normalize + 1-dot), 1 = squared L2
  uint32_t M = 10;
  uint32_t M0 = 20;         // level-0 degree bound (2*M, per paper)
  uint32_t ef_construction = 500;
  double inv_log_M = 1.0;   // mL = 1/ln(M): level sampling scale
  int64_t max_elements = 0;
  int64_t n = 0;            // elements inserted so far
  int top_level = -1;
  uint32_t entry_point = 0;

  std::vector<float> vecs;        // (max_elements, dim), normalized if cosine
  std::vector<int32_t> levels;    // per-node max level
  // level 0 adjacency: flat (M0+1)-slot blocks, slot 0 = degree
  std::vector<uint32_t> l0;
  // levels >= 1: per node, (level_count * (M+1)) flat slots
  std::vector<std::vector<uint32_t>> upper;

  // search scratch: epoch-tagged visited set (single-threaded)
  std::vector<uint32_t> visited;
  uint32_t epoch = 0;
  // DISTANCE EVALUATIONS since last reset — not unique nodes: the
  // upper-layer greedy descent in search() does not consult the epoch
  // set, so a node it scored can be rescored by the layer-0
  // search_layer and counted twice.  Upper layers hold ~n/M of the
  // nodes, so the overcount is a small fraction of ef; the channel is
  // the work analogue of the learned index's candidate count.
  uint64_t visit_count = 0;

  std::mt19937_64 rng;

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (space == 0) {
      for (int i = 0; i < dim; ++i) acc += a[i] * b[i];
      return 1.f - acc;
    }
    for (int i = 0; i < dim; ++i) {
      float d = a[i] - b[i];
      acc += d * d;
    }
    return acc;
  }

  const float* vec(uint32_t id) const { return vecs.data() + int64_t(id) * dim; }

  uint32_t* links(uint32_t id, int level) {
    if (level == 0) return l0.data() + int64_t(id) * (M0 + 1);
    return upper[id].data() + int64_t(level - 1) * (M + 1);
  }

  void begin_search() {
    if (++epoch == 0) {  // tag wraparound: clear once every 2^32 searches
      std::fill(visited.begin(), visited.end(), 0u);
      epoch = 1;
    }
  }

  bool seen(uint32_t id) {
    if (visited[id] == epoch) return true;
    visited[id] = epoch;
    return false;
  }

  // Algorithm 2: ef-bounded best-first search of one layer.  Returns W
  // as a max-heap (worst on top).
  std::priority_queue<DistNode> search_layer(const float* q, uint32_t enter,
                                             float enter_d, int level,
                                             uint32_t ef) {
    std::priority_queue<DistNode> result;                 // max-heap
    std::priority_queue<DistNode, std::vector<DistNode>,
                        std::greater<DistNode>> cand;     // min-heap
    begin_search();
    seen(enter);
    ++visit_count;
    result.emplace(enter_d, enter);
    cand.emplace(enter_d, enter);
    while (!cand.empty()) {
      auto [d, c] = cand.top();
      if (d > result.top().first && result.size() >= ef) break;
      cand.pop();
      const uint32_t* nb = links(c, level);
      const uint32_t deg = nb[0];
      for (uint32_t j = 1; j <= deg; ++j) {
        const uint32_t e = nb[j];
        if (seen(e)) continue;
        const float de = dist(q, vec(e));
        ++visit_count;
        if (result.size() < ef || de < result.top().first) {
          cand.emplace(de, e);
          result.emplace(de, e);
          if (result.size() > ef) result.pop();
        }
      }
    }
    return result;
  }

  static std::vector<DistNode> drain_ascending(
      std::priority_queue<DistNode>& W) {
    std::vector<DistNode> byDist(W.size());
    for (int64_t i = int64_t(W.size()) - 1; i >= 0; --i) {
      byDist[i] = W.top();
      W.pop();
    }
    return byDist;
  }

  // Algorithm 4: heuristic selection of up to m neighbors from an
  // ascending-distance candidate list — keep a candidate only if it is
  // closer to the base point than to every already-kept neighbor
  // (diversity rule), then backfill with the nearest pruned ones
  // (keepPruned).
  void select_neighbors(const std::vector<DistNode>& byDist,
                        uint32_t m, std::vector<uint32_t>& out) {
    out.clear();
    std::vector<DistNode> pruned;
    for (const auto& [d, c] : byDist) {
      if (out.size() >= m) break;
      bool keep = true;
      for (uint32_t s : out) {
        if (dist(vec(c), vec(s)) < d) {  // closer to a kept neighbor
          keep = false;
          break;
        }
      }
      if (keep) out.push_back(c);
      else pruned.emplace_back(d, c);
    }
    for (const auto& [d, c] : pruned) {
      if (out.size() >= m) break;
      out.push_back(c);
    }
  }

  // Algorithm 1.
  void insert(uint32_t id) {
    const float* q = vec(id);
    std::exponential_distribution<double> expd(1.0);
    const int l = int(expd(rng) * inv_log_M);
    levels[id] = l;
    if (l >= 1)
      upper[id].assign(size_t(l) * (M + 1), 0u);

    if (top_level < 0) {  // first element
      entry_point = id;
      top_level = l;
      return;
    }

    uint32_t ep = entry_point;
    float ep_d = dist(q, vec(ep));
    // greedy descend through layers above the insertion level
    for (int lev = top_level; lev > l; --lev) {
      bool moved = true;
      while (moved) {
        moved = false;
        const uint32_t* nb = links(ep, lev);
        for (uint32_t j = 1; j <= nb[0]; ++j) {
          const float d = dist(q, vec(nb[j]));
          if (d < ep_d) {
            ep_d = d;
            ep = nb[j];
            moved = true;
          }
        }
      }
    }
    // connect on layers min(l, top_level) .. 0
    for (int lev = std::min(l, top_level); lev >= 0; --lev) {
      auto W = search_layer(q, ep, ep_d, lev, ef_construction);
      const std::vector<DistNode> byDist = drain_ascending(W);
      // next layer's entry point: the best element found here
      ep = byDist.front().second;
      ep_d = byDist.front().first;

      const uint32_t cap = lev == 0 ? M0 : M;
      std::vector<uint32_t> neigh;
      select_neighbors(byDist, M, neigh);
      uint32_t* nb = links(id, lev);
      nb[0] = uint32_t(neigh.size());
      for (uint32_t j = 0; j < neigh.size(); ++j) nb[j + 1] = neigh[j];
      for (uint32_t e : neigh) {  // reverse links, prune on overflow
        uint32_t* enb = links(e, lev);
        if (enb[0] < cap) {
          enb[0] += 1;
          enb[enb[0]] = id;
        } else {
          // adjacency full: re-select cap neighbors from cap+1
          std::priority_queue<DistNode> W2;
          W2.emplace(dist(vec(e), vec(id)), id);
          for (uint32_t j = 1; j <= enb[0]; ++j)
            W2.emplace(dist(vec(e), vec(enb[j])), enb[j]);
          const std::vector<DistNode> by2 = drain_ascending(W2);
          std::vector<uint32_t> kept;
          select_neighbors(by2, cap, kept);
          enb[0] = uint32_t(kept.size());
          for (uint32_t j = 0; j < kept.size(); ++j) enb[j + 1] = kept[j];
        }
      }
    }
    if (l > top_level) {
      top_level = l;
      entry_point = id;
    }
  }

  // Algorithm 5.
  void search(const float* q, int k, uint32_t ef, int64_t* out_ids,
              float* out_dists, int64_t* out_visited) {
    visit_count = 0;
    if (n == 0) {
      for (int i = 0; i < k; ++i) {
        out_ids[i] = -1;
        out_dists[i] = INFINITY;
      }
      if (out_visited) *out_visited = 0;
      return;
    }
    uint32_t ep = entry_point;
    float ep_d = dist(q, vec(ep));
    ++visit_count;
    for (int lev = top_level; lev >= 1; --lev) {
      bool moved = true;
      while (moved) {
        moved = false;
        const uint32_t* nb = links(ep, lev);
        for (uint32_t j = 1; j <= nb[0]; ++j) {
          const float d = dist(q, vec(nb[j]));
          ++visit_count;
          if (d < ep_d) {
            ep_d = d;
            ep = nb[j];
            moved = true;
          }
        }
      }
    }
    auto W = search_layer(q, ep, ep_d, 0, std::max<uint32_t>(ef, k));
    const std::vector<DistNode> top = drain_ascending(W);
    for (int i = 0; i < k; ++i) {
      if (i < int(top.size())) {
        out_ids[i] = top[i].second;
        out_dists[i] = top[i].first;
      } else {
        out_ids[i] = -1;
        out_dists[i] = INFINITY;
      }
    }
    if (out_visited) *out_visited = int64_t(visit_count);
  }
};

}  // namespace

extern "C" {

void* nlsh_hnsw_create(int32_t dim, int32_t space, int64_t max_elements,
                       int32_t M, int32_t ef_construction, uint64_t seed) {
  // node ids are uint32 throughout (insert(), adjacency slots): a
  // larger capacity would silently wrap ids and corrupt the graph
  if (max_elements <= 0 || max_elements >= int64_t(UINT32_MAX)) return nullptr;
  auto* h = new HnswIndex();
  h->dim = dim;
  h->space = space;
  if (M < 2) M = 2;  // mL = 1/ln(M) diverges at M=1
  h->M = uint32_t(M);
  h->M0 = uint32_t(2 * M);
  h->ef_construction = uint32_t(ef_construction);
  h->inv_log_M = 1.0 / std::log(double(M));
  h->max_elements = max_elements;
  h->vecs.resize(size_t(max_elements) * dim);
  h->levels.assign(max_elements, 0);
  h->l0.assign(size_t(max_elements) * (h->M0 + 1), 0u);
  h->upper.resize(max_elements);
  h->visited.assign(max_elements, 0u);
  h->rng.seed(seed);
  return h;
}

void nlsh_hnsw_free(void* handle) { delete static_cast<HnswIndex*>(handle); }

// Insert n vectors with consecutive ids n_cur..n_cur+n-1 (the Python
// wrapper maps external labels).  Returns the new element count, or -1
// on overflow.
int64_t nlsh_hnsw_add(void* handle, const float* data, int64_t n) {
  auto* h = static_cast<HnswIndex*>(handle);
  if (h->n + n > h->max_elements) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t id = h->n;
    float* dst = h->vecs.data() + id * h->dim;
    std::memcpy(dst, data + i * h->dim, sizeof(float) * h->dim);
    if (h->space == 0) {  // cosine: store unit vectors, dist = 1 - dot
      float nrm = 0.f;
      for (int d = 0; d < h->dim; ++d) nrm += dst[d] * dst[d];
      nrm = std::sqrt(nrm);
      if (nrm > 0.f)
        for (int d = 0; d < h->dim; ++d) dst[d] /= nrm;
    }
    h->n += 1;
    h->insert(uint32_t(id));
  }
  return h->n;
}

int64_t nlsh_hnsw_count(void* handle) {
  return static_cast<HnswIndex*>(handle)->n;
}

// Batched query: out_ids/out_dists are (nq, k); out_visited (nq) gets
// the per-query scored-node count (the query_size analogue).
void nlsh_hnsw_search(void* handle, const float* queries, int64_t nq,
                      int32_t k, int32_t ef, int64_t* out_ids,
                      float* out_dists, int64_t* out_visited) {
  auto* h = static_cast<HnswIndex*>(handle);
  std::vector<float> qbuf(h->dim);
  for (int64_t i = 0; i < nq; ++i) {
    const float* q = queries + i * h->dim;
    if (h->space == 0) {
      float nrm = 0.f;
      for (int d = 0; d < h->dim; ++d) nrm += q[d] * q[d];
      nrm = std::sqrt(nrm);
      if (nrm > 0.f) {
        for (int d = 0; d < h->dim; ++d) qbuf[d] = q[d] / nrm;
        q = qbuf.data();
      }
    }
    h->search(q, k, uint32_t(ef), out_ids + i * k, out_dists + i * k,
              out_visited ? out_visited + i : nullptr);
  }
}

}  // extern "C"
