// graphcore: native host-side graph preprocessing for plnlp_tpu_torch.
//
// The one-time host work before training (coalesce, blocking for the
// scatter-matmul K1, densify, and the label-propagation and BFS reorders)
// in C++ with OpenMP.  Every function gives the bits of the NumPy version
// it replaces (graph.py, dense.py, ops/tile_spmm.py, parallel/partition.py),
// which stays as the plain version the tests hold it against.
//
// Build (plnlp_tpu_torch/native.py does it at first use):
//   g++ -O3 -march=native -fopenmp -shared -fPIC graphcore.cpp -o libgraphcore.so
// ABI: plain C, consumed through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#define SORT __gnu_parallel::sort
#else
#define SORT std::sort
#endif

extern "C" {

// Sort edges by (dst, src) and merge duplicates, summing weights in double
// in input order (the order of NumPy's stable argsort and np.add.at), then
// rounding each sum to float once.  src/dst: int64[e]; w: double[e] or
// nullptr (ones).  out_src/out_dst: int64[e]; out_w: float32[e].  Returns
// the unique count.
int64_t coalesce_add(const int64_t* src, const int64_t* dst, const double* w,
                     int64_t e, int64_t n, int64_t* out_src,
                     int64_t* out_dst, float* out_w) {
  if (e == 0) return 0;
  struct Edge {
    int64_t key;
    int64_t idx;
  };
  std::vector<Edge> edges(static_cast<size_t>(e));
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < e; ++i) {
    edges[i].key = dst[i] * n + src[i];
    edges[i].idx = i;
  }
  // (key, idx) is unique, so the parallel sort gives the stable order
  SORT(edges.begin(), edges.end(), [](const Edge& a, const Edge& b) {
    return a.key < b.key || (a.key == b.key && a.idx < b.idx);
  });
  int64_t m = 0;
  int64_t cur_key = edges[0].key;
  // each sum starts at +0.0, as np.add.at's does (so -0.0 becomes +0.0)
  double acc = 0.0 + (w ? w[edges[0].idx] : 1.0);
  for (int64_t i = 1; i < e; ++i) {
    double wi = w ? w[edges[i].idx] : 1.0;
    if (edges[i].key == cur_key) {
      acc += wi;
    } else {
      out_dst[m] = cur_key / n;
      out_src[m] = cur_key % n;
      out_w[m] = static_cast<float>(acc);
      ++m;
      cur_key = edges[i].key;
      acc = 0.0 + wi;
    }
  }
  out_dst[m] = cur_key / n;
  out_src[m] = cur_key % n;
  out_w[m] = static_cast<float>(acc);
  return m + 1;
}

// CSR row pointers over receivers (dst), dst sorted ascending.
void build_indptr(const int64_t* dst, int64_t e, int64_t n, int32_t* indptr) {
  std::memset(indptr, 0, sizeof(int32_t) * (n + 1));
  for (int64_t i = 0; i < e; ++i) indptr[dst[i] + 1]++;
  for (int64_t v = 0; v < n; ++v) indptr[v + 1] += indptr[v];
}

// Dense adjacency: a[dst, src] = sum of w over the cell's edges, summed in
// double in edge order and rounded once (NumPy's bincount then astype);
// deg[dst] = in-edge count.  Edges sorted by dst (one row at a time).
// a: float32[n*n] and deg: int32[n], both pre-zeroed by the caller.
void densify(const int64_t* src, const int64_t* dst, const float* w,
             int64_t e, int64_t n, float* a, int32_t* deg) {
  std::vector<double> row(static_cast<size_t>(n), 0.0);
  std::vector<uint8_t> hit(static_cast<size_t>(n), 0);
  std::vector<int64_t> cols;
  int64_t i = 0;
  while (i < e) {
    const int64_t d = dst[i];
    cols.clear();
    for (; i < e && dst[i] == d; ++i) {
      const int64_t s = src[i];
      if (!hit[s]) {
        hit[s] = 1;
        cols.push_back(s);
      }
      row[s] += w ? static_cast<double>(w[i]) : 1.0;
      deg[d]++;
    }
    for (int64_t s : cols) {
      a[d * n + s] = static_cast<float>(row[s]);
      row[s] = 0.0;
      hit[s] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Sub-blocks of the blocked scatter-matmul (graph._blocks_np): edges sorted
// by dst; every row-block of R destination rows is cut into ceil(cnt/B)
// sub-blocks of B edge slots, at least one, so every row-block is named.

// Number of sub-blocks.  indptr: int32[n+1].
int64_t blocks_count(const int32_t* indptr, int64_t n, int64_t R, int64_t B) {
  int64_t nrb = (n + R - 1) / R;
  int64_t nblk = 0;
  for (int64_t rb = 0; rb < nrb; ++rb) {
    int64_t lo = indptr[rb * R];
    int64_t hi = indptr[std::min((rb + 1) * R, n)];
    int64_t nb = (hi - lo + B - 1) / B;
    nblk += nb > 0 ? nb : 1;
  }
  return nblk;
}

// Fill blk_src/blk_w/blk_local (int32/float32/int32, nblk*B, pre-zeroed)
// and blk_rowblock (int32[nblk]).
void blocks_fill(const int64_t* senders, const int64_t* receivers,
                 const float* w, const int32_t* indptr, int64_t n, int64_t R,
                 int64_t B, int32_t* blk_src, float* blk_w, int32_t* blk_local,
                 int32_t* blk_rowblock) {
  int64_t nrb = (n + R - 1) / R;
  std::vector<int64_t> starts(static_cast<size_t>(nrb) + 1, 0);
  for (int64_t rb = 0; rb < nrb; ++rb) {
    int64_t lo = indptr[rb * R];
    int64_t hi = indptr[std::min((rb + 1) * R, n)];
    int64_t nb = (hi - lo + B - 1) / B;
    starts[rb + 1] = starts[rb] + (nb > 0 ? nb : 1);
  }
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t rb = 0; rb < nrb; ++rb) {
    int64_t lo = indptr[rb * R];
    int64_t hi = indptr[std::min((rb + 1) * R, n)];
    int64_t base = starts[rb];
    for (int64_t k = base; k < starts[rb + 1]; ++k)
      blk_rowblock[k] = static_cast<int32_t>(rb);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t slot = base * B + (i - lo);
      blk_src[slot] = static_cast<int32_t>(senders[i]);
      blk_w[slot] = w ? w[i] : 1.0f;
      blk_local[slot] = static_cast<int32_t>(receivers[i] - rb * R);
    }
  }
}

// ---------------------------------------------------------------------------
// Reorders over an undirected CSR built by the caller: label propagation
// (the community order of the hybrid operand, ops/tile_spmm.py) and
// level-synchronous BFS (parallel/partition.py 'bfs').

// One synchronous sweep per round: every node adopts its most frequent
// neighbor label, ties to the smallest label; isolated nodes keep theirs.
// labels: int64[n] in/out (the caller starts it at arange).  Returns the
// rounds run (it stops at a fixed point).
int64_t label_prop(const int32_t* indptr, const int32_t* indices, int64_t n,
                   int64_t rounds, int64_t* labels) {
  std::vector<int64_t> next(static_cast<size_t>(n));
  int64_t r = 0;
  for (; r < rounds; ++r) {
    bool changed = false;
#pragma omp parallel
    {
      std::vector<int64_t> scratch;
#pragma omp for schedule(dynamic, 1024) reduction(|| : changed)
      for (int64_t v = 0; v < n; ++v) {
        int64_t lo = indptr[v], hi = indptr[v + 1];
        if (lo == hi) {
          next[v] = labels[v];
          continue;
        }
        scratch.clear();
        for (int64_t i = lo; i < hi; ++i) scratch.push_back(labels[indices[i]]);
        std::sort(scratch.begin(), scratch.end());
        // the longest run; in ascending order the first best run has the
        // smallest label (strict > keeps it)
        int64_t best_lab = scratch[0], best_cnt = 0;
        int64_t cur_lab = scratch[0], cur_cnt = 0;
        for (size_t i = 0; i < scratch.size(); ++i) {
          if (scratch[i] == cur_lab) {
            ++cur_cnt;
          } else {
            if (cur_cnt > best_cnt) { best_cnt = cur_cnt; best_lab = cur_lab; }
            cur_lab = scratch[i];
            cur_cnt = 1;
          }
        }
        if (cur_cnt > best_cnt) { best_cnt = cur_cnt; best_lab = cur_lab; }
        next[v] = best_lab;
        if (best_lab != labels[v]) changed = true;
      }
    }
    std::memcpy(labels, next.data(), sizeof(int64_t) * n);
    if (!changed) { ++r; break; }
  }
  return r;
}

// Level-synchronous BFS: each level is the sorted unique unvisited
// neighbors of the last; a new component starts at the first unvisited
// seed.  seeds: int64[n] in priority order; order: int64[n] output.
void bfs_order(const int32_t* indptr, const int32_t* indices, int64_t n,
               const int64_t* seeds, int64_t* order) {
  std::vector<uint8_t> visited(static_cast<size_t>(n), 0);
  std::vector<int64_t> frontier, nbr;
  int64_t pos = 0, si = 0;
  while (pos < n) {
    while (si < n && visited[seeds[si]]) ++si;
    frontier.assign(1, seeds[si]);
    visited[seeds[si]] = 1;
    while (!frontier.empty()) {
      for (int64_t v : frontier) order[pos++] = v;
      nbr.clear();
      for (int64_t v : frontier)
        for (int64_t i = indptr[v]; i < indptr[v + 1]; ++i)
          nbr.push_back(indices[i]);
      std::sort(nbr.begin(), nbr.end());
      nbr.erase(std::unique(nbr.begin(), nbr.end()), nbr.end());
      frontier.clear();
      for (int64_t u : nbr)
        if (!visited[u]) {
          visited[u] = 1;
          frontier.push_back(u);
        }
    }
  }
}

}  // extern "C"
