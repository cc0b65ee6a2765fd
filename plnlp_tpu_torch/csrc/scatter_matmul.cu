// Blocked-CSR weighted scatter-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel plnlp_tpu/ops/pallas_spmm.py::_kernel.  Computes
//
//     out[rb*R + blk_local[e]] += blk_weight[e] * x[blk_src[e]]
//
// over every edge slot e of every sub-block of row-block rb, with rows that
// no edge reaches equal to zero, for x and out in float32 or bfloat16
// (plnlp_scatter_matmul_f32 and _bf16 are the two entry points).  In
// bfloat16 it computes what the TPU kernel computes with bf16 feats: each
// weight rounded to bf16 first (the kernel casts its weighted one-hot to
// feats' dtype), the products bf16 x bf16 (exact in f32) summed in f32, and
// each output row rounded to bf16 once.  The carries stay f32, so a row
// that crosses runs is rounded once too, at the second pass's store.
// Sub-blocks of row-block rb are
// [blk_rowptr[rb], blk_rowptr[rb+1]); each holds B edge slots, and slots
// with weight 0 are padding.  Only sub-blocks in [blk_rowptr[0],
// blk_rowptr[n_rb]) are read, so a row pointer that empties some row-blocks
// leaves their rows zero.
//
// Design: edge-balanced runs.  The TPU kernel walks sub-blocks in grid order
// and carries one f32 accumulator per row-block.  On a power-law graph one
// row-block may hold a fifth of all edge slots, so a CUDA block per
// row-block serializes on it.  Here the slot array is read as what it is,
// a destination-sorted COO (row-blocks ascend, rows ascend inside a
// row-block; only the weight-0 padding at a row-block's tail breaks the
// order, and it is skipped), and cut into runs of kRun slots:
//
//   pass 1  one warp per run and column slice (gridDim.y slices D).  A warp
//           reads its slots' metadata 32 at a time (one coalesced load of
//           each array), finds each slot's row-block from blk_rowptr (a
//           binary search at the run's start, then a forward walk), and
//           gathers the live slots' source rows.  The running row sum stays
//           in registers.  A row that starts and ends inside the run is
//           written to out once; the run's first row and its last row may
//           continue in the neighbouring runs, so they go to a carry buffer
//           (2 rows a run, f32 whatever the element type), with the run's
//           first and last row index.  A run with one row writes one carry.
//   pass 2  one warp per run: the run that holds a row's first carry adds
//           the carries of the following runs that continue the row, in
//           run order, and writes the row.  No atomics: the result is the
//           same bit for bit on every launch.
//
// f32 (plnlp_scatter_matmul_f32): 256 columns a warp, 8 a lane (two
// 16-byte loads, columns c0 + 4 lane and c0 + 128 + 4 lane), kUnroll rows
// in flight; out comes zeroed from the wrapper (torch.zeros, 0.07 ms at
// the collab shape) and the passes write only rows that have a live slot.
//
// bf16 (plnlp_scatter_matmul_bf16), redesigned for the H100: the same
// runs, carries and sums, column for column, so the same bits as the f32
// design's bf16 instantiation before it, 256 columns a warp and 8 a lane
// (one 16-byte load, columns c0 + 8 lane; the f32 carries in the same
// layout), with
//   - each 32-slot batch's metadata loaded a batch ahead, every lane loading
//     (at slot min(e, s_end - 1)), so no load waits on another's value;
//   - the batch's live slots compacted (src, weight, row) into shared memory
//     in slot order, and kUnrollBf of their row gathers issued, raw, before
//     the first is unpacked and added (an unpack next to its load made the
//     compiler wait on each load in turn);
//   - out from torch.empty, with no memset: pass 1 sets a bit for every row
//     it reaches (a bitmap after the run rows in the scratch, cleared by one
//     cudaMemsetAsync of out_rows / 8 bytes), and in pass 2 warp w also
//     writes exact zeros to the rows of word w whose bit is clear, so every
//     warp zeroes at most 32 rows however the unreached rows lie.
//
// Bound on the H100.  Compulsory traffic is x and out once each plus the
// metadata (12 bytes a slot): about 0.5 GB in f32 at the collab shape (N =
// 235,868, D = 256), 0.15 ms at 3.35 TB/s; 0.27 GB in bf16, 0.08 ms.  Each
// live slot gathers one source row, E * D * 4 bytes (2.3 GB; 1.15 GB in
// bf16): the sources of a power-law graph's edges are spread over all of x
// (241 MB; 120.8 MB in bf16, 2.4 times the 50 MB L2), so the gather sets
// the time.  The f32 design keeps every SM busy on it whatever the degree
// skew (every warp gets kRun slots) and reads each slot's metadata once per
// 256-column slice; it runs at HBM speed, 0.71 ms.  The bf16 design keeps
// more gathers in flight and drops the memset: 0.295 ms at the collab
// shape (bound 0.08) against the f32 design's bf16 instantiation's 0.449,
// and 0.050 against 0.096 ms on a shard's residual (chip_sweep_k1.py, one
// H100 80GB HBM3 at 700.00 W; PERF.md has the A/B, and the column-sliced
// sweep that was to keep x's slice in L2 and measured slower at every
// width).  The carry pass moves 2 rows a run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 128;     // edge slots per warp in pass 1
constexpr int kWarps = 4;     // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 256;   // columns per warp: 8 a lane
constexpr int kUnroll = 4;    // source rows in flight per warp
// bf16: live slots in flight per warp, and blocks an SM (measured on the
// H100: chip_sweep_k1.py)
constexpr int kUnrollBf = 4;
constexpr int kMinBlocksBf = 6;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

// W contiguous values at p (16-byte aligned) into v[off .. off+W), and back
template <int W>
__device__ __forceinline__ void load_run(const float* p, float (&v)[8], int off) {
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[off + 4 * k] = a.x; v[off + 4 * k + 1] = a.y;
    v[off + 4 * k + 2] = a.z; v[off + 4 * k + 3] = a.w;
  }
}
template <int W>
__device__ __forceinline__ void store_run(float* p, const float (&v)[8], int off) {
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    reinterpret_cast<float4*>(p)[k] = make_float4(v[off + 4 * k], v[off + 4 * k + 1],
                                                  v[off + 4 * k + 2], v[off + 4 * k + 3]);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(b)) << 16);
}
template <int W>
__device__ __forceinline__ void store_run(bf16* p, const float (&v)[8], int off) {
  static_assert(W == 8, "a bf16 run is one 16-byte store");
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[off], v[off + 1]), pack2(v[off + 2], v[off + 3]),
                 pack2(v[off + 4], v[off + 5]), pack2(v[off + 6], v[off + 7]));
}

// A lane's 8 columns of the slice that starts at c0.  With VEC (d % W == 0,
// 16-byte aligned rows) runs of W columns, W = 16 bytes of the kernel's
// element type (4 for f32, 8 for bf16): value j is column
// c0 + 32*W*(j/W) + W*lane + j%W; otherwise column c0 + lane + 32*j.
// Columns at or past d read 0 and are not written.  Loads read f32 (x of
// the f32 kernel, and the carries in the element type's layout); stores
// write U, the buffer's type.
template <int W, bool VEC>
__device__ __forceinline__ void load_cols(const float* row, int c0, int lane, int d,
                                          float (&v)[8]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 8 / W; ++h) {
      const int c = c0 + 32 * W * h + W * lane;
      if (c < d) {
        load_run<W>(row + c, v, W * h);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) v[W * h + i] = 0.f;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane + 32 * j;
      v[j] = c < d ? load1(row + c) : 0.f;
    }
  }
}

template <int W, bool VEC, typename U>
__device__ __forceinline__ void store_cols(U* row, int c0, int lane, int d,
                                           const float (&v)[8]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 8 / W; ++h) {
      const int c = c0 + 32 * W * h + W * lane;
      if (c < d) store_run<W>(row + c, v, W * h);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) store1(row + c, v[j]);
    }
  }
}

// Pass 1.  run_rows[2*run] / [2*run+1] receive the run's first and last
// row (-1 when the run has no live slot); carry row 2*run holds the first
// row's partial sum, carry row 2*run+1 the last row's when it differs.
// At most 80 registers a thread (6 blocks an SM): more warps in flight pay
// more than deeper unrolling (measured on the H100).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 6)
scatter_runs_kernel(const float* __restrict__ x,
                    const int* __restrict__ blk_src,
                    const int* __restrict__ blk_local,
                    const float* __restrict__ blk_weight,
                    const int* __restrict__ blk_rowptr,
                    float* __restrict__ out,
                    float* __restrict__ carry,
                    int* __restrict__ run_rows,
                    int n_runs, int n_rowblocks, int out_rows, int block_rows,
                    int block_edges, int64_t n_slots, int d) {
  constexpr int W = 4;
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (run >= n_runs) return;  // warp-uniform
  const int c0 = blockIdx.y * kSlice;

  // live sub-blocks are [lo, hi); the run's slots [s_begin, s_end)
  const int lo = __ldg(blk_rowptr);
  const int hi = __ldg(blk_rowptr + n_rowblocks);
  const int64_t s_begin = max((int64_t)run * kRun, (int64_t)lo * block_edges);
  const int64_t s_end = min(min((int64_t)run * kRun + kRun, n_slots),
                            (int64_t)hi * block_edges);

  int first = -1, cur = -1;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  if (s_begin < s_end) {
    // row-block of the first slot: the last rb with blk_rowptr[rb] <= sub
    const int sub0 = (int)(s_begin / block_edges);
    int a = 0, b = n_rowblocks - 1;
    while (a < b) {
      const int m = (a + b + 1) >> 1;
      if (__ldg(blk_rowptr + m) <= sub0) a = m; else b = m - 1;
    }
    int rb = a;
    for (int64_t base = s_begin; base < s_end; base += 32) {
      const int64_t e = base + lane;
      const int sub = (int)(min(e, s_end - 1) / block_edges);
      int r = rb;
      while (r + 1 < n_rowblocks && __ldg(blk_rowptr + r + 1) <= sub) ++r;
      rb = __shfl_sync(kFull, r, 31);
      int src = 0, row = 0;
      float w = 0.f;
      if (e < s_end) {
        w = __ldg(blk_weight + e);
        if (w != 0.f) {
          row = r * block_rows + __ldg(blk_local + e);
          src = __ldg(blk_src + e);
          if (row >= out_rows) w = 0.f;
        }
      }
      unsigned live = __ballot_sync(kFull, w != 0.f);
      while (live) {
        int slot[kUnroll];
        float v[kUnroll][8];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          slot[u] = live ? __ffs(live) - 1 : -1;
          live &= live ? live - 1 : 0u;
        }
        // every gather of the batch is issued before the first add
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = slot[u] < 0 ? 0 : slot[u];
          const int s = __shfl_sync(kFull, src, j);
          const float ww = __shfl_sync(kFull, w, j);
          if (slot[u] >= 0) {
            load_cols<W, VEC>(x + (int64_t)s * d, c0, lane, d, v[u]);
#pragma unroll
            for (int c = 0; c < 8; ++c) v[u][c] *= ww;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (slot[u] < 0) break;  // warp-uniform
          const int rr = __shfl_sync(kFull, row, slot[u]);
          if (rr != cur) {
            // cur is the run's first row (may continue from the previous
            // run: a carry) or an interior row (complete: written here)
            if (cur >= 0 && cur == first)
              store_cols<W, VEC>(carry + (int64_t)run * 2 * d, c0, lane, d, acc);
            else if (cur >= 0)
              store_cols<W, VEC>(out + (int64_t)cur * d, c0, lane, d, acc);
            if (first < 0) first = rr;
            cur = rr;
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[c] = 0.f;
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[c] += v[u][c];
        }
      }
    }
  }
  if (cur >= 0)
    store_cols<W, VEC>(carry + ((int64_t)run * 2 + (cur == first ? 0 : 1)) * d, c0, lane,
                       d, acc);
  if (blockIdx.y == 0 && lane == 0) {
    run_rows[2 * run] = first;
    run_rows[2 * run + 1] = cur;
  }
}

// The last row of the nearest run at or before `from` that has a live slot
// (-1 if none), found 32 runs at a time.
__device__ __forceinline__ int last_live_row(const int* __restrict__ run_rows, int from,
                                             int lane) {
  for (int j0 = from; j0 >= 0; j0 -= 32) {
    const int j = j0 - lane;
    const int f = j >= 0 ? __ldg(run_rows + 2 * j) : -1;
    const int l = j >= 0 ? __ldg(run_rows + 2 * j + 1) : -1;
    const unsigned any = __ballot_sync(kFull, f >= 0);
    if (any) return __shfl_sync(kFull, l, __ffs(any) - 1);
  }
  return -1;
}

// Adds to acc the first-row carries of the runs after `run` that continue
// `row`, in run order, and returns.  Runs are scanned 32 at a time; runs
// without a live slot are skipped.  W: the carries' column layout (that of
// the element type).
template <int W, bool VEC>
__device__ void add_continuations(const float* __restrict__ carry,
                                  const int* __restrict__ run_rows, int run, int row,
                                  int n_runs, int c0, int lane, int d, float (&acc)[8]) {
  for (int j0 = run + 1; j0 < n_runs; j0 += 32) {
    const int j = j0 + lane;
    int f = -1, l = -1;
    if (j < n_runs) {
      f = __ldg(run_rows + 2 * j);
      l = __ldg(run_rows + 2 * j + 1);
    }
    unsigned add = __ballot_sync(kFull, f == row);
    // the row ends in the first run that starts past it or leaves it
    const unsigned stop = __ballot_sync(kFull, f > row || (f == row && l != row));
    if (stop) {
      const int s = __ffs(stop) - 1;
      add &= s == 31 ? kFull : (2u << s) - 1u;
    }
    while (add) {
      int k[kUnroll];
      float v[kUnroll][8];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        k[u] = add ? __ffs(add) - 1 : -1;
        add &= add ? add - 1 : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (k[u] >= 0)
          load_cols<W, VEC>(carry + (int64_t)(j0 + k[u]) * 2 * d, c0, lane, d, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k[u] < 0) break;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] += v[u][c];
      }
    }
    if (stop) return;
  }
}

// Pass 2 for run `run`: writes the rows whose first carry it holds, summed
// in f32 (and rounded to T once).  W: the element type's column layout.
template <int W, bool VEC, typename T>
__device__ __forceinline__ void write_carried_rows(const float* __restrict__ carry,
                                                   const int* __restrict__ run_rows,
                                                   T* __restrict__ out, int run, int n_runs,
                                                   int c0, int lane, int d) {
  const int first = __ldg(run_rows + 2 * run);
  const int last = __ldg(run_rows + 2 * run + 1);
  if (first < 0) return;
  const int prev_last = last_live_row(run_rows, run - 1, lane);
  float acc[8];
  if (prev_last != first) {  // this run holds the first carry of `first`
    load_cols<W, VEC>(carry + (int64_t)run * 2 * d, c0, lane, d, acc);
    if (last == first)
      add_continuations<W, VEC>(carry, run_rows, run, first, n_runs, c0, lane, d, acc);
    store_cols<W, VEC>(out + (int64_t)first * d, c0, lane, d, acc);
  }
  if (last != first) {  // and always the first carry of its last row
    load_cols<W, VEC>(carry + ((int64_t)run * 2 + 1) * d, c0, lane, d, acc);
    add_continuations<W, VEC>(carry, run_rows, run, last, n_runs, c0, lane, d, acc);
    store_cols<W, VEC>(out + (int64_t)last * d, c0, lane, d, acc);
  }
}

// Pass 2: one warp per run.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_carries_kernel(const float* __restrict__ carry,
                       const int* __restrict__ run_rows,
                       float* __restrict__ out, int n_runs, int d) {
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (run >= n_runs) return;
  write_carried_rows<4, VEC>(carry, run_rows, out, run, n_runs, blockIdx.y * kSlice,
                             threadIdx.x & 31, d);
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

// A lane's 8 bf16 columns of a slice as loaded (packed in words), so that a
// gather's load is issued with no arithmetic after it: the gathers of a
// batch are then all in flight before the first is used.  VEC: 4 words (one
// 16-byte load, columns c0 + 8 lane); otherwise one bf16 a word (columns
// c0 + lane + 32 j).  Columns at or past d load column 0 of the row instead
// (in bounds); they are never stored.
template <bool VEC>
struct Raw {
  unsigned w[VEC ? 4 : 8];
};

template <bool VEC>
__device__ __forceinline__ Raw<VEC> load_raw(const bf16* row, int c0, int lane, int d) {
  Raw<VEC> r;
  if constexpr (VEC) {
    const int c = c0 + 8 * lane < d ? c0 + 8 * lane : 0;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + c));
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane + 32 * j;
      r.w[j] = __ldg(reinterpret_cast<const unsigned short*>(row + (c < d ? c : 0)));
    }
  }
  return r;
}

template <bool VEC>
__device__ __forceinline__ void unpack_raw(const Raw<VEC>& r, float (&v)[8]) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(r.w[k] << 16);
      v[2 * k + 1] = __uint_as_float(r.w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(r.w[j] << 16);
  }
}

// Pass 1 in bf16, one warp per run and 256-column slice.  The arithmetic is
// pass 1's above, column for column: a row's live slots in slot order, each
// weight rounded to bf16 (as the TPU kernel's one-hot holds it), f32 sums,
// the run's first and last rows to the f32 carries, interior rows rounded
// to bf16 once.  A warp compacts the live slots of each 32 (src, weight,
// row) into shared memory in slot order and keeps kUnrollBf of their row
// slices in flight.  Each row it reaches gets its bit in `reached`.
template <bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf)
scatter_runs_bf16_kernel(const bf16* __restrict__ x, const int* __restrict__ blk_src,
                         const int* __restrict__ blk_local,
                         const float* __restrict__ blk_weight,
                         const int* __restrict__ blk_rowptr, bf16* __restrict__ out,
                         float* __restrict__ carry, int* __restrict__ run_rows,
                         unsigned* __restrict__ reached, int n_runs, int n_rowblocks,
                         int out_rows, int block_rows, int block_edges, int64_t n_slots,
                         int d) {
  constexpr int W = 8;
  __shared__ int4 live_all[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int run = blockIdx.x * kWarps + warp;
  if (run >= n_runs) return;  // warp-uniform
  int4* live_slots = live_all[warp];
  const int c0 = blockIdx.y * kSlice;
  const bool mark = blockIdx.y == 0 && lane == 0;

  const int lo = __ldg(blk_rowptr);
  const int hi = __ldg(blk_rowptr + n_rowblocks);
  const int64_t s_begin = max((int64_t)run * kRun, (int64_t)lo * block_edges);
  const int64_t s_end = min(min((int64_t)run * kRun + kRun, n_slots),
                            (int64_t)hi * block_edges);

  int first = -1, cur = -1;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  if (s_begin < s_end) {
    const int sub0 = (int)(s_begin / block_edges);
    int a = 0, b = n_rowblocks - 1;
    while (a < b) {
      const int m = (a + b + 1) >> 1;
      if (__ldg(blk_rowptr + m) <= sub0) a = m; else b = m - 1;
    }
    int rb = a;
    // each batch's metadata, loaded a batch ahead (every lane loads, at
    // slot min(e, s_end - 1), so no load waits on another)
    float w_next;
    int loc_next, src_next;
    auto fetch = [&](int64_t base) {
      const int64_t e = min(base + lane, s_end - 1);
      w_next = __ldg(blk_weight + e);
      loc_next = __ldg(blk_local + e);
      src_next = __ldg(blk_src + e);
    };
    fetch(s_begin);
    for (int64_t base = s_begin; base < s_end; base += 32) {
      const int64_t e = base + lane;
      const int src = src_next, loc = loc_next;
      float w = e < s_end ? __bfloat162float(__float2bfloat16(w_next)) : 0.f;
      if (base + 32 < s_end) fetch(base + 32);
      const int sub = (int)(min(e, s_end - 1) / block_edges);
      int r = rb;
      while (r + 1 < n_rowblocks && __ldg(blk_rowptr + r + 1) <= sub) ++r;
      rb = __shfl_sync(kFull, r, 31);
      const int row = r * block_rows + loc;
      if (row >= out_rows) w = 0.f;
      const unsigned live = __ballot_sync(kFull, w != 0.f);
      if (w != 0.f)
        live_slots[__popc(live & ((1u << lane) - 1u))] = make_int4(src, __float_as_int(w), row, 0);
      __syncwarp();
      const int n_live = __popc(live);
      for (int u0 = 0; u0 < n_live; u0 += kUnrollBf) {
        Raw<VEC> raw[kUnrollBf];
        float ww[kUnrollBf];
        int rr[kUnrollBf];
        // every gather of the batch is issued before the first add (past
        // the last live slot the loads repeat it and go unused)
#pragma unroll
        for (int u = 0; u < kUnrollBf; ++u) {
          const int4 sl = live_slots[min(u0 + u, n_live - 1)];
          ww[u] = __int_as_float(sl.y);
          rr[u] = sl.z;
          raw[u] = load_raw<VEC>(x + (int64_t)sl.x * d, c0, lane, d);
        }
#pragma unroll
        for (int u = 0; u < kUnrollBf; ++u) {
          if (u0 + u >= n_live) break;  // warp-uniform
          float v[8];
          unpack_raw(raw[u], v);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] *= ww[u];
          if (rr[u] != cur) {
            if (cur >= 0 && cur == first)
              store_cols<W, VEC>(carry + (int64_t)run * 2 * d, c0, lane, d, acc);
            else if (cur >= 0)
              store_cols<W, VEC>(out + (int64_t)cur * d, c0, lane, d, acc);
            if (mark) atomicOr(reached + (rr[u] >> 5), 1u << (rr[u] & 31));
            if (first < 0) first = rr[u];
            cur = rr[u];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] += v[j];
        }
      }
      __syncwarp();
    }
  }
  if (cur >= 0)
    store_cols<W, VEC>(carry + ((int64_t)run * 2 + (cur == first ? 0 : 1)) * d, c0, lane, d,
                       acc);
  if (blockIdx.y == 0 && lane == 0) {
    run_rows[2 * run] = first;
    run_rows[2 * run + 1] = cur;
  }
}

// Pass 2 in bf16: warp w writes the carried rows of run w (pass 2 above),
// and exact zeros to the rows 32 w .. 32 w + 31 whose bit in `reached` is
// clear: rows no live slot reaches.  The grid has max(n_runs, words) warps.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_carries_bf16_kernel(const float* __restrict__ carry,
                            const int* __restrict__ run_rows,
                            const unsigned* __restrict__ reached, bf16* __restrict__ out,
                            int n_runs, int out_rows, int d) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int c0 = blockIdx.y * kSlice;
  const int64_t r0 = (int64_t)w * 32;
  if (r0 < out_rows) {
    unsigned zero = ~__ldg(reached + w);
    if (out_rows - r0 < 32) zero &= (1u << (out_rows - r0)) - 1u;
    const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    while (zero) {
      const int r = __ffs(zero) - 1;
      zero &= zero - 1;
      store_cols<8, VEC>(out + (r0 + r) * d, c0, lane, d, z);
    }
  }
  if (w < n_runs) write_carried_rows<8, VEC>(carry, run_rows, out, w, n_runs, c0, lane, d);
}

template <bool VEC>
void launch(const float* x, const int* blk_src, const int* blk_local,
            const float* blk_weight, const int* blk_rowptr, float* out, float* carry,
            int* run_rows, int n_runs, int n_rowblocks, int out_rows, int block_rows,
            int block_edges, int64_t n_slots, int d, cudaStream_t stream) {
  const dim3 grid((n_runs + kWarps - 1) / kWarps, (d + kSlice - 1) / kSlice);
  scatter_runs_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      x, blk_src, blk_local, blk_weight, blk_rowptr, out, carry, run_rows, n_runs,
      n_rowblocks, out_rows, block_rows, block_edges, n_slots, d);
  scatter_carries_kernel<VEC><<<grid, kThreads, 0, stream>>>(carry, run_rows, out, n_runs, d);
}

template <bool VEC>
void launch_bf16(const bf16* x, const int* blk_src, const int* blk_local,
                 const float* blk_weight, const int* blk_rowptr, bf16* out, float* carry,
                 int* run_rows, int n_runs, int n_rowblocks, int out_rows, int block_rows,
                 int block_edges, int64_t n_slots, int d, cudaStream_t stream) {
  const int slices = (d + kSlice - 1) / kSlice;
  const int words = (out_rows + 31) / 32;
  unsigned* reached = reinterpret_cast<unsigned*>(run_rows + 2 * n_runs);
  cudaMemsetAsync(reached, 0, (size_t)words * sizeof(unsigned), stream);
  scatter_runs_bf16_kernel<VEC><<<dim3((n_runs + kWarps - 1) / kWarps, slices), kThreads, 0,
                                   stream>>>(x, blk_src, blk_local, blk_weight, blk_rowptr, out,
                                             carry, run_rows, reached, n_runs, n_rowblocks,
                                             out_rows, block_rows, block_edges, n_slots, d);
  const int warps = max(n_runs, words);
  scatter_carries_bf16_kernel<VEC><<<dim3((warps + kWarps - 1) / kWarps, slices), kThreads, 0,
                                      stream>>>(carry, run_rows, reached, out, n_runs, out_rows,
                                                d);
}

}  // namespace

// Slots per run: the wrapper sizes the scratch from it (carry: 2 rows of d
// floats a run, f32 whatever the element type; run_rows: 2 ints a run, and
// in bf16 ceil(out_rows / 32) more for the bitmap of reached rows;
// n_runs = ceil(nblk * B / kRun)).
extern "C" int plnlp_scatter_matmul_run_slots() { return kRun; }

// Launch both passes on `stream` and return cudaGetLastError() (0 =
// launched).  The caller guarantees shapes: x (n_src, d), blk_* (nblk,
// block_edges), blk_rowptr (n_rowblocks + 1) non-decreasing with
// n_rowblocks = ceil(out_rows / block_rows), out (out_rows, d), carry
// (2 * n_runs, d) f32, run_rows as above, all contiguous; with vec, d a
// multiple of 16 bytes' worth of elements (4 f32, 8 bf16) and x, out, carry
// 16-byte aligned.  _f32: x and out float32, out zeroed.
extern "C" int plnlp_scatter_matmul_f32(const void* x, const int* blk_src,
                                        const int* blk_local, const float* blk_weight,
                                        const int* blk_rowptr, void* out, float* carry,
                                        int* run_rows, int n_rowblocks, int out_rows,
                                        int block_rows, int nblk, int block_edges, int d,
                                        int vec, cudaStream_t stream) {
  const int64_t n_slots = (int64_t)nblk * block_edges;
  const int n_runs = (int)((n_slots + kRun - 1) / kRun);
  if (n_runs == 0) return 0;
  const float* xt = static_cast<const float*>(x);
  float* ot = static_cast<float*>(out);
  if (vec)
    launch<true>(xt, blk_src, blk_local, blk_weight, blk_rowptr, ot, carry, run_rows, n_runs,
                 n_rowblocks, out_rows, block_rows, block_edges, n_slots, d, stream);
  else
    launch<false>(xt, blk_src, blk_local, blk_weight, blk_rowptr, ot, carry, run_rows, n_runs,
                  n_rowblocks, out_rows, block_rows, block_edges, n_slots, d, stream);
  return (int)cudaGetLastError();
}

// _bf16: x and out bfloat16; out need not be zeroed (the kernel writes
// every row of it).
extern "C" int plnlp_scatter_matmul_bf16(const void* x, const int* blk_src,
                                         const int* blk_local, const float* blk_weight,
                                         const int* blk_rowptr, void* out, float* carry,
                                         int* run_rows, int n_rowblocks, int out_rows,
                                         int block_rows, int nblk, int block_edges, int d,
                                         int vec, cudaStream_t stream) {
  const int64_t n_slots = (int64_t)nblk * block_edges;
  const int n_runs = (int)((n_slots + kRun - 1) / kRun);
  if (n_runs == 0) return 0;
  const bf16* xt = static_cast<const bf16*>(x);
  bf16* ot = static_cast<bf16*>(out);
  if (vec)
    launch_bf16<true>(xt, blk_src, blk_local, blk_weight, blk_rowptr, ot, carry, run_rows,
                      n_runs, n_rowblocks, out_rows, block_rows, block_edges, n_slots, d,
                      stream);
  else
    launch_bf16<false>(xt, blk_src, blk_local, blk_weight, blk_rowptr, ot, carry, run_rows,
                       n_runs, n_rowblocks, out_rows, block_rows, block_edges, n_slots, d,
                       stream);
  return (int)cudaGetLastError();
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
