// Blocked-CSR weighted scatter-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel plnlp_tpu/ops/pallas_spmm.py::_kernel.  Computes
//
//     out[rb*R + blk_local[e]] += blk_weight[e] * x[blk_src[e]]
//
// for x and out in float32 or bfloat16 (the element type T is a template
// parameter; plnlp_scatter_matmul_f32 and _bf16 are the two entry points).
// In bfloat16 it computes what the TPU kernel computes with bf16 feats:
// each weight rounded to bf16 first (the kernel casts its weighted one-hot
// to feats' dtype), the products bf16 x bf16 (exact in f32) summed in f32,
// and each output row rounded to bf16 once.  The carries stay f32, so a
// row that crosses runs is rounded once too, at the second pass's store.
// over every edge slot e of every sub-block of row-block rb, with rows that
// no edge reaches equal to zero.  Sub-blocks of row-block rb are
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
//   pass 1  one warp per run and 256-column slice (gridDim.y slices D).  A
//           warp reads its slots' metadata 32 at a time (one coalesced load
//           of each array), finds each slot's row-block from blk_rowptr
//           (a binary search at the run's start, then a forward walk), and
//           gathers the live slots' source rows, kUnroll rows in flight, a
//           lane holding 8 columns (two 16-byte loads when D % 4 == 0).  The
//           running row sum stays in registers.  A row that starts and ends
//           inside the run is written to out once; the run's first row and
//           its last row may continue in the neighbouring runs, so they go
//           to a carry buffer (2 rows a run), with the run's first and last
//           row index.  A run with one row writes one carry.
//   pass 2  one warp per run: the run that holds a row's first carry adds
//           the carries of the following runs that continue the row, in
//           run order, and writes the row.  No atomics: the result is the
//           same bit for bit on every launch.
//
// Rows no edge reaches: the wrapper allocates out with torch.zeros (one
// memset, 0.07 ms at the collab shape, inside the kernel's time); the two
// passes write only rows that have a live slot.
//
// Bound on the H100.  Compulsory traffic is x and out once each plus the
// metadata (12 bytes a slot): about 0.5 GB at the collab shape (N = 235,868,
// D = 256), 0.15 ms at 3.35 TB/s.  Each live slot gathers one source row
// slice, E * D * 4 bytes (2.3 GB there, 0.69 ms from HBM): the sources of a
// power-law graph's edges are spread over all of x (241 MB, five times the
// 50 MB L2), so most of that gather comes from HBM and sets the time.  The
// design does not cut the gather; it keeps every SM busy on it whatever the
// degree skew (every warp gets kRun slots), keeps kUnroll rows in flight per
// warp, and reads each slot's metadata once per 256-column slice.  The carry
// pass moves 2 rows a run (38 MB at the collab shape).
//
// In bfloat16 x and out move 2 bytes an element: 0.27 GB of compulsory
// traffic at the collab shape (0.08 ms at 3.35 TB/s), and the gather halves
// to E * D * 2 bytes (1.15 GB, 0.34 ms from HBM).  A lane's 8 columns of a
// slice are then one 16-byte load (columns c0 + 8*lane .. +7) where f32
// takes two (c0 + 4*lane and c0 + 128 + 4*lane); the carries, f32, follow
// the same column layout as x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 128;     // edge slots per warp in pass 1
constexpr int kWarps = 4;     // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 256;   // columns per warp: 8 a lane
constexpr int kUnroll = 4;    // source rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// v rounded to the element type T, back in f32 (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16(v));
  return v;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
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
__device__ __forceinline__ void load_run(const bf16* p, float (&v)[8], int off) {
  static_assert(W == 8, "a bf16 run is one 16-byte load");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[off + 2 * k] = __uint_as_float(w[k] << 16);
    v[off + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
template <int W>
__device__ __forceinline__ void store_run(float* p, const float (&v)[8], int off) {
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    reinterpret_cast<float4*>(p)[k] = make_float4(v[off + 4 * k], v[off + 4 * k + 1],
                                                  v[off + 4 * k + 2], v[off + 4 * k + 3]);
}
template <int W>
__device__ __forceinline__ void store_run(bf16* p, const float (&v)[8], int off) {
  static_assert(W == 8, "a bf16 run is one 16-byte store");
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[off + 2 * k])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[off + 2 * k + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane's 8 columns of the slice that starts at c0.  With VEC (d % W == 0,
// 16-byte aligned rows) runs of W columns, W = 16 bytes of the kernel's
// element type (4 for f32, 8 for bf16): value j is column
// c0 + 32*W*(j/W) + W*lane + j%W; otherwise column c0 + lane + 32*j.
// Columns at or past d read 0 and are not written.  U is the buffer's type
// (x and out: the element type; the carries: f32 in the same layout).
template <int W, bool VEC, typename U>
__device__ __forceinline__ void load_cols(const U* row, int c0, int lane, int d,
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
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 6)
scatter_runs_kernel(const T* __restrict__ x,
                    const int* __restrict__ blk_src,
                    const int* __restrict__ blk_local,
                    const float* __restrict__ blk_weight,
                    const int* __restrict__ blk_rowptr,
                    T* __restrict__ out,
                    float* __restrict__ carry,
                    int* __restrict__ run_rows,
                    int n_runs, int n_rowblocks, int out_rows, int block_rows,
                    int block_edges, int64_t n_slots, int d) {
  constexpr int W = 16 / sizeof(T);
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
        // the weight as the TPU kernel's one-hot holds it: in T
        w = round_to<T>(__ldg(blk_weight + e));
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
            // run: a carry, f32) or an interior row (complete: written
            // here, rounded to T once)
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

// Adds to acc the first-row carries of the runs after `run` that continue
// `row`, in run order, and returns.  Runs are scanned 32 at a time; runs
// without a live slot are skipped.
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

// Pass 2: one warp per run writes the rows whose first carry it holds,
// summed in f32 and rounded to T once.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
scatter_carries_kernel(const float* __restrict__ carry,
                       const int* __restrict__ run_rows,
                       T* __restrict__ out, int n_runs, int d) {
  constexpr int W = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (run >= n_runs) return;
  const int c0 = blockIdx.y * kSlice;
  const int first = __ldg(run_rows + 2 * run);
  const int last = __ldg(run_rows + 2 * run + 1);
  if (first < 0) return;

  // the last row of the nearest earlier run with a live slot
  int prev_last = -1;
  for (int j0 = run - 1; j0 >= 0; j0 -= 32) {
    const int j = j0 - lane;
    const int f = j >= 0 ? __ldg(run_rows + 2 * j) : -1;
    const int l = j >= 0 ? __ldg(run_rows + 2 * j + 1) : -1;
    const unsigned any = __ballot_sync(kFull, f >= 0);
    if (any) {
      prev_last = __shfl_sync(kFull, l, __ffs(any) - 1);
      break;
    }
  }
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

template <typename T, bool VEC>
void launch(const T* x, const int* blk_src, const int* blk_local, const float* blk_weight,
            const int* blk_rowptr, T* out, float* carry, int* run_rows, int n_runs,
            int n_rowblocks, int out_rows, int block_rows, int block_edges,
            int64_t n_slots, int d, cudaStream_t stream) {
  const dim3 grid((n_runs + kWarps - 1) / kWarps, (d + kSlice - 1) / kSlice);
  scatter_runs_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      x, blk_src, blk_local, blk_weight, blk_rowptr, out, carry, run_rows, n_runs,
      n_rowblocks, out_rows, block_rows, block_edges, n_slots, d);
  scatter_carries_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(carry, run_rows, out,
                                                               n_runs, d);
}

template <typename T>
int launch_both(const void* x, const int* blk_src, const int* blk_local,
                const float* blk_weight, const int* blk_rowptr, void* out, float* carry,
                int* run_rows, int n_rowblocks, int out_rows, int block_rows, int nblk,
                int block_edges, int d, int vec, cudaStream_t stream) {
  const int64_t n_slots = (int64_t)nblk * block_edges;
  const int n_runs = (int)((n_slots + kRun - 1) / kRun);
  if (n_runs == 0) return 0;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    launch<T, true>(xt, blk_src, blk_local, blk_weight, blk_rowptr, ot, carry, run_rows,
                    n_runs, n_rowblocks, out_rows, block_rows, block_edges, n_slots, d,
                    stream);
  else
    launch<T, false>(xt, blk_src, blk_local, blk_weight, blk_rowptr, ot, carry, run_rows,
                     n_runs, n_rowblocks, out_rows, block_rows, block_edges, n_slots, d,
                     stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Slots per run: the wrapper sizes the scratch from it (carry: 2 rows of d
// floats a run, f32 whatever the element type; run_rows: 2 ints a run;
// n_runs = ceil(nblk * B / kRun)).
extern "C" int plnlp_scatter_matmul_run_slots() { return kRun; }

// Launch both passes on `stream` and return cudaGetLastError() (0 =
// launched).  The caller guarantees shapes: x (n_src, d), blk_* (nblk,
// block_edges), blk_rowptr (n_rowblocks + 1) non-decreasing with
// n_rowblocks = ceil(out_rows / block_rows), out (out_rows, d) zeroed,
// carry (2 * n_runs, d) f32, run_rows (2 * n_runs), all contiguous; with
// vec, d a multiple of 16 bytes' worth of elements (4 f32, 8 bf16) and x,
// out, carry 16-byte aligned.  _f32: x and out float32; _bf16: bfloat16.
extern "C" int plnlp_scatter_matmul_f32(const void* x, const int* blk_src,
                                        const int* blk_local, const float* blk_weight,
                                        const int* blk_rowptr, void* out, float* carry,
                                        int* run_rows, int n_rowblocks, int out_rows,
                                        int block_rows, int nblk, int block_edges, int d,
                                        int vec, cudaStream_t stream) {
  return launch_both<float>(x, blk_src, blk_local, blk_weight, blk_rowptr, out, carry,
                            run_rows, n_rowblocks, out_rows, block_rows, nblk, block_edges,
                            d, vec, stream);
}

extern "C" int plnlp_scatter_matmul_bf16(const void* x, const int* blk_src,
                                         const int* blk_local, const float* blk_weight,
                                         const int* blk_rowptr, void* out, float* carry,
                                         int* run_rows, int n_rowblocks, int out_rows,
                                         int block_rows, int nblk, int block_edges, int d,
                                         int vec, cudaStream_t stream) {
  return launch_both<bf16>(x, blk_src, blk_local, blk_weight, blk_rowptr, out, carry,
                           run_rows, n_rowblocks, out_rows, block_rows, nblk, block_edges,
                           d, vec, stream);
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
