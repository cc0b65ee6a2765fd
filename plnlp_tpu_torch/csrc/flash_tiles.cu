// Block-sparse flash attention over the dense tiles, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of plnlp_tpu/ops/pallas_attention.py:
//
//   K3 plnlp_flash_tiles_fwd  (_fwd_kernel, :104)  for each destination row
//      i, over the tiles of its row tile, s_ij = scale * q_i . k_j masked
//      where vals == 0; writes the tile-local partials m_i = max_j s_ij,
//      den_i = sum_j exp(s_ij - m_i) and num_i = sum_j exp(s_ij - m_i) v_j
//      (m_i read as 0 while it is -inf).  Rows with no tile edge come out
//      num = 0, den = 0, m = -inf.
//   K4 plnlp_flash_tiles_dq   (_dq_kernel, :216)   with the caller's global
//      row stats (M, den, delta): a_ij = mask ? exp(s_ij - M_i) / den_i : 0,
//      ds_ij = a_ij (g_i . v_j - delta_i) scale, dq_i = sum_j ds_ij k_j.
//   K5 plnlp_flash_tiles_dkv  (_dkv_kernel, :303)  the same over the
//      transposed tile set (rows = source, columns = destination, stats per
//      destination): dk_j = sum_i ds_ij q_i, dv_j = sum_i a_ij g_i.
//
// Layout.  Tiles are sorted by row tile and the tiles of row tile rt lie at
// [tile_rowptr[rt], tile_rowptr[rt+1]); vals is (nt, T, T) int8 or f32,
// 16-byte aligned, and only its zero pattern is read.  q, k, v, g are
// (rows, d) f32 and stats is (rows, 3) f32, all 16-byte aligned; rows past
// `rows` read as zero features and as stats (0, 1, 0).  Any d and any T
// that is a multiple of 16 are taken (the TPU path pads d to 128 lanes).
// A mask is never a product: pad rows under padded-carry carry arbitrary
// features, a masked exp may overflow, and 0 * inf is NaN.  expf, not
// __expf, so the kernels hold against their plain versions at f32
// tolerance.
//
// Bound on the H100 at the collab SBM shape (n_pad = 236,032 rows, d = 256,
// T = 256, nt = 2,658 int8 tiles holding 2,182,538 edges, 1.25% full).
// Bytes (vals once, each (n_pad, d) array once, the stats): K3 1.144 GB,
// K4 1.386 GB, K5 1.627 GB, so 0.34 / 0.41 / 0.49 ms at 3.35 TB/s.
// Operations the nonzeros need: 4, 6 and 8 d FLOP an edge, 2.2 / 3.4 /
// 4.5 GFLOP, under 0.07 ms at the 67 TFLOP/s f32 peak.  So each is bound by
// bytes.
//
// K4, K5 (redesigned): compact each tile row's nonzeros, gather only their
// rows.  A dense T x T tile product (268 / 357 GFLOP here) spends ~99% of
// its scores, exps and products on zeros.  Instead one warp owns one output
// row: destination row i of a row tile for K4, source row j of a
// column-sorted row tile for K5.  It keeps its own two rows (q_i and g_i;
// k_j and v_j: 8 floats each a lane for d <= 256) and its output rows (dq;
// dk and dv) in registers, walks its row tile's tiles through tile_rowptr
// and reads its row of each tile once, 256 columns a pass (8 bytes a lane
// for int8, 32 for f32).  Each lane counts the nonzeros among its 8
// columns, a warp prefix sum gives each its place, and their rows (K4: the
// source j = tile_col * T + c; K5: the destination i) land in a per-warp
// list in shared memory in column order.  Rows at or past `rows` are left
// out: their features and stats read (0, 0) and (0, 1, 0), so each of
// their terms is exactly 0.  The warp then walks the list entry by entry:
// every lane gathers its columns of the entry's two rows (k_j and v_j for
// K4; q_i and g_i, with the entry's stats, for K5), the dot
// products s = q . k and g . v are lane partials and one butterfly each,
// a = exp(s scale - M) / den and ds = a (g.v - delta) scale, and the
// registers take ds k_j (K4), or ds q_i and a g_i (K5).  Zeros of vals are
// skipped, never multiplied.  A row is owned by one warp and its sums run
// in list order, with no atomics, so a second launch gives the same bits.
// A full tile row fills the list 256 entries a pass; the list holds 512 and
// is drained before it can overflow.  A block is 8 warps of 1 row (K4) or 2
// (K5), and the row slices of one row tile are neighbours in launch order:
// few row tiles are in flight at once, so the rows they gather from their
// column tiles stay in L2.  Registers are capped at 64 (K4) and 80 (K5).
// d > 256 takes gridDim.z slices of 256 output columns; each slice
// recomputes the dot products over the full d, reading the warp's own row
// in chunks.
//
// What the design adds to the bound is the row gather: two rows of d floats
// a nonzero, 2 x 2,182,538 x 256 x 4 B = 4.47 GB (plus 26 MB of stats for
// K5), 1.33 ms if all of it came from HBM; the SBM's communities keep much
// of it in L2.  Measured there (chip_smoke.py on an H100 80GB HBM3 at
// 700.00 W): K4 0.738 ms and K5 0.959 ms, 1.8x and 2.0x their byte bounds,
// gathering at 6.1 and 4.7 TB/s, so mostly from L2; the dense design before
// it took 14.159 and 22.052 ms.
//
// K3 (not yet redesigned): each block owns an output sub-tile, a row tile
// (gridDim.x) and a chunk of its rows (gridDim.y: 8 warps of 8 rows).  It
// walks its row tile's tiles through tile_rowptr, and each tile in steps of
// 32 columns, one column per lane:
//   1. scores over the full d from shared memory;
//   2. the softmax terms of each row are lane-local, and a row's max and
//      sum are warp shuffles (a running m/den per row, as the TPU kernel
//      keeps);
//   3. the product with the step's 32 rows of v; the lanes hold the output
//      columns, so each lane keeps 8 x NT accumulators in registers, in IEEE
//      f32 FMAs (no TF32).
// For d <= 256 (the resident variant) the block's q rows are staged once, at
// full width, and stay in shared memory for the block's life (the launch
// opts in above 48 KB); each step stages its 32 column rows once, at full
// width, and uses them for both the scores and the product: two barriers a
// step.  Wider d takes the chunked variant: scores over 64-deep chunks of
// both operands, and the output in slices of 256 columns (gridDim.z), each
// slice recomputing the scores.  All staging uses 16-byte loads where d is a
// multiple of 4.  A block writes its sub-tile once; uncovered row tiles
// write the empty values above, so the port needs no row_mask pass.  It
// runs the dense tile products (178 GFLOP, 2.7 ms at the f32 peak) on CUDA
// cores and took 9.5 ms (chip_smoke.py on an H100 80GB HBM3 at 700 W;
// PERF.md); the compaction above is the next step for it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 32;        // K3: columns per step, one per lane
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Every lane gets the same bits: each step adds the same two values.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// dst[r][c] = src[row0 + r][col0 + c] for r < NR, c < NC (row stride `ld`
// in shared memory, a multiple of 4), zero where the row is past the tile or
// `rows`, or the column past d.  16-byte loads where d is a multiple of 4
// (the caller guarantees 16-byte aligned arrays; col0 is a multiple of 4).
template <int NR, int NC>
__device__ __forceinline__ void stage(float* dst, int ld, const float* __restrict__ src,
                                      int64_t row0, int local0, int tile, int rows,
                                      int col0, int d) {
  if ((d & 3) == 0) {
    constexpr int NC4 = NC / 4;
    for (int e = threadIdx.x; e < NR * NC4; e += kThreads) {
      const int r = e / NC4, c = (e % NC4) * 4;
      const int64_t gr = row0 + r;
      const int gc = col0 + c;
      const float4 val = (local0 + r < tile && gr < rows && gc < d)
                             ? __ldg(reinterpret_cast<const float4*>(src + gr * d + gc))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + r * ld + c) = val;
    }
    return;
  }
  for (int e = threadIdx.x; e < NR * NC; e += kThreads) {
    const int r = e / NC, c = e % NC;
    const int64_t gr = row0 + r;
    const int gc = col0 + c;
    dst[r * ld + c] =
        (local0 + r < tile && gr < rows && gc < d) ? __ldg(src + gr * d + gc) : 0.f;
  }
}

// s[rr] += A[warp rows][0..DC) . B[lane][0..DC) for R rows (A stride DC,
// broadcast reads; B stride DC + 4, one row per lane, no bank conflicts).
template <int R, int DC>
__device__ __forceinline__ void dot_chunk(const float* a, const float* b, float (&s)[R]) {
#pragma unroll 4
  for (int c = 0; c < DC; c += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + c);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float4 av = *reinterpret_cast<const float4*>(a + rr * DC + c);
      s[rr] = fmaf(av.x, bv.x, s[rr]);
      s[rr] = fmaf(av.y, bv.y, s[rr]);
      s[rr] = fmaf(av.z, bv.z, s[rr]);
      s[rr] = fmaf(av.w, bv.w, s[rr]);
    }
  }
}

// acc[rr][t] += sum_j w_j[rr] * B[j][lane + 32 t], with w_j[rr] lane j's
// value of w[rr] (B row stride LD in shared memory).
template <int R, int NT, int LD>
__device__ __forceinline__ void accumulate(const float* b, const float (&w)[R],
                                           float (&acc)[R][NT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int j = 0; j < kBN; ++j) {
    float wj[R];
#pragma unroll
    for (int rr = 0; rr < R; ++rr) wj[rr] = __shfl_sync(kFull, w[rr], j);
    const float* br = b + j * LD + lane;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float bv = br[32 * t];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) acc[rr][t] = fmaf(wj[rr], bv, acc[rr][t]);
    }
  }
}

template <typename V>
__device__ __forceinline__ bool edge(const V* tile_vals, int tile, int r, int j) {
  return r < tile && j < tile && tile_vals[(int64_t)r * tile + j] != V(0);
}

template <int R, int NT>
__device__ __forceinline__ void store(float* __restrict__ out, const float (&acc)[R][NT],
                                      int64_t row0, int local0, int tile, int rows, int c0,
                                      int d) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int64_t gr = row0 + rr;
    if (local0 + rr >= tile || gr >= rows) continue;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = c0 + lane + 32 * t;
      if (c < d) out[gr * d + c] = acc[rr][t];
    }
  }
}

// One step's terms.  K3: the online softmax update of each row (running
// max and sum, accumulators rescaled) and the step's weights p.
template <typename V, int R, int NT>
__device__ __forceinline__ void fwd_terms(const V* vt, int tile, int wr0, int j,
                                          const float (&s)[R], float scale, float (&m_run)[R],
                                          float (&den)[R], float (&acc)[R][NT], float (&p)[R]) {
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const bool mk = edge(vt, tile, wr0 + rr, j);
    const float sm = mk ? s[rr] * scale : -INFINITY;
    const float m_new = fmaxf(m_run[rr], warp_max(sm));
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float r = isfinite(m_run[rr]) ? expf(m_run[rr] - m_safe) : 0.f;
    p[rr] = mk ? expf(sm - m_safe) : 0.f;
    den[rr] = den[rr] * r + warp_sum(p[rr]);
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[rr][t] *= r;
    m_run[rr] = m_new;
  }
}

// Depth of one staged chunk of d in K3's chunked variant; the resident
// variant stages all 32 NT columns at once.
constexpr int kDepth = 64;

// ---------------------------------------------------------------------------
// K3: forward partials
// ---------------------------------------------------------------------------

template <typename V, int R, int NT, bool RES>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                 const int* __restrict__ tile_rowptr, const float* __restrict__ q,
                 const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ num, float* __restrict__ ml, int tile, int rows, int d,
                 float scale) {
  constexpr int BM = kWarps * R, W = 32 * NT;
  constexpr int DC = RES ? W : kDepth, CS = DC + 4;
  constexpr int LV = RES ? CS : W;  // row stride of the staged v
  extern __shared__ __align__(16) float smem[];
  float* const Qs = smem;                                // [BM][DC]
  float* const Ks = Qs + BM * DC;                        // [kBN][CS]
  float* const Vs = RES ? Ks + kBN * CS : smem;          // [kBN][LV]
  const int rt = blockIdx.x, r0 = blockIdx.y * BM, c0 = blockIdx.z * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)rt * tile + r0;
  const int wr0 = r0 + warp * R;  // this warp's first row in the tile

  float acc[R][NT], m_run[R], den[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    m_run[rr] = -INFINITY;
    den[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[rr][t] = 0.f;
  }
  if (RES) stage<BM, DC>(Qs, DC, q, row0, r0, tile, rows, 0, d);

  const int64_t tt = (int64_t)tile * tile;
  const int t_end = tile_rowptr[rt + 1];
  for (int i = tile_rowptr[rt]; i < t_end; ++i) {
    const int64_t col0 = (int64_t)tile_col[i] * tile;
    const V* vt = vals + i * tt;
    for (int j0 = 0; j0 < tile; j0 += kBN) {
      float s[R], p[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) s[rr] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DC) {  // one pass when RES
        if (!RES) stage<BM, DC>(Qs, DC, q, row0, r0, tile, rows, d0, d);
        stage<kBN, DC>(Ks, CS, k, col0 + j0, j0, tile, rows, d0, d);
        if (RES) stage<kBN, DC>(Vs, CS, v, col0 + j0, j0, tile, rows, 0, d);
        __syncthreads();
        dot_chunk<R, DC>(Qs + warp * R * DC, Ks + lane * CS, s);
        if (!RES) __syncthreads();
      }
      fwd_terms<V, R, NT>(vt, tile, wr0, j0 + lane, s, scale, m_run, den, acc, p);
      if (!RES) {
        stage<kBN, W>(Vs, W, v, col0 + j0, j0, tile, rows, c0, d);
        __syncthreads();
      }
      accumulate<R, NT, LV>(Vs, p, acc);
      __syncthreads();
    }
  }

  store<R, NT>(num, acc, row0 + warp * R, wr0, tile, rows, c0, d);
  if (blockIdx.z == 0 && lane == 0) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int64_t gr = row0 + warp * R + rr;
      if (wr0 + rr < tile && gr < rows) {
        ml[gr * 2] = m_run[rr];
        ml[gr * 2 + 1] = den[rr];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4, K5: a warp per output row over the compacted nonzeros
// ---------------------------------------------------------------------------

// The knobs below were set by timing the alternatives on the H100
// (chip_sweep_flash.py; PERF.md).  Rows a warp owns, one after another:
// fewer rows a block means fewer row tiles in flight at once, so the rows
// they gather stay in L2.
constexpr int kRowsPerWarpDq = 1;
constexpr int kRowsPerWarpDkv = 2;
constexpr int kChunk = 256;       // vals columns scanned at a time: 8 a lane
constexpr int kSlice = 256;       // output columns per block: 8 a lane
constexpr int kGroup = 2;         // vals rows in flight
constexpr int kUnroll = 1;        // list entries (two gathered rows each) in flight
constexpr int kCap = 2 * kChunk;  // list entries per warp
// Blocks an SM, which caps the registers a thread (K4 64, K5 80): more warps
// in flight pay more than more entries in flight per warp.
constexpr int kMinBlocksDq = 4;
constexpr int kMinBlocksDkv = 3;

__host__ __device__ constexpr int rows_per_block(bool dkv) {
  return kWarps * (dkv ? kRowsPerWarpDkv : kRowsPerWarpDq);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8]) {
  const int2 raw = __ldg(reinterpret_cast<const int2*>(p));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = static_cast<float>(static_cast<int8_t>(raw.x >> (8 * j)));
    v[4 + j] = static_cast<float>(static_cast<int8_t>(raw.y >> (8 * j)));
  }
}

// A lane's 8 columns of the 256-column slice that starts at c0: with VEC
// (d % 4 == 0, 16-byte aligned rows) two float4 at c0 + 4 lane and
// c0 + 128 + 4 lane; otherwise 8 scalars at c0 + lane + 32 j.  Columns at
// or past d read 0 and are not written.
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* row, int c0, int lane, int d,
                                          float (&v)[8]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 128 * h + 4 * lane;
      const float4 a = c < d ? __ldg(reinterpret_cast<const float4*>(row + c))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * h] = a.x; v[4 * h + 1] = a.y; v[4 * h + 2] = a.z; v[4 * h + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane + 32 * j;
      v[j] = c < d ? __ldg(row + c) : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* row, int c0, int lane, int d,
                                           const float (&v)[8]) {
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 128 * h + 4 * lane;
      if (c < d)
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) row[c] = v[j];
    }
  }
}

__device__ __forceinline__ float dot8(const float (&a)[8], const float (&b)[8], float s) {
#pragma unroll
  for (int c = 0; c < 8; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// What a warp's row holds while it drains its list.  K4 (DKV false): the
// own rows are q_i and g_i, with their stats; the gathered rows are k_j and
// v_j.  K5: the own rows are k_j and v_j; the gathered rows q_i and g_i come
// with the stats of row i.
struct BwdRow {
  const float* own_a;  // the own rows at full width (read in chunks when WIDE)
  const float* own_b;
  float oa[8], ob[8];  // their 8 columns a lane (d <= 256)
  float m, den, delta;  // K4: the own row's stats
  float acc_a[8], acc_b[8];  // dq, or dk and dv: the slice's 8 columns a lane
};

// Adds the terms of the list's n entries to the row's registers, in list
// order.  gat_a / gat_b are the gathered arrays (K4: k, v; K5: q, g).
template <bool VEC, bool WIDE, bool DKV>
__device__ __forceinline__ void drain_bwd(const int* lst, int n, BwdRow& w,
                                          const float* __restrict__ gat_a,
                                          const float* __restrict__ gat_b,
                                          const float* __restrict__ stats, int c0, int lane,
                                          int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += kUnroll) {
    float xa[kUnroll][8], xb[kUnroll][8], s[kUnroll], dav[kUnroll];
    float m[kUnroll], den[kUnroll], delta[kUnroll];
    const float* ra[kUnroll];
    const float* rb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = b + u < n;  // warp-uniform
      const int64_t row = live ? lst[b + u] : 0;
      ra[u] = gat_a + row * d;
      rb[u] = gat_b + row * d;
      m[u] = w.m;
      den[u] = w.den;
      delta[u] = w.delta;
      if (DKV && live) {
        m[u] = __ldg(stats + row * 3);
        den[u] = __ldg(stats + row * 3 + 1);
        delta[u] = __ldg(stats + row * 3 + 2);
      }
      s[u] = dav[u] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) xa[u][c] = xb[u][c] = 0.f;
      if (!WIDE && live) {
        load_cols<VEC>(ra[u], 0, lane, d, xa[u]);
        load_cols<VEC>(rb[u], 0, lane, d, xb[u]);
      }
    }
    if (!WIDE) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = dot8(w.oa, xa[u], 0.f);
        dav[u] = dot8(w.ob, xb[u], 0.f);
      }
    } else {
      // the dot products over the full d, in 256-column chunks; the chunk
      // at c0 is the slice the registers accumulate
      for (int d0 = 0; d0 < d; d0 += kSlice) {
        float ca[8], cb[8];
        load_cols<VEC>(w.own_a, d0, lane, d, ca);
        load_cols<VEC>(w.own_b, d0, lane, d, cb);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (b + u >= n) break;  // warp-uniform
          float ta[8], tb[8];
          load_cols<VEC>(ra[u], d0, lane, d, ta);
          load_cols<VEC>(rb[u], d0, lane, d, tb);
          s[u] = dot8(ca, ta, s[u]);
          dav[u] = dot8(cb, tb, dav[u]);
          if (d0 == c0) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              xa[u][c] = ta[c];
              xb[u][c] = tb[c];
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = warp_sum(s[u]);
      dav[u] = warp_sum(dav[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b + u >= n) break;  // warp-uniform
      const float a = expf(s[u] * scale - m[u]) / den[u];
      const float ds = a * (dav[u] - delta[u]) * scale;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.acc_a[c] = fmaf(ds, xa[u][c], w.acc_a[c]);
        if (DKV) w.acc_b[c] = fmaf(a, xb[u][c], w.acc_b[c]);
      }
    }
  }
  __syncwarp();
}

// K4 (DKV false): own = (q, g), gathered = (k, v), out_a = dq.
// K5 (DKV true):  own = (k, v), gathered = (q, g), out_a = dk, out_b = dv;
// vals, tile_col and tile_rowptr are then the transposed set's.
template <typename V, bool VEC, bool WIDE, bool DKV>
__global__ void __launch_bounds__(kThreads, DKV ? kMinBlocksDkv : kMinBlocksDq)
flash_bwd_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                 const int* __restrict__ tile_rowptr, const float* __restrict__ own_a,
                 const float* __restrict__ own_b, const float* __restrict__ gat_a,
                 const float* __restrict__ gat_b, const float* __restrict__ stats,
                 float* __restrict__ out_a, float* __restrict__ out_b, int tile, int rows,
                 int d, float scale) {
  __shared__ int lst_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* lst = lst_all[warp];
  // the row slices of one row tile are neighbours in launch order, so they
  // run together and share the rows they gather in L2
  constexpr int kRowsPerWarp = DKV ? kRowsPerWarpDkv : kRowsPerWarpDq;
  constexpr int kRowsPerBlock = rows_per_block(DKV);
  const int n_slices = (tile + kRowsPerBlock - 1) / kRowsPerBlock;
  const int rt = blockIdx.x / n_slices;
  const int slice = blockIdx.x - rt * n_slices;
  const int c0 = blockIdx.z * kSlice;
  const int t_begin = __ldg(tile_rowptr + rt);
  const int n_chunks = (tile + kChunk - 1) / kChunk;
  const int n_items = (__ldg(tile_rowptr + rt + 1) - t_begin) * n_chunks;
  const int64_t tt = (int64_t)tile * tile;

  for (int k = 0; k < kRowsPerWarp; ++k) {
    // the block's warps take neighbouring rows, so their vals rows are adjacent
    const int r = slice * kRowsPerBlock + k * kWarps + warp;
    const int64_t grow = (int64_t)rt * tile + r;
    if (r >= tile || grow >= rows) break;  // warp-uniform
    BwdRow w;
    w.own_a = own_a + grow * d;
    w.own_b = own_b + grow * d;
#pragma unroll
    for (int c = 0; c < 8; ++c) w.oa[c] = w.ob[c] = w.acc_a[c] = w.acc_b[c] = 0.f;
    if (!WIDE) {
      load_cols<VEC>(w.own_a, 0, lane, d, w.oa);
      load_cols<VEC>(w.own_b, 0, lane, d, w.ob);
    }
    w.m = DKV ? 0.f : __ldg(stats + grow * 3);
    w.den = DKV ? 1.f : __ldg(stats + grow * 3 + 1);
    w.delta = DKV ? 0.f : __ldg(stats + grow * 3 + 2);
    int n = 0;  // list entries
    for (int q0 = 0; q0 < n_items; q0 += kGroup) {
      float v[kGroup][8];
      int xcol[kGroup];  // gathered row of the lane's first column, per item
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int q = q0 + g;
        const int i = t_begin + q / n_chunks;
        const int col = (q % n_chunks) * kChunk + 8 * lane;
        xcol[g] = 0;
        if (q < n_items && col < tile) {
          load8(vals + i * tt + (int64_t)r * tile + col, v[g]);
          xcol[g] = __ldg(tile_col + i) * tile + col;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[g][j] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (q0 + g >= n_items) break;  // warp-uniform
        unsigned nz = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[g][j] != 0.f && xcol[g] + j < rows) nz |= 1u << j;
        const int cnt = __popc(nz);
        int incl = cnt;  // inclusive prefix sum over lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        if (n + total > kCap) {
          drain_bwd<VEC, WIDE, DKV>(lst, n, w, gat_a, gat_b, stats, c0, lane, d, scale);
          n = 0;
        }
        int pos = n + incl - cnt;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (nz >> j & 1u) lst[pos++] = xcol[g] + j;
        }
        n += total;
      }
    }
    drain_bwd<VEC, WIDE, DKV>(lst, n, w, gat_a, gat_b, stats, c0, lane, d, scale);
    store_cols<VEC>(out_a + grow * d, c0, lane, d, w.acc_a);
    if (DKV) store_cols<VEC>(out_b + grow * d, c0, lane, d, w.acc_b);
  }
}

template <typename V, bool VEC, bool WIDE, bool DKV>
void launch_bwd(const void* vals, const int* tc, const int* tp, const float* own_a,
                const float* own_b, const float* gat_a, const float* gat_b,
                const float* stats, float* out_a, float* out_b, int nr, int tile, int rows,
                int d, float scale, cudaStream_t stream) {
  const dim3 grid(nr * ((tile + rows_per_block(DKV) - 1) / rows_per_block(DKV)), 1,
                  (d + kSlice - 1) / kSlice);
  flash_bwd_kernel<V, VEC, WIDE, DKV><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(vals), tc, tp, own_a, own_b, gat_a, gat_b, stats, out_a, out_b,
      tile, rows, d, scale);
}

// Picks the store type, the 16-byte path (d % 4 == 0) and the wide path
// (d > 256).
template <bool DKV>
void bwd(const void* vals, int vals_int8, const int* tc, const int* tp, const float* own_a,
         const float* own_b, const float* gat_a, const float* gat_b, const float* stats,
         float* out_a, float* out_b, int nr, int tile, int rows, int d, float scale,
         cudaStream_t stream) {
  const bool vec = d % 4 == 0, wide = d > kSlice;
#define PLNLP_BWD(V, VEC, WIDE)                                                           \
  launch_bwd<V, VEC, WIDE, DKV>(vals, tc, tp, own_a, own_b, gat_a, gat_b, stats, out_a, \
                                out_b, nr, tile, rows, d, scale, stream)
  if (vals_int8) {
    if (vec) { if (wide) PLNLP_BWD(int8_t, true, true); else PLNLP_BWD(int8_t, true, false); }
    else { if (wide) PLNLP_BWD(int8_t, false, true); else PLNLP_BWD(int8_t, false, false); }
  } else {
    if (vec) { if (wide) PLNLP_BWD(float, true, true); else PLNLP_BWD(float, true, false); }
    else { if (wide) PLNLP_BWD(float, false, true); else PLNLP_BWD(float, false, false); }
  }
#undef PLNLP_BWD
}

// ---------------------------------------------------------------------------
// K3's launch
// ---------------------------------------------------------------------------

// Rows per warp of K3.
constexpr int kRows1 = 8;
// The resident variant takes d up to one 256-column slice.
constexpr int kResidentMaxD = 256;

// Output columns per lane, by d: the smallest of 1, 2, 4, 8 whose 32 NT
// columns cover d; wider d takes several 256-column slices.
int cols_per_lane(int d) {
  const int need = (d + 31) / 32;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

// Launches `kernel` with `bytes` of dynamic shared memory (opting in above
// 48 KB) on a grid over (row tiles, row chunks, column slices).
template <typename Kernel, typename... Args>
void launch(Kernel kernel, int bytes, int n_rowtiles, int tile, int rows_per_block, int nt_cols,
            int d, cudaStream_t stream, Args... args) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const dim3 grid(n_rowtiles, (tile + rows_per_block - 1) / rows_per_block,
                  (d + 32 * nt_cols - 1) / (32 * nt_cols));
  kernel<<<grid, kThreads, bytes, stream>>>(args...);
}

template <typename V, int NT, bool RES>
void fwd(const void* vals, const int* tc, const int* tp, const float* q, const float* k,
         const float* v, float* num, float* ml, int nr, int tile, int rows, int d, float scale,
         cudaStream_t stream) {
  constexpr int BM = kWarps * kRows1, W = 32 * NT, DC = RES ? W : kDepth;
  constexpr int floats = RES ? BM * DC + 2 * kBN * (DC + 4)
                             : cmax(BM * DC + kBN * (DC + 4), kBN * W);
  launch(flash_fwd_kernel<V, kRows1, NT, RES>, floats * 4, nr, tile, BM, NT, d, stream,
         static_cast<const V*>(vals), tc, tp, q, k, v, num, ml, tile, rows, d, scale);
}

// Calls fwd<V, NT, RES>(args...) for the store type and d: the resident
// variant with the fewest columns per lane that cover d, or the chunked one
// in 256-column slices.
#define PLNLP_DISPATCH(F, vals_int8, d, ...)                                   \
  do {                                                                         \
    if (vals_int8) {                                                           \
      PLNLP_DISPATCH_NT(F, int8_t, d, __VA_ARGS__);                            \
    } else {                                                                   \
      PLNLP_DISPATCH_NT(F, float, d, __VA_ARGS__);                             \
    }                                                                          \
  } while (0)
#define PLNLP_DISPATCH_NT(F, V, d, ...)                                        \
  do {                                                                         \
    const int nt_ = cols_per_lane(d);                                          \
    if (d > kResidentMaxD) F<V, 8, false>(__VA_ARGS__);                        \
    else if (nt_ == 1) F<V, 1, true>(__VA_ARGS__);                             \
    else if (nt_ == 2) F<V, 2, true>(__VA_ARGS__);                             \
    else if (nt_ == 4) F<V, 4, true>(__VA_ARGS__);                             \
    else F<V, 8, true>(__VA_ARGS__);                                           \
  } while (0)

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched).  The caller guarantees: vals (nt, tile, tile) int8
// (vals_int8 != 0) or f32, contiguous and 16-byte aligned; tile a multiple
// of 16; tile_col (nt) and tile_rowptr (n_rowtiles + 1) int32; q, k, v, g
// and the outputs (rows, d) f32, contiguous and 16-byte aligned, and stats
// (rows, 3) f32, contiguous; 0 < rows <= n_rowtiles * tile; d > 0.

extern "C" int plnlp_flash_tiles_fwd(const void* vals, int vals_int8, const int* tile_col,
                                     const int* tile_rowptr, const float* q, const float* k,
                                     const float* v, float* num, float* ml, int n_rowtiles,
                                     int tile, int rows, int d, float scale,
                                     cudaStream_t stream) {
  PLNLP_DISPATCH(fwd, vals_int8, d, vals, tile_col, tile_rowptr, q, k, v, num, ml,
                 n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

extern "C" int plnlp_flash_tiles_dq(const void* vals, int vals_int8, const int* tile_col,
                                    const int* tile_rowptr, const float* q, const float* k,
                                    const float* v, const float* g, const float* stats,
                                    float* out, int n_rowtiles, int tile, int rows, int d,
                                    float scale, cudaStream_t stream) {
  bwd<false>(vals, vals_int8, tile_col, tile_rowptr, q, g, k, v, stats, out, nullptr,
             n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

extern "C" int plnlp_flash_tiles_dkv(const void* vals_t, int vals_int8,
                                     const int* tile_col_t, const int* tile_rowptr_t,
                                     const float* q, const float* k, const float* v,
                                     const float* g, const float* stats, float* dk, float* dv,
                                     int n_rowtiles, int tile, int rows, int d, float scale,
                                     cudaStream_t stream) {
  bwd<true>(vals_t, vals_int8, tile_col_t, tile_rowptr_t, k, v, q, g, stats, dk, dv,
            n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
