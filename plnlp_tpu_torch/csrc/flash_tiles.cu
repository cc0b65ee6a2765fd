// Block-sparse flash attention over the dense tiles, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of plnlp_tpu/ops/pallas_attention.py:
//
//   K3 plnlp_flash_tiles_fwd  (_fwd_kernel)  for each destination row i, over
//      the tiles of its row tile, s_ij = scale * q_i . k_j masked where
//      vals == 0; writes the tile-local partials m_i = max_j s_ij,
//      den_i = sum_j exp(s_ij - m_i) and num_i = sum_j exp(s_ij - m_i) v_j
//      (m_i read as 0 while it is -inf).  Rows with no tile edge come out
//      num = 0, den = 0, m = -inf.
//   K4 plnlp_flash_tiles_dq   (_dq_kernel)   with the caller's global row
//      stats (M, den, delta): a_ij = mask ? exp(s_ij - M_i) / den_i : 0,
//      ds_ij = a_ij (g_i . v_j - delta_i) scale, dq_i = sum_j ds_ij k_j.
//   K5 plnlp_flash_tiles_dkv  (_dkv_kernel)  the same over the transposed
//      tile set (rows = source, columns = destination, stats per
//      destination): dk_j = sum_i ds_ij q_i, dv_j = sum_i a_ij g_i.
//
// Layout.  Tiles are sorted by row tile and the tiles of row tile rt lie at
// [tile_rowptr[rt], tile_rowptr[rt+1]); vals is (nt, T, T) int8 or f32 and
// only its zero pattern is read.  q, k, v, g are (rows, d) f32 and stats is
// (rows, 3) f32, all 16-byte aligned; rows past `rows` read as zero
// features and as stats
// (0, 1, 0).  Any d and any T that is a multiple of 16 are taken (the TPU
// path pads d to 128 lanes).  The mask is always a select, never a product:
// pad rows under padded-carry carry arbitrary features, a masked exp may
// overflow, and 0 * inf is NaN.  expf, not __expf, so the kernels hold
// against their plain versions at f32 tolerance.
//
// Design.  The TPU kernels walk the tiles in grid order and carry VMEM
// accumulators from tile to tile of a row tile.  CUDA blocks run in no
// order, so each block owns an output sub-tile: a row tile (gridDim.x) and a
// chunk of its rows (gridDim.y: 8 warps of R rows).  It walks its row tile's
// tiles through tile_rowptr, and each tile in steps of 32 columns, one
// column per lane:
//   1. scores over the full d from shared memory;
//   2. the softmax terms of each row are lane-local, and a row's max and
//      sum are warp shuffles (K3 keeps a running m/den per row, as the TPU
//      kernel does; K4/K5 use the global stats);
//   3. the product with the step's 32 rows of v (K3), k (K4) or q and g
//      (K5); the lanes hold the output columns, so each lane keeps R x NT
//      accumulators in registers, in IEEE f32 FMAs (no TF32).
// For d <= 256 (the resident variant) the block's own rows (q for K3; q and
// g for K4; k and v for K5) are staged once, at full width, and stay in
// shared memory for the block's life (up to 194 KB, so the launch opts in
// above 48 KB); each step stages its 32 column rows once, at full width, and
// uses them for both the scores and the product: two barriers a step.
// Wider d takes the chunked variant: scores over 64-deep (K4: 32-deep)
// chunks of both operands, and the output in slices of 256 columns
// (gridDim.z), each slice recomputing the scores.  All staging uses 16-byte
// loads where d is a multiple of 4.  A block writes its sub-tile once;
// uncovered row tiles write the empty values above, so the port needs no
// row_mask pass.
//
// Bound on the H100 at the collab SBM shape (n_pad = 236,032 rows, d = 256,
// T = 256, nt = 2,658 int8 tiles holding 2,182,538 edges).  Bytes (vals
// once, each (n_pad, d) array once, the stats): K3 1.144 GB, K4 1.386 GB,
// K5 1.627 GB, so 0.34 / 0.41 / 0.49 ms at 3.35 TB/s.  Operations the
// nonzeros need: 4, 6 and 8 d FLOP an edge, 2.2 / 3.4 / 4.5 GFLOP, under
// 0.07 ms at the 67 TFLOP/s f32 peak.  So each is bound by bytes.  This
// design runs the dense tile products instead (178 / 268 / 357 GFLOP, 2.7 /
// 4.0 / 5.3 ms at the f32 peak), on CUDA cores from shared memory, and
// takes 9.5 / 14.2 / 22.1 ms there (chip_smoke.py on an H100 80GB HBM3 at
// 700 W; PERF.md).  Tensor cores, wgmma with TMA staging, overlapping the
// staging with the products, and skipping the all-zero sub-blocks of the
// ~1%-full tiles are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 32;        // columns per step: one per lane
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

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

// K4, K5: a = mask ? exp(s scale - M) / den : 0 and ds = a (dav - delta)
// scale, with the stats per row (K4) or per lane's column (K5, R = 1 each).
template <typename V>
__device__ __forceinline__ void bwd_terms(const V* vt, int tile, int r, int j, float s,
                                          float dav, float m, float den, float delta,
                                          float scale, float& a, float& ds) {
  a = edge(vt, tile, r, j) ? expf(s * scale - m) / den : 0.f;
  ds = a * (dav - delta) * scale;
}

// Depth of one staged chunk of d in the chunked variant: 64, except K4,
// whose four chunk arrays would then pass 48 KB.  The resident variant
// stages all 32 NT columns at once.
constexpr int kDepth = 64;
constexpr int kDepthDq = 32;

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
// K4: dq over the row-sorted tiles
// ---------------------------------------------------------------------------

template <typename V, int R, int NT, bool RES>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                const int* __restrict__ tile_rowptr, const float* __restrict__ q,
                const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ g, const float* __restrict__ stats,
                float* __restrict__ dq, int tile, int rows, int d, float scale) {
  constexpr int BM = kWarps * R, W = 32 * NT;
  constexpr int DC = RES ? W : kDepthDq, CS = DC + 4;
  constexpr int LK = RES ? CS : W;  // row stride of the k rows of the product
  extern __shared__ __align__(16) float smem[];
  float* const Qs = smem;                  // [BM][DC]
  float* const Gs = Qs + BM * DC;          // [BM][DC]
  float* const Ks = Gs + BM * DC;          // [kBN][CS]
  float* const Vs = Ks + kBN * CS;         // [kBN][CS]
  float* const Kw = RES ? Ks : smem;       // [kBN][LK]
  const int rt = blockIdx.x, r0 = blockIdx.y * BM, c0 = blockIdx.z * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)rt * tile + r0;
  const int wr0 = r0 + warp * R;

  float acc[R][NT], m[R], den[R], delta[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int64_t gr = row0 + warp * R + rr;
    const bool in = wr0 + rr < tile && gr < rows;
    m[rr] = in ? stats[gr * 3] : 0.f;
    den[rr] = in ? stats[gr * 3 + 1] : 1.f;
    delta[rr] = in ? stats[gr * 3 + 2] : 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[rr][t] = 0.f;
  }
  if (RES) {
    stage<BM, DC>(Qs, DC, q, row0, r0, tile, rows, 0, d);
    stage<BM, DC>(Gs, DC, g, row0, r0, tile, rows, 0, d);
  }

  const int64_t tt = (int64_t)tile * tile;
  const int t_end = tile_rowptr[rt + 1];
  for (int i = tile_rowptr[rt]; i < t_end; ++i) {
    const int64_t col0 = (int64_t)tile_col[i] * tile;
    const V* vt = vals + i * tt;
    for (int j0 = 0; j0 < tile; j0 += kBN) {
      float s[R], dav[R], a[R], ds[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) s[rr] = dav[rr] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DC) {  // one pass when RES
        if (!RES) {
          stage<BM, DC>(Qs, DC, q, row0, r0, tile, rows, d0, d);
          stage<BM, DC>(Gs, DC, g, row0, r0, tile, rows, d0, d);
        }
        stage<kBN, DC>(Ks, CS, k, col0 + j0, j0, tile, rows, d0, d);
        stage<kBN, DC>(Vs, CS, v, col0 + j0, j0, tile, rows, d0, d);
        __syncthreads();
        dot_chunk<R, DC>(Qs + warp * R * DC, Ks + lane * CS, s);
        dot_chunk<R, DC>(Gs + warp * R * DC, Vs + lane * CS, dav);
        if (!RES) __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        bwd_terms(vt, tile, wr0 + rr, j0 + lane, s[rr], dav[rr], m[rr], den[rr], delta[rr],
                  scale, a[rr], ds[rr]);
      if (!RES) {
        stage<kBN, W>(Kw, W, k, col0 + j0, j0, tile, rows, c0, d);
        __syncthreads();
      }
      accumulate<R, NT, LK>(Kw, ds, acc);
      __syncthreads();
    }
  }
  store<R, NT>(dq, acc, row0 + warp * R, wr0, tile, rows, c0, d);
}

// ---------------------------------------------------------------------------
// K5: dk, dv over the transposed (source-sorted) tiles
// ---------------------------------------------------------------------------

template <typename V, int R, int NT, bool RES>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const V* __restrict__ vals_t, const int* __restrict__ tile_col_t,
                 const int* __restrict__ tile_rowptr_t, const float* __restrict__ q,
                 const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ g, const float* __restrict__ stats,
                 float* __restrict__ dk, float* __restrict__ dv, int tile, int rows, int d,
                 float scale) {
  constexpr int BM = kWarps * R, W = 32 * NT;
  constexpr int DC = RES ? W : kDepth, CS = DC + 4;
  extern __shared__ __align__(16) float smem[];
  float* const Kr = smem;                  // [BM][DC]   source k
  float* const Vr = Kr + BM * DC;          // [BM][DC]   source v
  float* const Qc = Vr + BM * DC;          // [kBN][CS]  destination q
  float* const Gc = Qc + kBN * CS;         // [kBN][CS]  destination g
  float* const Bw = smem;                  // [kBN][W]   q, then g (chunked)
  const int st = blockIdx.x, r0 = blockIdx.y * BM, c0 = blockIdx.z * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)st * tile + r0;
  const int wr0 = r0 + warp * R;

  float acc_k[R][NT], acc_v[R][NT];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc_k[rr][t] = acc_v[rr][t] = 0.f;
  if (RES) {
    stage<BM, DC>(Kr, DC, k, row0, r0, tile, rows, 0, d);
    stage<BM, DC>(Vr, DC, v, row0, r0, tile, rows, 0, d);
  }

  const int64_t tt = (int64_t)tile * tile;
  const int t_end = tile_rowptr_t[st + 1];
  for (int i = tile_rowptr_t[st]; i < t_end; ++i) {
    const int64_t col0 = (int64_t)tile_col_t[i] * tile;
    const V* vt = vals_t + i * tt;
    for (int j0 = 0; j0 < tile; j0 += kBN) {
      // this lane's destination row and its stats
      const int64_t gj = col0 + j0 + lane;
      const bool jin = j0 + lane < tile && gj < rows;
      const float m = jin ? stats[gj * 3] : 0.f;
      const float den = jin ? stats[gj * 3 + 1] : 1.f;
      const float delta = jin ? stats[gj * 3 + 2] : 0.f;
      float s[R], dav[R], a[R], ds[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) s[rr] = dav[rr] = 0.f;
      for (int d0 = 0; d0 < d; d0 += DC) {  // one pass when RES
        if (!RES) {
          stage<BM, DC>(Kr, DC, k, row0, r0, tile, rows, d0, d);
          stage<BM, DC>(Vr, DC, v, row0, r0, tile, rows, d0, d);
        }
        stage<kBN, DC>(Qc, CS, q, col0 + j0, j0, tile, rows, d0, d);
        stage<kBN, DC>(Gc, CS, g, col0 + j0, j0, tile, rows, d0, d);
        __syncthreads();
        dot_chunk<R, DC>(Kr + warp * R * DC, Qc + lane * CS, s);
        dot_chunk<R, DC>(Vr + warp * R * DC, Gc + lane * CS, dav);
        if (!RES) __syncthreads();
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr)
        bwd_terms(vt, tile, wr0 + rr, j0 + lane, s[rr], dav[rr], m, den, delta, scale, a[rr],
                  ds[rr]);
      if (RES) {
        accumulate<R, NT, CS>(Qc, ds, acc_k);
        accumulate<R, NT, CS>(Gc, a, acc_v);
      } else {
        stage<kBN, W>(Bw, W, q, col0 + j0, j0, tile, rows, c0, d);
        __syncthreads();
        accumulate<R, NT, W>(Bw, ds, acc_k);
        __syncthreads();
        stage<kBN, W>(Bw, W, g, col0 + j0, j0, tile, rows, c0, d);
        __syncthreads();
        accumulate<R, NT, W>(Bw, a, acc_v);
      }
      __syncthreads();
    }
  }
  store<R, NT>(dk, acc_k, row0 + warp * R, wr0, tile, rows, c0, d);
  store<R, NT>(dv, acc_v, row0 + warp * R, wr0, tile, rows, c0, d);
}

// Rows per warp: 8 where one accumulator is kept, 4 for K5's two.
constexpr int kRows1 = 8;
constexpr int kRows2 = 4;
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

template <typename V, int NT, bool RES>
void dq(const void* vals, const int* tc, const int* tp, const float* q, const float* k,
        const float* v, const float* g, const float* stats, float* out, int nr, int tile,
        int rows, int d, float scale, cudaStream_t stream) {
  constexpr int BM = kWarps * kRows1, W = 32 * NT, DC = RES ? W : kDepthDq;
  constexpr int floats = cmax(2 * BM * DC + 2 * kBN * (DC + 4), RES ? 0 : kBN * W);
  launch(flash_dq_kernel<V, kRows1, NT, RES>, floats * 4, nr, tile, BM, NT, d, stream,
         static_cast<const V*>(vals), tc, tp, q, k, v, g, stats, out, tile, rows, d, scale);
}

template <typename V, int NT, bool RES>
void dkv(const void* vals, const int* tc, const int* tp, const float* q, const float* k,
         const float* v, const float* g, const float* stats, float* dk, float* dv, int nr,
         int tile, int rows, int d, float scale, cudaStream_t stream) {
  constexpr int BM = kWarps * kRows2, W = 32 * NT, DC = RES ? W : kDepth;
  constexpr int floats = cmax(2 * BM * DC + 2 * kBN * (DC + 4), RES ? 0 : kBN * W);
  launch(flash_dkv_kernel<V, kRows2, NT, RES>, floats * 4, nr, tile, BM, NT, d, stream,
         static_cast<const V*>(vals), tc, tp, q, k, v, g, stats, dk, dv, tile, rows, d, scale);
}

// Calls F<V, NT, RES>(args...) for the store type and d: the resident
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
// (vals_int8 != 0) or f32, contiguous; tile a multiple of 16; tile_col (nt)
// and tile_rowptr (n_rowtiles + 1) int32; q, k, v, g and the outputs
// (rows, d) f32, contiguous and 16-byte aligned, and stats (rows, 3) f32,
// contiguous; 0 < rows <=
// n_rowtiles * tile; d > 0.

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
  PLNLP_DISPATCH(dq, vals_int8, d, vals, tile_col, tile_rowptr, q, k, v, g, stats, out,
                 n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

extern "C" int plnlp_flash_tiles_dkv(const void* vals_t, int vals_int8,
                                     const int* tile_col_t, const int* tile_rowptr_t,
                                     const float* q, const float* k, const float* v,
                                     const float* g, const float* stats, float* dk, float* dv,
                                     int n_rowtiles, int tile, int rows, int d, float scale,
                                     cudaStream_t stream) {
  PLNLP_DISPATCH(dkv, vals_int8, d, vals_t, tile_col_t, tile_rowptr_t, q, k, v, g, stats, dk,
                 dv, n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
