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
// [tile_rowptr[rt], tile_rowptr[rt+1]); vals is (nt, T, T) int8, f32 or
// bf16, 16-byte aligned, and only its zero pattern is read.  q, k, v, g are
// (rows, d) f32 (plnlp_flash_tiles_{fwd,dq,dkv}) or bf16 (the _bf16 entry
// points), stats is (rows, 3) f32, all 16-byte aligned; rows past `rows`
// read as zero features and as stats (0, 1, 0).  The outputs are f32 in
// both.  Any d and any T that is a multiple of 16 are taken (the TPU path
// pads d to 128 lanes).
//
// bf16 features (the TPU kernels with bf16 q/k/v/g): the scores and g . v
// are f32 sums of bf16 products (exact in f32), the softmax terms are f32,
// and the weight of each second product is rounded to bf16 first, as the
// TPU kernels cast it to the features' dtype: K3 num += bf16(p) v_j while
// den sums the f32 p; K4 dq += bf16(ds) k_j; K5 dk += bf16(ds) q_i and
// dv += bf16(a) g_i.  The feature type F sets a lane's columns: 16 bytes
// of F a load (W = 4 f32 or 8 bf16 columns: c0 + 32 W h + W lane), and the
// f32 outputs are stored in the same columns, so the f32 instantiations
// keep their layout and their bits.  A K3 row longer than one 32-entry
// chunk rounds p against its running max and rescales the sums, so its
// terms may differ from the plain version's (one bf16 rounding against the
// final max) by one bf16 ulp.
//
// Bound on the H100 at the collab SBM shape (n_pad = 236,032 rows, d = 256,
// T = 256, nt = 2,658 int8 tiles holding 2,182,538 edges, 1.25% full).
// Bytes (vals once, each (n_pad, d) array once, the stats): K3 1.144 GB,
// K4 1.386 GB, K5 1.627 GB, so 0.34 / 0.41 / 0.49 ms at 3.35 TB/s.  With
// bf16 q/k/v/g (2 bytes; the outputs and stats still f32) 0.78 / 0.90 /
// 1.14 GB, 0.23 / 0.27 / 0.34 ms.
// Operations the nonzeros need: 4, 6 and 8 d FLOP an edge, 2.2 / 3.4 /
// 4.5 GFLOP, under 0.07 ms at the 67 TFLOP/s f32 peak.  So each is bound by
// bytes.
//
// Design (all three): compact each tile row's nonzeros, gather only their
// rows.  A dense T x T tile product (178 / 268 / 357 GFLOP here) spends ~99%
// of its scores, exps and products on zeros.  Instead one warp owns one
// output row: destination row i of a row tile for K3 and K4, source row j of
// a column-sorted row tile for K5.  It keeps its own rows (q_i and g_i for
// K4; k_j and v_j for K5: 8 floats a lane for d <= 256) and its output rows
// (num; dq; dk and dv) in registers, walks its row tile's tiles through
// tile_rowptr and reads its row of each tile once, 256 columns a pass (8
// bytes a lane for int8, 32 for f32).  Each lane counts the nonzeros among
// its 8 columns, a warp prefix sum gives each its place, and their rows (K3,
// K4: the source j = tile_col * T + c; K5: the destination i) land in a
// per-warp list in shared memory in column order (scan_row).  A full tile
// row fills the list 256 entries a pass; the list holds 512 and is drained
// before it can overflow.  Draining gathers only the entries' rows:
//   K3 32 entries at a time (drain_fwd).  Lane u scores entry u: s = scale *
//      q_i . k_j as one sequential chain of fmas over the full d, reading
//      both rows itself (q_i is the same address in every lane).  The chunk's
//      max (one warp_max) sets m_new = max(m_run, chunk max), num and den are
//      rescaled once by exp(m_run - m_new), and the warp then gathers v_j
//      (two entries in flight) and adds p = exp(s - m) (shuffled from lane u)
//      to den and p v_j to num in list order.  A row of the SBM holds ~9
//      nonzeros, so it fits one chunk, its m is exact and nothing is
//      rescaled.  One sweep that rescales whenever the running max grows
//      times the same (chip_sweep_flash.py).
//   K4, K5 one entry at a time (drain_bwd): every lane gathers its columns of
//      the entry's two rows (k_j and v_j for K4; q_i and g_i, with the
//      entry's stats, for K5), s = q . k and g . v are lane partials and one
//      butterfly each, a = exp(s scale - M) / den and ds = a (g.v - delta)
//      scale, and the registers take ds k_j (K4), or ds q_i and a g_i (K5).
// Zeros of vals are skipped, never multiplied.  A block is 8 warps of 1 row
// (K3, K4) or 2 (K5), and the row slices of one row tile are neighbours in
// launch order: few row tiles are in flight at once, so the rows they
// gather from their column tiles stay in L2.  Registers are capped at 64
// (K3, K4) and 80 (K5).  d > 256 takes gridDim.z slices of 256 output
// columns; each slice recomputes the dot products over the full d (K4 and
// K5 read the warp's own rows in chunks) in the same order, so K3's m and
// den come out with the same bits in every slice (slice 0 writes them).
//
// Traps:
// - Sources at or past `rows` stay in K3's list.  K4 and K5 leave them out,
//   since each of their terms there is exactly 0.  In K3 such an edge is not
//   0: its features read as zero, so s = 0 and its v row is 0, but exp(0 - m)
//   still counts in den and 0 counts toward m (the plain version's
//   zero-padded tiles compute the same).  Its gather is guarded to read
//   zeros; a row whose only edges come from such sources ends with m = 0,
//   den = its edge count and num = 0.
// - Masks are selects, never products: pad rows under padded-carry carry
//   arbitrary features, a masked exp may overflow, and 0 * inf is NaN.  K3
//   reads m as 0 while it is -inf, and the rescale factor is 0 while m_run
//   is -inf.  expf, not __expf, so the kernels hold against their plain
//   versions at f32 tolerance.
// - K3's m is held within 1e-6 (1 + |m|) of the plain version's, which is
//   tighter than the rounding of a 256-term f32 dot product: scores as lane
//   partials and a butterfly missed it at the SBM shape (1.18x the
//   tolerance in chip_smoke.py) though they were nearer the exact value.
//   So each score is one fma chain in column order, the order the plain
//   version's bmm sums in, and comes out with its bits.
// - Determinism: a row is owned by one warp, the butterfly gives every lane
//   the same bits, and its sums run in list order with no atomics, so a
//   second launch gives the same bits.
// - Pad rows: under padded-carry their tiles hold no edges, so their lists
//   are empty and they come out (0, 0, -inf) exactly, whatever features
//   they carry.
//
// What the design adds to the bound is the row gather: two rows of d floats
// a nonzero, 2 x 2,182,538 x 256 x 4 B = 4.47 GB (plus 26 MB of stats for
// K5), 1.33 ms if all of it came from HBM; the SBM's communities keep much
// of it in L2.  Measured there (chip_smoke.py on an H100 80GB HBM3 at
// 700.00 W): K3 1.088 ms, K4 0.733 ms and K5 0.974 ms, 3.2x, 1.8x and 2.0x
// their byte bounds, gathering at 4.1, 6.1 and 4.6 TB/s, so mostly from L2
// (K3's scores read k_j a row a lane, 16 bytes from each of 32 rows a load);
// the dense designs before them took 9.597, 14.159 and 22.052 ms.  With
// bf16 features (chip_smoke.py, the same card and shape) the bf16 entry
// points take K3 0.885, K4 0.689 and K5 0.919 ms against 1.138, 0.742 and
// 0.971 ms for the f32 ones in the same run: halving the gather's bytes
// buys 5-22%, so per-entry work (the butterflies and expf of K4 and K5,
// K3's lane-per-entry scores), not the gather, sets their time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

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

// The knobs below were set by timing the alternatives on the H100
// (chip_sweep_flash.py; PERF.md).  Rows a warp owns, one after another:
// fewer rows a block means fewer row tiles in flight at once, so the rows
// they gather stay in L2.
constexpr int kRowsPerWarpFwd = 1;
constexpr int kRowsPerWarpDq = 1;
constexpr int kRowsPerWarpDkv = 2;
constexpr int kChunk = 256;       // vals columns scanned at a time: 8 a lane
constexpr int kSlice = 256;       // output columns per block: 8 a lane
constexpr int kGroup = 2;         // vals rows in flight
constexpr int kUnroll = 1;        // K4, K5: list entries (two gathered rows each) in flight
constexpr int kUnrollFwd = 2;     // K3: v rows in flight
constexpr int kCap = 2 * kChunk;  // list entries per warp
// Blocks an SM, which caps the registers a thread (K3 and K4 64, K5 80):
// more warps in flight pay more than more entries in flight per warp.
constexpr int kMinBlocksFwd = 4;
constexpr int kMinBlocksDq = 4;
constexpr int kMinBlocksDkv = 3;

enum Kind { kFwd, kDq, kDkv };

__host__ __device__ constexpr int rows_per_block(Kind kind) {
  return kWarps * (kind == kFwd ? kRowsPerWarpFwd
                   : kind == kDq ? kRowsPerWarpDq : kRowsPerWarpDkv);
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

// the 8 bf16 packed in 4 words, low half first
__device__ __forceinline__ void unpack8(const uint4 raw, float (&v)[8], int off = 0) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[off + 2 * k] = __uint_as_float(w[k] << 16);
    v[off + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// 16 bytes of features at p (16-byte aligned) into v[off .. off + W)
__device__ __forceinline__ void load_run(const float* p, float (&v)[8], int off) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[off] = a.x; v[off + 1] = a.y; v[off + 2] = a.z; v[off + 3] = a.w;
}
__device__ __forceinline__ void load_run(const bf16* p, float (&v)[8], int off) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), v, off);
}

// A product's weight as the TPU kernel casts it: rounded to the features'
// type F (round to nearest even; a no-op for f32).
template <typename F>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(F) == 2) return __bfloat162float(__float2bfloat16(x));
  return x;
}

// A lane's 8 columns of the 256-column slice that starts at c0, for
// features of type F (W = 16 / sizeof(F) columns a 16-byte load): with VEC
// (d % W == 0, 16-byte aligned rows) 8 / W runs of W at c0 + 32 W h + W lane
// (f32: two float4 at c0 + 4 lane and c0 + 128 + 4 lane; bf16: one uint4 at
// c0 + 8 lane); otherwise 8 scalars at c0 + lane + 32 j.  Columns at or past
// d read 0 and are not written.
template <bool VEC, typename F>
__device__ __forceinline__ void load_cols(const F* row, int c0, int lane, int d,
                                          float (&v)[8]) {
  constexpr int W = 16 / sizeof(F);
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 8 / W; ++h) {
      const int c = c0 + 32 * W * h + W * lane;
      if (c < d) {
        load_run(row + c, v, W * h);
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

// The f32 outputs, in the columns load_cols<VEC, F> gives a lane.
template <bool VEC, typename F>
__device__ __forceinline__ void store_cols(float* row, int c0, int lane, int d,
                                           const float (&v)[8]) {
  constexpr int W = 16 / sizeof(F);
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 8 / W; ++h) {
      const int c = c0 + 32 * W * h + W * lane;
      if (c < d) {
#pragma unroll
        for (int i = 0; i < W; i += 4)
          *reinterpret_cast<float4*>(row + c + i) =
              make_float4(v[W * h + i], v[W * h + i + 1], v[W * h + i + 2], v[W * h + i + 3]);
      }
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

// Walks row r of the tiles [t_begin, t_end), kChunk columns a pass and
// kGroup passes in flight, and appends the gathered row (tile_col * T +
// column) of each nonzero to the warp's list `lst` in column order.  Rows at
// or past `rows` stay in the list with KEEP_PAST (K3) and are left out
// otherwise (K4, K5).  Calls drain(n) with the list's n entries before a
// pass could overflow it, and once at the end.
template <bool KEEP_PAST, typename V, typename Drain>
__device__ __forceinline__ void scan_row(const V* __restrict__ vals,
                                         const int* __restrict__ tile_col, int t_begin,
                                         int t_end, int r, int tile, int rows, int* lst,
                                         Drain&& drain) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = (tile + kChunk - 1) / kChunk;
  const int n_items = (t_end - t_begin) * n_chunks;
  const int64_t tt = (int64_t)tile * tile;
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
        if (v[g][j] != 0.f && (KEEP_PAST || xcol[g] + j < rows)) nz |= 1u << j;
      const int cnt = __popc(nz);
      int incl = cnt;  // inclusive prefix sum over lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (n + total > kCap) {
        drain(n);
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
  drain(n);
}

// ---------------------------------------------------------------------------
// K3: forward partials
// ---------------------------------------------------------------------------

// The dot product of two rows of d features as one sequential chain of fmas
// in column order from 0, the order the plain version's bmm sums in: the
// scores, and so m, come out with its bits (bf16 products are exact in f32).
template <bool VEC>
__device__ __forceinline__ float dot_seq(const float* a, const float* b, int d) {
  float s = 0.f;
  if (VEC) {
#pragma unroll 4
    for (int c = 0; c < d; c += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a + c));
      const float4 y = __ldg(reinterpret_cast<const float4*>(b + c));
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
      s = fmaf(x.z, y.z, s);
      s = fmaf(x.w, y.w, s);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < d; ++c) s = fmaf(__ldg(a + c), __ldg(b + c), s);
  }
  return s;
}

template <bool VEC>
__device__ __forceinline__ float dot_seq(const bf16* a, const bf16* b, int d) {
  float s = 0.f;
  if (VEC) {
#pragma unroll 2
    for (int c = 0; c < d; c += 8) {
      float x[8], y[8];
      load8(a + c, x);
      load8(b + c, y);
#pragma unroll
      for (int j = 0; j < 8; ++j) s = fmaf(x[j], y[j], s);
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < d; ++c) s = fmaf(load1(a + c), load1(b + c), s);
  }
  return s;
}

// A warp's destination row while it drains its list: q_i at full width,
// the slice's num columns (8 a lane), and the running max and sum.
template <typename F>
struct FwdRow {
  const F* q_row;
  float num[8];
  float m, den;
};

// Adds the list's n entries to the row, 32 at a time (the header's design).
template <bool VEC, typename F>
__device__ __forceinline__ void drain_fwd(const int* lst, int n, FwdRow<F>& w,
                                          const F* __restrict__ k,
                                          const F* __restrict__ v, int rows, int c0,
                                          int lane, int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += 32) {
    const int n_b = n - b < 32 ? n - b : 32;
    // lane u scores entry b + u; a row past `rows` scores 0
    float s = -INFINITY;
    if (lane < n_b) {
      const int row = lst[b + lane];
      s = (row < rows ? dot_seq<VEC>(w.q_row, k + (int64_t)row * d, d) : 0.f) * scale;
    }
    // one rescale a chunk; the factor is 0 while m_run is -inf
    const float m_new = fmaxf(w.m, warp_max(s));
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float r = isfinite(w.m) ? expf(w.m - m_safe) : 0.f;
    w.m = m_new;
    w.den *= r;
#pragma unroll
    for (int c = 0; c < 8; ++c) w.num[c] *= r;
    const float p_lane = expf(s - m_safe);
    // the weights and the v rows, in list order
    for (int u = 0; u < n_b; u += kUnrollFwd) {
      float x[kUnrollFwd][8], p[kUnrollFwd];
#pragma unroll
      for (int uu = 0; uu < kUnrollFwd; ++uu) {
        p[uu] = __shfl_sync(kFull, p_lane, (u + uu) & 31);
#pragma unroll
        for (int c = 0; c < 8; ++c) x[uu][c] = 0.f;
        if (u + uu >= n_b) continue;  // warp-uniform
        const int row = lst[b + u + uu];
        if (row < rows) load_cols<VEC>(v + (int64_t)row * d, c0, lane, d, x[uu]);
      }
#pragma unroll
      for (int uu = 0; uu < kUnrollFwd; ++uu) {
        if (u + uu >= n_b) break;  // warp-uniform
        w.den += p[uu];
        const float pv = round_to<F>(p[uu]);
#pragma unroll
        for (int c = 0; c < 8; ++c) w.num[c] = fmaf(pv, x[uu][c], w.num[c]);
      }
    }
  }
  __syncwarp();
}

template <typename V, typename F, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksFwd)
flash_fwd_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                 const int* __restrict__ tile_rowptr, const F* __restrict__ q,
                 const F* __restrict__ k, const F* __restrict__ v,
                 float* __restrict__ num, float* __restrict__ ml, int tile, int rows, int d,
                 float scale) {
  __shared__ int lst_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* lst = lst_all[warp];
  constexpr int kRowsPerBlock = rows_per_block(kFwd);
  const int n_slices = (tile + kRowsPerBlock - 1) / kRowsPerBlock;
  const int rt = blockIdx.x / n_slices;
  const int slice = blockIdx.x - rt * n_slices;
  const int c0 = blockIdx.z * kSlice;
  const int t_begin = __ldg(tile_rowptr + rt), t_end = __ldg(tile_rowptr + rt + 1);

  for (int kk = 0; kk < kRowsPerWarpFwd; ++kk) {
    const int r = slice * kRowsPerBlock + kk * kWarps + warp;
    const int64_t grow = (int64_t)rt * tile + r;
    if (r >= tile || grow >= rows) break;  // warp-uniform
    FwdRow<F> w;
    w.q_row = q + grow * d;
    w.m = -INFINITY;
    w.den = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) w.num[c] = 0.f;
    scan_row<true>(vals, tile_col, t_begin, t_end, r, tile, rows, lst, [&](int n) {
      drain_fwd<VEC>(lst, n, w, k, v, rows, c0, lane, d, scale);
    });
    store_cols<VEC, F>(num + grow * d, c0, lane, d, w.num);
    if (blockIdx.z == 0 && lane == 0) {
      ml[grow * 2] = w.m;
      ml[grow * 2 + 1] = w.den;
    }
  }
}

// ---------------------------------------------------------------------------
// K4, K5: gradients
// ---------------------------------------------------------------------------

// What a warp's row holds while it drains its list.  K4 (DKV false): the
// own rows are q_i and g_i, with their stats; the gathered rows are k_j and
// v_j.  K5: the own rows are k_j and v_j; the gathered rows q_i and g_i come
// with the stats of row i.
template <typename F>
struct BwdRow {
  const F* own_a;  // the own rows at full width (read in chunks when WIDE)
  const F* own_b;
  float oa[8], ob[8];  // their 8 columns a lane (d <= 256)
  float m, den, delta;  // K4: the own row's stats
  float acc_a[8], acc_b[8];  // dq, or dk and dv: the slice's 8 columns a lane
};

// Adds the terms of the list's n entries to the row's registers, in list
// order.  gat_a / gat_b are the gathered arrays (K4: k, v; K5: q, g).
template <typename F, bool VEC, bool WIDE, bool DKV>
__device__ __forceinline__ void drain_bwd(const int* lst, int n, BwdRow<F>& w,
                                          const F* __restrict__ gat_a,
                                          const F* __restrict__ gat_b,
                                          const float* __restrict__ stats, int c0, int lane,
                                          int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += kUnroll) {
    float xa[kUnroll][8], xb[kUnroll][8], s[kUnroll], dav[kUnroll];
    float m[kUnroll], den[kUnroll], delta[kUnroll];
    const F* ra[kUnroll];
    const F* rb[kUnroll];
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
      const float ds = round_to<F>(a * (dav[u] - delta[u]) * scale);
      const float ar = round_to<F>(a);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.acc_a[c] = fmaf(ds, xa[u][c], w.acc_a[c]);
        if (DKV) w.acc_b[c] = fmaf(ar, xb[u][c], w.acc_b[c]);
      }
    }
  }
  __syncwarp();
}

// K4 (DKV false): own = (q, g), gathered = (k, v), out_a = dq.
// K5 (DKV true):  own = (k, v), gathered = (q, g), out_a = dk, out_b = dv;
// vals, tile_col and tile_rowptr are then the transposed set's.
template <typename V, typename F, bool VEC, bool WIDE, bool DKV>
__global__ void __launch_bounds__(kThreads, DKV ? kMinBlocksDkv : kMinBlocksDq)
flash_bwd_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                 const int* __restrict__ tile_rowptr, const F* __restrict__ own_a,
                 const F* __restrict__ own_b, const F* __restrict__ gat_a,
                 const F* __restrict__ gat_b, const float* __restrict__ stats,
                 float* __restrict__ out_a, float* __restrict__ out_b, int tile, int rows,
                 int d, float scale) {
  __shared__ int lst_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* lst = lst_all[warp];
  // the row slices of one row tile are neighbours in launch order, so they
  // run together and share the rows they gather in L2
  constexpr int kRowsPerWarp = DKV ? kRowsPerWarpDkv : kRowsPerWarpDq;
  constexpr int kRowsPerBlock = rows_per_block(DKV ? kDkv : kDq);
  const int n_slices = (tile + kRowsPerBlock - 1) / kRowsPerBlock;
  const int rt = blockIdx.x / n_slices;
  const int slice = blockIdx.x - rt * n_slices;
  const int c0 = blockIdx.z * kSlice;
  const int t_begin = __ldg(tile_rowptr + rt), t_end = __ldg(tile_rowptr + rt + 1);

  for (int k = 0; k < kRowsPerWarp; ++k) {
    // the block's warps take neighbouring rows, so their vals rows are adjacent
    const int r = slice * kRowsPerBlock + k * kWarps + warp;
    const int64_t grow = (int64_t)rt * tile + r;
    if (r >= tile || grow >= rows) break;  // warp-uniform
    BwdRow<F> w;
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
    scan_row<false>(vals, tile_col, t_begin, t_end, r, tile, rows, lst, [&](int n) {
      drain_bwd<F, VEC, WIDE, DKV>(lst, n, w, gat_a, gat_b, stats, c0, lane, d, scale);
    });
    store_cols<VEC, F>(out_a + grow * d, c0, lane, d, w.acc_a);
    if (DKV) store_cols<VEC, F>(out_b + grow * d, c0, lane, d, w.acc_b);
  }
}

// The grid of every kernel: the row slices of each row tile along x, the
// 256-column output slices along z.
dim3 grid_of(Kind kind, int nr, int tile, int d) {
  return dim3(nr * ((tile + rows_per_block(kind) - 1) / rows_per_block(kind)), 1,
              (d + kSlice - 1) / kSlice);
}

// Calls L<V, F, VEC, WIDE>::run(args...) for the store type V (vals_kind
// 0 f32, 1 int8, 2 bf16), the 16-byte path (d a multiple of W = 16 /
// sizeof(F)) and the wide path (d > 256).
template <template <typename, typename, bool, bool> class L, typename V, typename F,
          typename... Args>
void by_shape(bool vec, bool wide, Args... args) {
  if (vec) {
    if (wide) L<V, F, true, true>::run(args...); else L<V, F, true, false>::run(args...);
  } else {
    if (wide) L<V, F, false, true>::run(args...); else L<V, F, false, false>::run(args...);
  }
}

template <template <typename, typename, bool, bool> class L, typename F, typename... Args>
void dispatch(int vals_kind, int d, Args... args) {
  const bool vec = d % (16 / (int)sizeof(F)) == 0, wide = d > kSlice;
  if (vals_kind == 1) by_shape<L, int8_t, F>(vec, wide, args...);
  else if (vals_kind == 2) by_shape<L, bf16, F>(vec, wide, args...);
  else by_shape<L, float, F>(vec, wide, args...);
}

// K3 takes no wide path: a lane's score runs over the full d in any slice.
template <typename V, typename F, bool VEC, bool WIDE>
struct LaunchFwd {
  static void run(const void* vals, const int* tc, const int* tp, const void* q,
                  const void* k, const void* v, float* num, float* ml, int nr, int tile,
                  int rows, int d, float scale, cudaStream_t stream) {
    flash_fwd_kernel<V, F, VEC><<<grid_of(kFwd, nr, tile, d), kThreads, 0, stream>>>(
        static_cast<const V*>(vals), tc, tp, static_cast<const F*>(q),
        static_cast<const F*>(k), static_cast<const F*>(v), num, ml, tile, rows, d, scale);
  }
};

template <bool DKV>
struct LaunchBwd {
  template <typename V, typename F, bool VEC, bool WIDE>
  struct Of {
    static void run(const void* vals, const int* tc, const int* tp, const void* own_a,
                    const void* own_b, const void* gat_a, const void* gat_b,
                    const float* stats, float* out_a, float* out_b, int nr, int tile,
                    int rows, int d, float scale, cudaStream_t stream) {
      flash_bwd_kernel<V, F, VEC, WIDE, DKV>
          <<<grid_of(DKV ? kDkv : kDq, nr, tile, d), kThreads, 0, stream>>>(
              static_cast<const V*>(vals), tc, tp, static_cast<const F*>(own_a),
              static_cast<const F*>(own_b), static_cast<const F*>(gat_a),
              static_cast<const F*>(gat_b), stats, out_a, out_b, tile, rows, d, scale);
    }
  };
};

template <typename F>
int launch_fwd(const void* vals, int vals_kind, const int* tile_col, const int* tile_rowptr,
               const void* q, const void* k, const void* v, float* num, float* ml,
               int n_rowtiles, int tile, int rows, int d, float scale, cudaStream_t stream) {
  dispatch<LaunchFwd, F>(vals_kind, d, vals, tile_col, tile_rowptr, q, k, v, num, ml,
                         n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_dq(const void* vals, int vals_kind, const int* tile_col, const int* tile_rowptr,
              const void* q, const void* k, const void* v, const void* g, const float* stats,
              float* out, int n_rowtiles, int tile, int rows, int d, float scale,
              cudaStream_t stream) {
  dispatch<LaunchBwd<false>::Of, F>(vals_kind, d, vals, tile_col, tile_rowptr, q, g, k, v,
                                    stats, out, static_cast<float*>(nullptr), n_rowtiles, tile,
                                    rows, d, scale, stream);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_dkv(const void* vals_t, int vals_kind, const int* tile_col_t,
               const int* tile_rowptr_t, const void* q, const void* k, const void* v,
               const void* g, const float* stats, float* dk, float* dv, int n_rowtiles,
               int tile, int rows, int d, float scale, cudaStream_t stream) {
  dispatch<LaunchBwd<true>::Of, F>(vals_kind, d, vals_t, tile_col_t, tile_rowptr_t, k, v, q,
                                   g, stats, dk, dv, n_rowtiles, tile, rows, d, scale, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched).  The caller guarantees: vals (nt, tile, tile) f32
// (vals_kind 0), int8 (1) or bf16 (2), contiguous and 16-byte aligned;
// tile a multiple of 16; tile_col (nt) and tile_rowptr (n_rowtiles + 1)
// int32; q, k, v, g (rows, d) f32 (the f32 entry points) or bf16 (_bf16),
// the outputs (rows, d) f32, all contiguous and 16-byte aligned, and stats
// (rows, 3) f32, contiguous; 0 < rows <= n_rowtiles * tile; d > 0.

extern "C" int plnlp_flash_tiles_fwd(const void* vals, int vals_kind, const int* tile_col,
                                     const int* tile_rowptr, const float* q, const float* k,
                                     const float* v, float* num, float* ml, int n_rowtiles,
                                     int tile, int rows, int d, float scale,
                                     cudaStream_t stream) {
  return launch_fwd<float>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, num, ml,
                           n_rowtiles, tile, rows, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_fwd_bf16(const void* vals, int vals_kind,
                                          const int* tile_col, const int* tile_rowptr,
                                          const void* q, const void* k, const void* v,
                                          float* num, float* ml, int n_rowtiles, int tile,
                                          int rows, int d, float scale, cudaStream_t stream) {
  return launch_fwd<bf16>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, num, ml,
                          n_rowtiles, tile, rows, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dq(const void* vals, int vals_kind, const int* tile_col,
                                    const int* tile_rowptr, const float* q, const float* k,
                                    const float* v, const float* g, const float* stats,
                                    float* out, int n_rowtiles, int tile, int rows, int d,
                                    float scale, cudaStream_t stream) {
  return launch_dq<float>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, g, stats, out,
                          n_rowtiles, tile, rows, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dq_bf16(const void* vals, int vals_kind, const int* tile_col,
                                         const int* tile_rowptr, const void* q, const void* k,
                                         const void* v, const void* g, const float* stats,
                                         float* out, int n_rowtiles, int tile, int rows, int d,
                                         float scale, cudaStream_t stream) {
  return launch_dq<bf16>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, g, stats, out,
                         n_rowtiles, tile, rows, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dkv(const void* vals_t, int vals_kind,
                                     const int* tile_col_t, const int* tile_rowptr_t,
                                     const float* q, const float* k, const float* v,
                                     const float* g, const float* stats, float* dk, float* dv,
                                     int n_rowtiles, int tile, int rows, int d, float scale,
                                     cudaStream_t stream) {
  return launch_dkv<float>(vals_t, vals_kind, tile_col_t, tile_rowptr_t, q, k, v, g, stats, dk,
                           dv, n_rowtiles, tile, rows, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dkv_bf16(const void* vals_t, int vals_kind,
                                          const int* tile_col_t, const int* tile_rowptr_t,
                                          const void* q, const void* k, const void* v,
                                          const void* g, const float* stats, float* dk,
                                          float* dv, int n_rowtiles, int tile, int rows, int d,
                                          float scale, cudaStream_t stream) {
  return launch_dkv<bf16>(vals_t, vals_kind, tile_col_t, tile_rowptr_t, q, k, v, g, stats, dk,
                          dv, n_rowtiles, tile, rows, d, scale, stream);
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
