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
// f32 (plnlp_flash_tiles_{fwd,dq,dkv}) or bf16 (the _bf16 entry points) of
// d columns, stats is f32 (M, den, delta) rows, all 16-byte aligned.  Two row
// counts: `rows` for the arrays of the rows a launch owns (its output rows)
// and `rows_g` for the arrays its tile columns gather from:
//   K3  own q, num, ml;          gathered k, v
//   K4  own q, g, stats, dq;     gathered k, v
//   K5  own k, v, dk, dv;        gathered q, g, stats
// One operand passes rows_g = rows; a shard of a tiled partition passes its
// rows_per_shard own rows and the S * rows_per_shard rows of the gathered
// buffer.  Rows past either count read as zero features and as stats
// (0, 1, 0).  The outputs are f32 in both.  Any d and any T that is a
// multiple of 16 are taken (the TPU path pads d to 128 lanes).
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
//      times the same (chip_sweep_flash.py).  bf16 features with d % 8 ==
//      0 take the packed kernel instead (below).
//   K4, K5 one entry at a time (drain_bwd): every lane gathers its columns of
//      the entry's two rows (k_j and v_j for K4; q_i and g_i, with the
//      entry's stats, for K5), s = q . k and g . v are lane partials and one
//      butterfly each, a = exp(s scale - M) / den and ds = a (g.v - delta)
//      scale, and the registers take ds k_j (K4), or ds q_i and a g_i (K5).
//      bf16 features with d % 8 == 0 and d <= 256 take K4's and K5's own
//      kernels (below), with the same arithmetic a few entries a step; f32
//      features and the bf16 wide and scalar paths keep drain_bwd.
// Zeros of vals are skipped, never multiplied.  A block is 8 warps of 1 row
// (K3, K4) or 2 (K5), and the row slices of one row tile are neighbours in
// launch order: few row tiles are in flight at once, so the rows they
// gather from their column tiles stay in L2.  Registers are capped at 64
// (K3, K4) and 80 (K5; K4's bf16 kernel 80, K5's 128).  d > 256 takes
// gridDim.z slices of 256 output
// columns; each slice recomputes the dot products over the full d (K4 and
// K5 read the warp's own rows in chunks) in the same order, so K3's m and
// den come out with the same bits in every slice (slice 0 writes them).
//
// Traps:
// - Sources at or past `rows_g` stay in K3's list.  K4 and K5 leave them out,
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
//
// K3 in bf16, redesigned (flash_fwd_packed_kernel).  The lane-per-entry
// drain above spends most of its time on the scores (chip_sweep_flash.py,
// one H100 80GB HBM3 at 700.00 W, the SBM shape, int8 tiles: the list scan
// alone 0.220 ms, the scan and the scores 0.651, the scan and the v rows
// 0.478, all 0.887; bound 0.233 ms by bytes): a row holds ~9 entries, so
// ~9 of 32 lanes score and the warp issues every instruction of a 256-fma
// chain for them.  The packed kernel gives a warp kRowsPk rows and scores
// the chunks of both in one 32-lane pass, each row keeping drain_fwd's
// chunks, chunk max and rescale, so the bits are the same.  What it must
// not give up is warps: each warp walks its rows' scans, scores and v rows
// one after another, and the kernel is bound by the latency of those
// steps, so it keeps its shared memory to the list (2.5 KB a warp) and
// reads k and v from global memory as drain_fwd does.  Versions that
// copied the k and v rows into shared memory with cp.async, or packed 8
// rows a warp, held 6-16 warps an SM and were slower than drain_fwd
// (PERF.md).  Measured (the same script and card): 0.745 ms on int8 tiles
// and 0.794 on bf16 tiles against drain_fwd's 0.883 and 0.895 in the same
// run, 3.2x the bound; 1 row a warp 0.975, 3 rows 0.741, 4 rows 0.89-1.0.
//
// K4 and K5 in bf16, redesigned (flash_dq_bf16_kernel, flash_dkv_bf16_kernel:
// bf16 features, d % 8 == 0, d <= 256; the wide and the scalar paths keep
// flash_bwd_kernel).  Split on the H100 (chip_sweep_flash.py, one H100 80GB
// HBM3 at 700.00 W, the SBM shape, int8 tiles), drain_bwd took 0.917 ms for
// K5-bf16 (the list scan alone 0.276, the scan and the gathers with no math
// 0.524, the scan and the math on rows in registers with no gather 0.588)
// and 0.685 for K4-bf16 (0.230, 0.374, 0.479).  The parts added up: a warp
// had one entry in flight, and its gathers, stats, butterflies, expf and
// divide were one dependent chain.  Both bf16 kernels keep one warp an
// output row, the lists and each sum's order (the same bits) and change
// the rest:
// - one walk for both (scan_rows_bf): the warp's rows' tile rows as one
//   stream of items, a cursor loading the next group of items before the
//   scan tests the current ones, across rows (so the next row's first
//   loads fly while a row drains), counting rows, tiles and chunks with no
//   division;
// - the own rows (K4 q_i and g_i, K5 k_j and v_j) stay packed (16 bytes
//   each a lane) and are unpacked at each dot product; the gathered rows of
//   a step's entries are issued together and kept raw until their math;
// - K5 loads the stats of each 32-entry batch one lane an entry and hands
//   them out by shuffle; K4's stats are its own row's, loaded with q_i;
// - a step's dot products (two an entry) are reduced together (warp_sums:
//   each keeps warp_sum's tree of additions, in 17 shuffles for 4 entries
//   where 8 butterflies take 40).
// Both are latency-bound, so what sets them is warps an SM against entries
// in flight a warp.  K5 needs ~126 registers at 4 entries a step and runs 2
// blocks of 8 warps an SM: at the 80 registers of 3 blocks every version
// spilled 100-630 bytes and lost.  K4, with one sum and no stats an entry,
// runs 2 entries a step in 80 registers at 3 blocks; its int8 store keeps
// 2 items a group ahead, the 2-byte store 1 (a second spilled 68 bytes and
// lost).  16 KB of shared memory a block (the lists).  Measured there:
// K5-bf16 0.757 ms on int8 tiles and 0.759 on bf16 tiles against
// drain_bwd's 0.915 and 0.928 in the same run (its scan alone 0.235, with
// the gathers and no math 0.505, with the math and no gather 0.540);
// K4-bf16 0.594 ms on int8 tiles and 0.639 on bf16 tiles against
// drain_bwd's 0.683 and 0.688, 0.167 and 0.178 against 0.181 and 0.182 on
// a shard of the 4-shard tiled partition (its scan alone 0.174, with the
// gathers 0.406, with the math 0.443).  Tried and lost, with the same
// bits: for K5 1 or 2 entries a step, with or without the next step's rows
// issued before a step's math (0.81-0.96), 8 entries a step (spills, 1.32),
// 3 blocks an SM (0.85-1.25), 1, 2 or 8 rows a warp (0.88, 0.79, 0.78); for
// K4 4 entries a step at 2 blocks (114 registers: 0.672), 1 entry (0.704),
// 4 blocks (64 registers, spills: 0.689), 8 entries (0.93-1.01), 2 or 8 rows a
// warp (0.606, 0.629; 2 rows is 3% faster on the shard), 1 item a group on
// int8 tiles (0.626), each item's values tested as the group is handed
// over in place of as the scan reaches it (0.595, and 0.688 on bf16 tiles).

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

// K3 with bf16 features and 16-byte rows (the packed design, below; set by
// timing on the H100: chip_sweep_flash.py).
constexpr int kWarpsPk = 4;        // warps a block
constexpr int kRowsPk = 2;         // destination rows a warp, one after another
constexpr int kUnrollPk = 2;       // v rows in flight
constexpr int kGroupPk = 2;        // tile-row items (kChunk columns) loaded a group ahead
constexpr int kMinBlocksPk = 7;    // blocks an SM
constexpr int kRing = 512;         // list entries a warp (a power of two, > 64 + kChunk)
static_assert(kRowsPk < 128, "a list entry's tag holds its local row in 7 bits");
constexpr int kWarpBytesPk = kRing * 4 + kRing;

// K5 with bf16 features, 16-byte rows and d <= 256 (flash_dkv_bf16_kernel,
// below; set by timing on the H100: chip_sweep_flash.py).
constexpr int kRowsDkvBf = 4;       // source rows a warp, one after another
constexpr int kGroupDkvBf = 2;      // tile-row items (kChunk columns) loaded a group ahead
constexpr int kUnrollDkvBf = 4;     // list entries a step (their rows raw until their math)
constexpr int kMinBlocksDkvBf = 2;  // blocks an SM

// K4 with bf16 features, 16-byte rows and d <= 256 (flash_dq_bf16_kernel,
// on K5-bf16's scan; set by timing on the H100: chip_sweep_flash.py).
constexpr int kRowsDqBf = 4;           // destination rows a warp, one after another
constexpr int kGroupDqBf = 2;          // tile-row items (kChunk columns) loaded a group ahead
constexpr int kGroupDqBfWideVals = 1;  // the same on the 2- and 4-byte stores (larger items)
constexpr int kUnrollDqBf = 2;         // list entries a step (their rows raw until their math)
constexpr int kMinBlocksDqBf = 3;      // blocks an SM (80 registers)

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
// or past the gathered count `rows_g` stay in the list with KEEP_PAST (K3)
// and are left out otherwise (K4, K5).  Calls drain(n) with the list's n entries before a
// pass could overflow it, and once at the end.
template <bool KEEP_PAST, typename V, typename Drain>
__device__ __forceinline__ void scan_row(const V* __restrict__ vals,
                                         const int* __restrict__ tile_col, int t_begin,
                                         int t_end, int r, int tile, int rows_g, int* lst,
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
        if (v[g][j] != 0.f && (KEEP_PAST || xcol[g] + j < rows_g)) nz |= 1u << j;
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
                                          const F* __restrict__ v, int rows_g, int c0,
                                          int lane, int d, float scale) {
  __syncwarp();
  for (int b = 0; b < n; b += 32) {
    const int n_b = n - b < 32 ? n - b : 32;
    // lane u scores entry b + u; a row past `rows_g` scores 0
    float s = -INFINITY;
    if (lane < n_b) {
      const int row = lst[b + lane];
      s = (row < rows_g ? dot_seq<VEC>(w.q_row, k + (int64_t)row * d, d) : 0.f) * scale;
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
        if (row < rows_g) load_cols<VEC>(v + (int64_t)row * d, c0, lane, d, x[uu]);
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
                 float* __restrict__ num, float* __restrict__ ml, int tile, int rows,
                 int rows_g, int d, float scale) {
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
    scan_row<true>(vals, tile_col, t_begin, t_end, r, tile, rows_g, lst, [&](int n) {
      drain_fwd<VEC>(lst, n, w, k, v, rows_g, c0, lane, d, scale);
    });
    store_cols<VEC, F>(num + grow * d, c0, lane, d, w.num);
    if (blockIdx.z == 0 && lane == 0) {
      ml[grow * 2] = w.m;
      ml[grow * 2 + 1] = w.den;
    }
  }
}

// ---------------------------------------------------------------------------
// K3 in bf16: the chunks of several rows packed into the lanes
// ---------------------------------------------------------------------------

// A warp's state while it walks the packed list: the row whose sums are in
// registers (cur, local to the warp's kRowsPk rows; -1 before the first),
// its running max and sums, and the rows [0, done) already written.
struct PkRow {
  int cur, done;
  float m, den;
  float num[8];
};

// A list entry's tag: the local row (low 7 bits) and whether it starts a
// chunk (bit 7): a chunk is what drain_fwd takes as one, the row's entries
// from one of its drains, 32 at a time.
constexpr int kChunkStart = 0x80;

// Writes the warp's local row lr: its sums (cur), or an empty row.
__device__ __forceinline__ void put_row_pk(float* __restrict__ num, float* __restrict__ ml,
                                           int64_t grow, const float (&v)[8], float m,
                                           float den, int c0, int lane, int d) {
  store_cols<true, bf16>(num + grow * d, c0, lane, d, v);
  if (blockIdx.z == 0 && lane == 0) {
    ml[grow * 2] = m;
    ml[grow * 2 + 1] = den;
  }
}

// Writes the rows before local row `upto`: the row in registers, then the
// rows with no entry as (0, 0, -inf).
__device__ __forceinline__ void flush_rows_pk(PkRow& w, int upto, float* __restrict__ num,
                                              float* __restrict__ ml, int64_t grow0, int c0,
                                              int lane, int d) {
  if (w.cur >= 0 && w.cur < upto) {
    put_row_pk(num, ml, grow0 + w.cur, w.num, w.m, w.den, c0, lane, d);
    w.done = w.cur + 1;
  }
  float z[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) z[c] = 0.f;
  for (int r = w.done; r < upto; ++r)
    put_row_pk(num, ml, grow0 + r, z, -INFINITY, 0.f, c0, lane, d);
  if (upto > w.done) w.done = upto;
}

// One pass over the list entries [head, head + n_b), whole chunks of one
// or more rows, lane u taking entry head + u.  The scores: each lane's
// q_i . k_j as one fma chain in column order (dot_seq), its row's q_i and
// its entry's k_j read by the lane itself.  Then per chunk the max, with
// the row's earlier max, sets m; the weights p = exp(s - m); and the warp
// walks the entries in order, kUnrollPk v rows in flight: at a chunk's
// first entry the row's sums are rescaled once by exp(m_old - m) (a new
// row starts from (-inf, 0, 0)), then den += p and num += bf16(p) v_j.
// That is drain_fwd's arithmetic row for row, so the bits are its.
__device__ __forceinline__ void pass_pk(const int* lst, const unsigned char* tag, int head,
                                        int n_b, PkRow& w, const bf16* __restrict__ q,
                                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                                        float* __restrict__ num, float* __restrict__ ml,
                                        int64_t grow0, int rows_g, int c0, int lane, int d,
                                        float scale) {
  const bool act = lane < n_b;
  const int pos = (head + lane) & (kRing - 1);
  const int jrow = act ? lst[pos] : 0;
  const int tg = act ? tag[pos] : 0x7f;
  const int lr = tg & 0x7f;
  const bool scored = act && jrow < rows_g;
  const int crow_lane = scored ? jrow : -1;
  float s = 0.f;
  if (scored) s = dot_seq<true>(q + (grow0 + lr) * d, k + (int64_t)jrow * d, d);
  s = act ? (scored ? s : 0.f) * scale : -INFINITY;

  const int lr_prev = __shfl_up_sync(kFull, lr, 1);
  const unsigned row_starts = __ballot_sync(kFull, lane == 0 || lr != lr_prev);
  const unsigned below = (2u << lane) - 1u;  // lanes 0 .. lane
  const int seg = 31 - __clz((int)(row_starts & below));
  float mx = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, mx, off);
    if (lane - off >= seg) mx = fmaxf(mx, t);
  }
  const unsigned chunk_starts =
      __ballot_sync(kFull, act && (tg & kChunkStart)) | (n_b < 32 ? 1u << n_b : 0u);
  const unsigned above = chunk_starts & ~below;
  const int end = above ? __ffs((int)above) - 2 : 31;
  float m = __shfl_sync(kFull, mx, end);
  if (lr == w.cur) m = fmaxf(w.m, m);
  const float p_lane = expf(s - (isfinite(m) ? m : 0.f));

  const int vc = c0 + 8 * lane;
  for (int u = 0; u < n_b; u += kUnrollPk) {
    uint4 x[kUnrollPk];
#pragma unroll
    for (int uu = 0; uu < kUnrollPk; ++uu) {
      const int row = __shfl_sync(kFull, crow_lane, (u + uu) & 31);
      x[uu] = make_uint4(0u, 0u, 0u, 0u);
      if (u + uu < n_b && row >= 0 && vc < d)
        x[uu] = __ldg(reinterpret_cast<const uint4*>(v + (int64_t)row * d + vc));
    }
#pragma unroll
    for (int uu = 0; uu < kUnrollPk; ++uu) {
      const int e = u + uu;
      if (e >= n_b) break;  // warp-uniform
      const float p = __shfl_sync(kFull, p_lane, e);
      const float m_e = __shfl_sync(kFull, m, e);
      const int lr_e = __shfl_sync(kFull, lr, e);
      if (chunk_starts >> e & 1u) {
        if (lr_e != w.cur) {
          flush_rows_pk(w, lr_e, num, ml, grow0, c0, lane, d);
          w.cur = lr_e;
          w.m = -INFINITY;
          w.den = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) w.num[c] = 0.f;
        }
        const float m_safe = isfinite(m_e) ? m_e : 0.f;
        const float r = isfinite(w.m) ? expf(w.m - m_safe) : 0.f;
        w.m = m_e;
        w.den *= r;
#pragma unroll
        for (int c = 0; c < 8; ++c) w.num[c] *= r;
      }
      w.den += p;
      const float pv = round_to<bf16>(p);
      float xv[8];
      unpack8(x[uu], xv);
#pragma unroll
      for (int c = 0; c < 8; ++c) w.num[c] = fmaf(pv, xv[c], w.num[c]);
    }
  }
  __syncwarp();
}

// Eight values of a tile row as loaded (int8, bf16 or f32), and which of
// them are nonzero, so a group's loads are all issued before the first is
// tested.
template <typename V>
struct Vals8;
template <>
struct Vals8<int8_t> {
  int2 r;
  __device__ __forceinline__ void load(const int8_t* p) {
    r = __ldg(reinterpret_cast<const int2*>(p));
  }
  __device__ __forceinline__ unsigned nonzero() const {
    unsigned nz = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nz |= ((r.x >> (8 * j)) & 0xff) ? 1u << j : 0u;
      nz |= ((r.y >> (8 * j)) & 0xff) ? 1u << (4 + j) : 0u;
    }
    return nz;
  }
};
template <>
struct Vals8<bf16> {
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ unsigned nonzero() const {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    unsigned nz = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)  // -0 is zero
      nz |= (w[j / 2] >> (16 * (j & 1)) & 0x7fffu) ? 1u << j : 0u;
    return nz;
  }
};
template <>
struct Vals8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ unsigned nonzero() const {
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned nz = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) nz |= v[j] != 0.f ? 1u << j : 0u;
    return nz;
  }
};

// K3 for bf16 q, k, v with d % 8 == 0: a warp owns kRowsPk destination rows
// of a row tile, one after another, and walks their tile rows (scan_row's
// walk, kGroupPk items of kChunk columns loaded a group ahead, across the
// rows) appending their nonzeros to one list in shared memory, each tagged
// with its row and whether it starts a chunk as drain_fwd would chunk it
// (32 at a time from each of the row's drains, which come where
// drain_fwd's list of kCap would overflow).  Whenever 32 entries of whole
// chunks are ready it runs a pass over as many whole chunks as fit in 32
// lanes, so the lanes score the entries of several short rows at once.
template <typename V>
__global__ void __launch_bounds__(kWarpsPk * 32, kMinBlocksPk)
flash_fwd_packed_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                        const int* __restrict__ tile_rowptr, const bf16* __restrict__ q,
                        const bf16* __restrict__ k, const bf16* __restrict__ v,
                        float* __restrict__ num, float* __restrict__ ml, int tile, int rows,
                        int rows_g, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem_pk[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* mine = smem_pk + warp * kWarpBytesPk;
  int* lst = reinterpret_cast<int*>(mine);
  unsigned char* tag = mine + kRing * 4;
  constexpr int kRowsPerBlock = kWarpsPk * kRowsPk;
  const int n_slices = (tile + kRowsPerBlock - 1) / kRowsPerBlock;
  const int rt = blockIdx.x / n_slices;
  const int slice = blockIdx.x - rt * n_slices;
  const int c0 = blockIdx.z * kSlice;
  const int t_begin = __ldg(tile_rowptr + rt), t_end = __ldg(tile_rowptr + rt + 1);
  const int r0 = slice * kRowsPerBlock + warp * kRowsPk;  // the warp's first row in the tile
  const int64_t grow0 = (int64_t)rt * tile + r0;
  const int n_rows = (int)min((int64_t)min(kRowsPk, tile - r0), (int64_t)rows - grow0);
  if (n_rows <= 0) return;  // warp-uniform

  PkRow w;
  w.cur = -1;
  w.done = 0;
  w.m = -INFINITY;
  w.den = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) w.num[c] = 0.f;
  // entries [head, ready) are in whole chunks, [ready, tail) in the open one
  int head = 0, ready = 0, tail = 0;
  auto run_passes = [&](int min_ready) {
    while (ready - head >= min_ready && ready > head) {
      // the longest run of whole chunks from head that fits in 32 lanes
      const int avail = ready - head;
      const int off = lane + 1;
      const bool boundary = off < avail ? (tag[(head + off) & (kRing - 1)] & kChunkStart) != 0
                                        : off == avail;
      const int n_b = 32 - __clz((int)__ballot_sync(kFull, boundary));
      pass_pk(lst, tag, head, n_b, w, q, k, v, num, ml, grow0, rows_g, c0, lane, d, scale);
      head += n_b;
      __syncwarp();
    }
  };

  // the items (row lr, tile-row chunk qi) in order, f = lr * n_items + qi
  const int n_chunks = (tile + kChunk - 1) / kChunk;
  const int n_items = (t_end - t_begin) * n_chunks;
  const int total = n_rows * n_items;
  const int64_t tt = (int64_t)tile * tile;
  Vals8<V> cur[kGroupPk], nxt[kGroupPk];
  int tc_cur[kGroupPk], tc_nxt[kGroupPk];  // the item's tile column, -1 past the tile
  auto load_group = [&](int f0, Vals8<V> (&g)[kGroupPk], int (&tc)[kGroupPk]) {
#pragma unroll
    for (int j = 0; j < kGroupPk; ++j) {
      const int f = f0 + j;
      tc[j] = -1;
      if (f < total) {
        const int lr = f / n_items, qi = f - lr * n_items;
        const int i = t_begin + qi / n_chunks;
        const int col = (qi % n_chunks) * kChunk + 8 * lane;
        if (col < tile) {
          g[j].load(vals + i * tt + (int64_t)(r0 + lr) * tile + col);
          tc[j] = __ldg(tile_col + i);
        }
      }
    }
  };
  load_group(0, cur, tc_cur);
  int nd = 0;  // the row's entries since drain_fwd's last drain
  for (int f0 = 0; f0 < total; f0 += kGroupPk) {
    load_group(f0 + kGroupPk, nxt, tc_nxt);
#pragma unroll
    for (int j = 0; j < kGroupPk; ++j) {
      const int f = f0 + j;
      if (f >= total) break;  // warp-uniform
      const int lr = f / n_items, qi = f - lr * n_items;
      if (qi == 0 && lr > 0) {  // the row before is whole
        ready = tail;
        run_passes(32);
        nd = 0;
      }
      const int xcol = tc_cur[j] * tile + (qi % n_chunks) * kChunk + 8 * lane;
      const unsigned nz = tc_cur[j] >= 0 ? cur[j].nonzero() : 0u;
      const int cnt = __popc(nz);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int total_j = __shfl_sync(kFull, incl, 31);
      if (nd + total_j > kCap) nd = 0;  // drain_fwd drains here
      int i = incl - cnt;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (nz >> b & 1u) {
          const int at = (tail + i) & (kRing - 1);
          lst[at] = xcol + b;
          tag[at] = (unsigned char)(lr | ((nd + i) % 32 == 0 ? kChunkStart : 0));
          ++i;
        }
      }
      if (total_j) {
        const int last = (nd + total_j - 1) & ~31;  // the item's last chunk start, if any
        if (last >= nd) ready = tail + (last - nd);
      }
      tail += total_j;
      nd += total_j;
      __syncwarp();
      run_passes(32);
    }
#pragma unroll
    for (int j = 0; j < kGroupPk; ++j) {
      cur[j] = nxt[j];
      tc_cur[j] = tc_nxt[j];
    }
  }
  ready = tail;  // the last row's last chunk is whole
  run_passes(1);
  flush_rows_pk(w, n_rows, num, ml, grow0, c0, lane, d);
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
                 int rows_g, int d, float scale) {
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
    scan_row<false>(vals, tile_col, t_begin, t_end, r, tile, rows_g, lst, [&](int n) {
      drain_bwd<F, VEC, WIDE, DKV>(lst, n, w, gat_a, gat_b, stats, c0, lane, d, scale);
    });
    store_cols<VEC, F>(out_a + grow * d, c0, lane, d, w.acc_a);
    if (DKV) store_cols<VEC, F>(out_b + grow * d, c0, lane, d, w.acc_b);
  }
}

// ---------------------------------------------------------------------------
// K4 and K5 in bf16: one lean scan, the gathered rows kept packed and in flight
// ---------------------------------------------------------------------------

// A warp's source row while K5-bf16 drains its list: k_j and v_j as loaded
// (8 bf16 a lane, unpacked at each dot product) and the dk, dv sums.
struct DkvRowBf {
  uint4 k, v;
  float dk[8], dv[8];
};

// 16 bytes of bf16 at `p` if `on`, else zeros.
__device__ __forceinline__ uint4 load_raw(const bf16* p, bool on) {
  return on ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// The stats of list entry `e` (its gathered row's M, den, delta), one entry
// a lane; (0, 1, 0) past the list's n entries.
__device__ __forceinline__ void load_stats_bf(const int* lst, int e, int n,
                                              const float* __restrict__ stats, float& m,
                                              float& den, float& delta) {
  m = 0.f;
  den = 1.f;
  delta = 0.f;
  if (e < n) {
    const int64_t row = lst[e];
    m = __ldg(stats + row * 3);
    den = __ldg(stats + row * 3 + 1);
    delta = __ldg(stats + row * 3 + 2);
  }
}

// The two gathered rows (K4: k_j and v_j; K5: q_i and g_i) of list entries
// [e, e + kU), the lane's 16 bytes of each, raw; zeros past the list's n
// entries.
template <int kU>
__device__ __forceinline__ void issue_rows_bf(const int* lst, int e, int n,
                                              const bf16* __restrict__ a,
                                              const bf16* __restrict__ b, int col, bool on,
                                              int d, uint4 (&ra)[kU], uint4 (&rb)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const bool live = on && e + u < n;
    const int64_t row = e + u < n ? lst[e + u] : 0;
    ra[u] = load_raw(a + row * d + col, live);
    rb[u] = load_raw(b + row * d + col, live);
  }
}

// The sums of x[0 .. kV) over the warp's 32 lanes in every lane, each with
// the tree of additions warp_sum gives it (so the same bits), in fewer
// shuffles: at each of the first log2(kV) butterfly steps a lane keeps one
// half of its sums and sends the other half to its partner, which keeps
// that half; the last sum left then takes the rest of the butterfly, and
// each sum is read from a lane that holds it.  kV - 1 + 5 - log2(kV) + kV
// shuffles in place of warp_sum's 5 kV.
template <int kV>
__device__ __forceinline__ void warp_sums(float (&x)[kV], int lane) {
  static_assert(kV >= 1 && kV <= 32 && (kV & (kV - 1)) == 0, "kV a power of two up to 32");
  int o = 16;
#pragma unroll
  for (int h = kV; h > 1; h >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < h / 2; ++i) {
      const float keep = up ? x[h / 2 + i] : x[i];
      const float send = up ? x[i] : x[h / 2 + i];
      x[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
#pragma unroll
  for (; o; o >>= 1) x[0] += __shfl_xor_sync(kFull, x[0], o);
  const float held = x[0];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    int src = 0;  // the lane that holds sum v: its bit for each halving step
#pragma unroll
    for (int h = kV, bit = 16; h > 1; h >>= 1, bit >>= 1)
      if (v % h >= h / 2) src += bit;
    x[v] = __shfl_sync(kFull, held, src);
  }
}

// Adds the terms of the list's n entries to the row's sums in list order,
// as drain_bwd does for K5 (the same lane partials over the same 8
// columns, the same tree of additions for each dot product, the same expf
// and divide, the same sums), so the bits are drain_bwd's.  What differs
// is what is in flight and the work around it: the stats of each 32-entry
// batch are loaded by one lane an entry at the batch's start and handed
// out by shuffle; kUnrollDkvBf entries are taken a step, their q and g
// rows issued together and kept raw until their math; the 2 kUnrollDkvBf
// dot products of a step are reduced together (warp_sums).
__device__ __forceinline__ void drain_dkv_bf(const int* lst, int n, DkvRowBf& w,
                                             const bf16* __restrict__ q,
                                             const bf16* __restrict__ g,
                                             const float* __restrict__ stats, int lane, int d,
                                             float scale) {
  static_assert(32 % kUnrollDkvBf == 0, "a step's entries lie in one 32-entry batch");
  __syncwarp();
  const int col = 8 * lane;
  const bool on = col < d;
  float m_l, den_l, del_l;  // the stats of the batch's entry `lane`
  load_stats_bf(lst, lane, n, stats, m_l, den_l, del_l);
  for (int b = 0; b < n; b += kUnrollDkvBf) {
    uint4 qa[kUnrollDkvBf], ga[kUnrollDkvBf];
    issue_rows_bf(lst, b, n, q, g, col, on, d, qa, ga);
    if (b && (b & 31) == 0) load_stats_bf(lst, b + lane, n, stats, m_l, den_l, del_l);
    float x[2 * kUnrollDkvBf];  // s = q_i . k_j and g_i . v_j of each entry
    {
      float ok[8], ov[8];
      unpack8(w.k, ok);
      unpack8(w.v, ov);
#pragma unroll
      for (int u = 0; u < kUnrollDkvBf; ++u) {
        float xq[8], xg[8];
        unpack8(qa[u], xq);
        unpack8(ga[u], xg);
        x[2 * u] = dot8(ok, xq, 0.f);
        x[2 * u + 1] = dot8(ov, xg, 0.f);
      }
    }
    warp_sums(x, lane);
#pragma unroll
    for (int u = 0; u < kUnrollDkvBf; ++u) {
      const int e = b + u;
      const float m = __shfl_sync(kFull, m_l, e & 31);
      const float den = __shfl_sync(kFull, den_l, e & 31);
      const float delta = __shfl_sync(kFull, del_l, e & 31);
      if (e >= n) break;  // warp-uniform
      const float a = expf(x[2 * u] * scale - m) / den;
      const float ds = round_to<bf16>(a * (x[2 * u + 1] - delta) * scale);
      const float ar = round_to<bf16>(a);
      float xq[8], xg[8];
      unpack8(qa[u], xq);
      unpack8(ga[u], xg);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        w.dk[c] = fmaf(ds, xq[c], w.dk[c]);
        w.dv[c] = fmaf(ar, xg[c], w.dv[c]);
      }
    }
  }
  __syncwarp();
}

// The walk K4-bf16 and K5-bf16 share.  The warp owns kRows rows of a row
// tile, one after another (row lr is r0 + lr kWarps, as flash_bwd_kernel
// assigns them), and walks their tile rows as one stream of items (kChunk
// columns of one tile's row), a cursor loading kGroup items a group ahead
// of the ones the scan tests, across the rows, so the next row's first
// items are in flight while a row drains; it counts rows, tiles and chunks
// with no division.  The values are tested as loaded; sources at or past
// rows_g are left out (their terms are exactly 0).  The nonzeros' gathered
// rows land in the warp's list `lst` in column order, as scan_row puts
// them, and drain(n) takes the list's n entries before a group could
// overflow it and at the end of each row.  start_row(grow) readies the
// sums of global row grow (its own rows, its stats, zero sums) before its
// first drain, put_row(grow) stores them after its last; a row tile with
// no tile only starts and puts its rows.
template <int kRows, int kGroup, typename V, typename Start, typename Drain, typename Put>
__device__ __forceinline__ void scan_rows_bf(const V* __restrict__ vals,
                                             const int* __restrict__ tile_col,
                                             const int* __restrict__ tile_rowptr, int tile,
                                             int rows, int rows_g, int* lst, Start&& start_row,
                                             Drain&& drain, Put&& put_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kRowsPerBlock = kWarps * kRows;
  const int n_slices = (tile + kRowsPerBlock - 1) / kRowsPerBlock;
  const int rt = blockIdx.x / n_slices;
  const int slice = blockIdx.x - rt * n_slices;
  const int t_begin = __ldg(tile_rowptr + rt), t_end = __ldg(tile_rowptr + rt + 1);
  const int r0 = slice * kRowsPerBlock + warp;
  int n_rows = 0;
#pragma unroll
  for (int lr = 0; lr < kRows; ++lr) {
    const int r = r0 + lr * kWarps;
    if (r < tile && (int64_t)rt * tile + r < rows) n_rows = lr + 1;
  }
  if (n_rows == 0) return;  // warp-uniform
  const int n_chunks = (tile + kChunk - 1) / kChunk;
  const int64_t grow0 = (int64_t)rt * tile + r0;
  if (t_end == t_begin) {  // no tile: every row's sums are zero
    for (int lr = 0; lr < n_rows; ++lr) {
      start_row(grow0 + lr * kWarps);
      put_row(grow0 + lr * kWarps);
    }
    return;
  }

  // the load cursor: row lk, tile ik, chunk ck (lk == n_rows: past the end)
  int lk = 0, ik = t_begin, ck = 0;
  const V* vrow = vals + (int64_t)t_begin * tile * tile + (int64_t)r0 * tile + 8 * lane;
  auto load_item = [&](Vals8<V>& item, int& tc) {
    tc = -1;
    if (lk < n_rows) {
      if (ck * kChunk + 8 * lane < tile) {
        item.load(vrow + (int64_t)(ik - t_begin) * tile * tile + ck * kChunk);
        tc = __ldg(tile_col + ik);
      }
      if (++ck == n_chunks) {
        ck = 0;
        if (++ik == t_end) {
          ik = t_begin;
          ++lk;
          vrow += (int64_t)kWarps * tile;
        }
      }
    }
  };
  Vals8<V> cur[kGroup], nxt[kGroup];
  int tc_cur[kGroup], tc_nxt[kGroup];  // the item's tile column, -1 past the tile
#pragma unroll
  for (int j = 0; j < kGroup; ++j) load_item(cur[j], tc_cur[j]);
  start_row(grow0);
  // the scan's cursor: row lr, chunk ch, tile ir
  int lr = 0, ch = 0, ir = t_begin;
  int n = 0;  // list entries
  while (lr < n_rows) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) load_item(nxt[j], tc_nxt[j]);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (lr == n_rows) break;  // warp-uniform
      const int xcol = tc_cur[j] * tile + ch * kChunk + 8 * lane;
      unsigned nz = tc_cur[j] >= 0 ? cur[j].nonzero() : 0u;
      // sources at or past rows_g: their terms are exactly 0
      if (xcol + 8 > rows_g) nz &= rows_g > xcol ? (1u << (rows_g - xcol)) - 1u : 0u;
      const int cnt = __popc(nz);
      int incl = cnt;  // inclusive prefix sum over lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const int total_j = __shfl_sync(kFull, incl, 31);
      if (n + total_j > kCap) {
        drain(n);
        n = 0;
      }
      int pos = n + incl - cnt;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (nz >> b & 1u) lst[pos++] = xcol + b;
      n += total_j;
      if (++ch == n_chunks) {
        ch = 0;
        if (++ir == t_end) {  // the row is whole
          ir = t_begin;
          drain(n);
          put_row(grow0 + lr * kWarps);
          n = 0;
          if (++lr < n_rows) start_row(grow0 + lr * kWarps);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      cur[j] = nxt[j];
      tc_cur[j] = tc_nxt[j];
    }
  }
}

// K5 for bf16 q, k, v, g with d % 8 == 0 and d <= 256 (one slice): a warp
// owns kRowsDkvBf source rows of a row tile of the transposed set
// (scan_rows_bf), with k_j and v_j loaded as its walk reaches the row.  The
// lists and the sums are flash_bwd_kernel's, so the bits are its.
template <typename V>
__global__ void __launch_bounds__(kThreads, kMinBlocksDkvBf)
flash_dkv_bf16_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                      const int* __restrict__ tile_rowptr, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ q,
                      const bf16* __restrict__ g, const float* __restrict__ stats,
                      float* __restrict__ dk, float* __restrict__ dv, int tile, int rows,
                      int rows_g, int d, float scale) {
  __shared__ int lst_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  int* lst = lst_all[threadIdx.x >> 5];
  const int col = 8 * lane;
  const bool on = col < d;
  DkvRowBf w;
  scan_rows_bf<kRowsDkvBf, kGroupDkvBf>(
      vals, tile_col, tile_rowptr, tile, rows, rows_g, lst,
      [&](int64_t grow) {
        w.k = load_raw(k + grow * d + col, on);
        w.v = load_raw(v + grow * d + col, on);
#pragma unroll
        for (int c = 0; c < 8; ++c) w.dk[c] = w.dv[c] = 0.f;
      },
      [&](int n) { drain_dkv_bf(lst, n, w, q, g, stats, lane, d, scale); },
      [&](int64_t grow) {
        store_cols<true, bf16>(dk + grow * d, 0, lane, d, w.dk);
        store_cols<true, bf16>(dv + grow * d, 0, lane, d, w.dv);
      });
}

// A warp's destination row while K4-bf16 drains its list: q_i and g_i as
// loaded (8 bf16 a lane, unpacked at each dot product), the row's stats
// (M, den, delta) and the dq sums.
struct DqRowBf {
  uint4 q, g;
  float m, den, delta;
  float dq[8];
};

// Adds the terms of the list's n entries to the row's dq in list order, as
// drain_bwd does for K4 (the same lane partials over the same 8 columns,
// the same tree of additions for each dot product, the same expf and
// divide, the same sums), so the bits are drain_bwd's.  What differs is
// what is in flight and the work around it: kUnrollDqBf entries are taken
// a step, their k and v rows issued together and kept raw until their
// math (k_j unpacked once for its dot product and again for dq += ds k_j);
// the 2 kUnrollDqBf dot products of a step are reduced together
// (warp_sums).
__device__ __forceinline__ void drain_dq_bf(const int* lst, int n, DqRowBf& w,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, int lane, int d,
                                            float scale) {
  __syncwarp();
  const int col = 8 * lane;
  const bool on = col < d;
  for (int b = 0; b < n; b += kUnrollDqBf) {
    uint4 ka[kUnrollDqBf], va[kUnrollDqBf];
    issue_rows_bf(lst, b, n, k, v, col, on, d, ka, va);
    float x[2 * kUnrollDqBf];  // s = q_i . k_j and g_i . v_j of each entry
    {
      float oq[8], og[8];
      unpack8(w.q, oq);
      unpack8(w.g, og);
#pragma unroll
      for (int u = 0; u < kUnrollDqBf; ++u) {
        float xk[8], xv[8];
        unpack8(ka[u], xk);
        unpack8(va[u], xv);
        x[2 * u] = dot8(oq, xk, 0.f);
        x[2 * u + 1] = dot8(og, xv, 0.f);
      }
    }
    warp_sums(x, lane);
#pragma unroll
    for (int u = 0; u < kUnrollDqBf; ++u) {
      if (b + u >= n) break;  // warp-uniform
      const float a = expf(x[2 * u] * scale - w.m) / w.den;
      const float ds = round_to<bf16>(a * (x[2 * u + 1] - w.delta) * scale);
      float xk[8];
      unpack8(ka[u], xk);
#pragma unroll
      for (int c = 0; c < 8; ++c) w.dq[c] = fmaf(ds, xk[c], w.dq[c]);
    }
  }
  __syncwarp();
}

// K4 for bf16 q, k, v, g with d % 8 == 0 and d <= 256 (one slice): a warp
// owns kRowsDqBf destination rows of a row tile (scan_rows_bf), with q_i,
// g_i and the row's stats loaded as its walk reaches the row.  The lists
// and the sums are flash_bwd_kernel's, so the bits are its.
template <typename V>
__global__ void __launch_bounds__(kThreads, kMinBlocksDqBf)
flash_dq_bf16_kernel(const V* __restrict__ vals, const int* __restrict__ tile_col,
                     const int* __restrict__ tile_rowptr, const bf16* __restrict__ q,
                     const bf16* __restrict__ g, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ stats,
                     float* __restrict__ dq, int tile, int rows, int rows_g, int d,
                     float scale) {
  __shared__ int lst_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  int* lst = lst_all[threadIdx.x >> 5];
  const int col = 8 * lane;
  const bool on = col < d;
  DqRowBf w;
  // an item of the 2- and 4-byte stores takes 4 and 8 registers where an
  // int8 one takes 2: at 80 registers a second one in flight spills
  scan_rows_bf<kRowsDqBf, sizeof(V) == 1 ? kGroupDqBf : kGroupDqBfWideVals>(
      vals, tile_col, tile_rowptr, tile, rows, rows_g, lst,
      [&](int64_t grow) {
        w.q = load_raw(q + grow * d + col, on);
        w.g = load_raw(g + grow * d + col, on);
        w.m = __ldg(stats + grow * 3);
        w.den = __ldg(stats + grow * 3 + 1);
        w.delta = __ldg(stats + grow * 3 + 2);
#pragma unroll
        for (int c = 0; c < 8; ++c) w.dq[c] = 0.f;
      },
      [&](int n) { drain_dq_bf(lst, n, w, k, v, lane, d, scale); },
      [&](int64_t grow) { store_cols<true, bf16>(dq + grow * d, 0, lane, d, w.dq); });
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
// bf16 features with 16-byte rows take the packed kernel.
template <typename V, typename F, bool VEC, bool WIDE>
struct LaunchFwd {
  static void run(const void* vals, const int* tc, const int* tp, const void* q,
                  const void* k, const void* v, float* num, float* ml, int nr, int tile,
                  int rows, int rows_g, int d, float scale, cudaStream_t stream) {
    if constexpr (sizeof(F) == 2 && VEC) {
      constexpr int kRowsPerBlock = kWarpsPk * kRowsPk;
      const dim3 grid(nr * ((tile + kRowsPerBlock - 1) / kRowsPerBlock), 1,
                      (d + kSlice - 1) / kSlice);
      constexpr int bytes = kWarpsPk * kWarpBytesPk;
      if (bytes > 48 * 1024)
        cudaFuncSetAttribute(flash_fwd_packed_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      flash_fwd_packed_kernel<V><<<grid, kWarpsPk * 32, bytes, stream>>>(
          static_cast<const V*>(vals), tc, tp, static_cast<const bf16*>(q),
          static_cast<const bf16*>(k), static_cast<const bf16*>(v), num, ml, tile, rows,
          rows_g, d, scale);
    } else {
      flash_fwd_kernel<V, F, VEC><<<grid_of(kFwd, nr, tile, d), kThreads, 0, stream>>>(
          static_cast<const V*>(vals), tc, tp, static_cast<const F*>(q),
          static_cast<const F*>(k), static_cast<const F*>(v), num, ml, tile, rows, rows_g, d,
          scale);
    }
  }
};

template <bool DKV>
struct LaunchBwd {
  template <typename V, typename F, bool VEC, bool WIDE>
  struct Of {
    static void run(const void* vals, const int* tc, const int* tp, const void* own_a,
                    const void* own_b, const void* gat_a, const void* gat_b,
                    const float* stats, float* out_a, float* out_b, int nr, int tile,
                    int rows, int rows_g, int d, float scale, cudaStream_t stream) {
      if constexpr (sizeof(F) == 2 && VEC && !WIDE) {
        constexpr int kRowsPerBlock = kWarps * (DKV ? kRowsDkvBf : kRowsDqBf);
        const dim3 grid(nr * ((tile + kRowsPerBlock - 1) / kRowsPerBlock), 1, 1);
        const auto* a = static_cast<const bf16*>(own_a);
        const auto* b = static_cast<const bf16*>(own_b);
        const auto* ga = static_cast<const bf16*>(gat_a);
        const auto* gb = static_cast<const bf16*>(gat_b);
        if constexpr (DKV)
          flash_dkv_bf16_kernel<V><<<grid, kThreads, 0, stream>>>(
              static_cast<const V*>(vals), tc, tp, a, b, ga, gb, stats, out_a, out_b, tile,
              rows, rows_g, d, scale);
        else
          flash_dq_bf16_kernel<V><<<grid, kThreads, 0, stream>>>(
              static_cast<const V*>(vals), tc, tp, a, b, ga, gb, stats, out_a, tile, rows,
              rows_g, d, scale);
      } else {
        flash_bwd_kernel<V, F, VEC, WIDE, DKV>
            <<<grid_of(DKV ? kDkv : kDq, nr, tile, d), kThreads, 0, stream>>>(
                static_cast<const V*>(vals), tc, tp, static_cast<const F*>(own_a),
                static_cast<const F*>(own_b), static_cast<const F*>(gat_a),
                static_cast<const F*>(gat_b), stats, out_a, out_b, tile, rows, rows_g, d,
                scale);
      }
    }
  };
};

template <typename F>
int launch_fwd(const void* vals, int vals_kind, const int* tile_col, const int* tile_rowptr,
               const void* q, const void* k, const void* v, float* num, float* ml,
               int n_rowtiles, int tile, int rows, int rows_g, int d, float scale,
               cudaStream_t stream) {
  dispatch<LaunchFwd, F>(vals_kind, d, vals, tile_col, tile_rowptr, q, k, v, num, ml,
                         n_rowtiles, tile, rows, rows_g, d, scale, stream);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_dq(const void* vals, int vals_kind, const int* tile_col, const int* tile_rowptr,
              const void* q, const void* k, const void* v, const void* g, const float* stats,
              float* out, int n_rowtiles, int tile, int rows, int rows_g, int d, float scale,
              cudaStream_t stream) {
  dispatch<LaunchBwd<false>::Of, F>(vals_kind, d, vals, tile_col, tile_rowptr, q, g, k, v,
                                    stats, out, static_cast<float*>(nullptr), n_rowtiles, tile,
                                    rows, rows_g, d, scale, stream);
  return (int)cudaGetLastError();
}

template <typename F>
int launch_dkv(const void* vals_t, int vals_kind, const int* tile_col_t,
               const int* tile_rowptr_t, const void* q, const void* k, const void* v,
               const void* g, const float* stats, float* dk, float* dv, int n_rowtiles,
               int tile, int rows, int rows_g, int d, float scale, cudaStream_t stream) {
  dispatch<LaunchBwd<true>::Of, F>(vals_kind, d, vals_t, tile_col_t, tile_rowptr_t, k, v, q,
                                   g, stats, dk, dv, n_rowtiles, tile, rows, rows_g, d, scale,
                                   stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched).  The caller guarantees: vals (nt, tile, tile) f32
// (vals_kind 0), int8 (1) or bf16 (2), contiguous and 16-byte aligned;
// tile a multiple of 16; tile_col (nt) and tile_rowptr (n_rowtiles + 1)
// int32; d > 0; every array contiguous, the feature arrays and the outputs
// 16-byte aligned.  Rows: the own arrays (K3 q, num, ml; K4 q, g, stats,
// dq; K5 k, v, dk, dv) have `rows` rows, 0 < rows <= n_rowtiles * tile;
// the gathered arrays (K3 and K4 k, v; K5 q, g, stats) have `rows_g` rows,
// and every tile column reads rows below ceil(rows_g / tile) * tile (a
// column tile partly past rows_g reads zeros there; the wrappers check the
// columns on the CPU and GraphParallel.place checks a partition's).
// q, k, v, g are f32 in the f32 entry points and bf16 in the _bf16 ones;
// stats, num, ml and the gradients are f32.

extern "C" int plnlp_flash_tiles_fwd(const void* vals, int vals_kind, const int* tile_col,
                                     const int* tile_rowptr, const float* q, const float* k,
                                     const float* v, float* num, float* ml, int n_rowtiles,
                                     int tile, int rows, int rows_g, int d, float scale,
                                     cudaStream_t stream) {
  return launch_fwd<float>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, num, ml,
                           n_rowtiles, tile, rows, rows_g, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_fwd_bf16(const void* vals, int vals_kind,
                                          const int* tile_col, const int* tile_rowptr,
                                          const void* q, const void* k, const void* v,
                                          float* num, float* ml, int n_rowtiles, int tile,
                                          int rows, int rows_g, int d, float scale,
                                          cudaStream_t stream) {
  return launch_fwd<bf16>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, num, ml,
                          n_rowtiles, tile, rows, rows_g, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dq(const void* vals, int vals_kind, const int* tile_col,
                                    const int* tile_rowptr, const float* q, const float* k,
                                    const float* v, const float* g, const float* stats,
                                    float* out, int n_rowtiles, int tile, int rows, int rows_g,
                                    int d, float scale, cudaStream_t stream) {
  return launch_dq<float>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, g, stats, out,
                          n_rowtiles, tile, rows, rows_g, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dq_bf16(const void* vals, int vals_kind, const int* tile_col,
                                         const int* tile_rowptr, const void* q, const void* k,
                                         const void* v, const void* g, const float* stats,
                                         float* out, int n_rowtiles, int tile, int rows,
                                         int rows_g, int d, float scale, cudaStream_t stream) {
  return launch_dq<bf16>(vals, vals_kind, tile_col, tile_rowptr, q, k, v, g, stats, out,
                         n_rowtiles, tile, rows, rows_g, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dkv(const void* vals_t, int vals_kind,
                                     const int* tile_col_t, const int* tile_rowptr_t,
                                     const float* q, const float* k, const float* v,
                                     const float* g, const float* stats, float* dk, float* dv,
                                     int n_rowtiles, int tile, int rows, int rows_g, int d,
                                     float scale, cudaStream_t stream) {
  return launch_dkv<float>(vals_t, vals_kind, tile_col_t, tile_rowptr_t, q, k, v, g, stats, dk,
                           dv, n_rowtiles, tile, rows, rows_g, d, scale, stream);
}

extern "C" int plnlp_flash_tiles_dkv_bf16(const void* vals_t, int vals_kind,
                                          const int* tile_col_t, const int* tile_rowptr_t,
                                          const void* q, const void* k, const void* v,
                                          const void* g, const float* stats, float* dk,
                                          float* dv, int n_rowtiles, int tile, int rows,
                                          int rows_g, int d, float scale, cudaStream_t stream) {
  return launch_dkv<bf16>(vals_t, vals_kind, tile_col_t, tile_rowptr_t, q, k, v, g, stats, dk,
                          dv, n_rowtiles, tile, rows, rows_g, d, scale, stream);
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
