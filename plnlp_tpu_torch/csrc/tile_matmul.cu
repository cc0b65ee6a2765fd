// Block-sparse dense-tile matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel plnlp_tpu/ops/pallas_tiles.py::_kernel.  Computes
//
//     out[rt*T : (rt+1)*T] = sum over tiles i of row tile rt of
//                            vals[i] @ x[tile_col[i]*T : (tile_col[i]+1)*T]
//
// with vals (nt, T, T) stored as int8 (exact 0/1 or small integer
// adjacencies, negatives included), f32 or bf16, tiles sorted by row tile,
// and the tiles of row tile rt at [tile_rowptr[rt], tile_rowptr[rt+1]); x
// and out are f32 (plnlp_tile_matmul_f32) or bf16 (plnlp_tile_matmul_bf16).
// As the TPU kernel does, vals is cast to x's dtype before the product (f32
// vals with bf16 x are rounded to bf16 first), the products are summed in
// f32, and each output element is rounded to x's dtype once.  Two
// differences from the TPU kernel, both in what the caller sees, neither in
// the sums: row tiles that no tile reaches come out zero (the TPU kernel
// leaves them undefined and its callers mask them with row_mask), and any
// feature width D is taken (the TPU path pads D to 128 lanes).  Rows of x at
// or past n_x read as zero, so a caller hands x at num_nodes rows or at
// num_nodes rounded up to T alike, with no pad copy.
//
// Design: compact the nonzeros, gather only their rows.  The TPU kernel runs
// each tile as a dense (T x T) @ (T x D) product on the MXU.  The tiles the
// hybrid operand builds are ~1% full, so on this card a dense product
// multiplies ~99% zeros.  Here one block owns (64 rows of a row tile, the
// row tile, a 256-column slice of D: gridDim x, y, z); each of its 8 warps
// owns 8 rows and keeps one row's full-width sum in registers (8 floats a
// lane).  For a row, the warp
// walks its row tile's tiles through tile_rowptr and reads the row of each
// tile once, 256 columns at a time (8 bytes a lane for int8, 32 for f32;
// kGroup tiles' rows in flight).  Each lane counts the nonzeros among its 8
// values, a warp prefix sum gives every nonzero its place, and the
// (x row, value) pairs land in a per-warp list in shared memory in column
// order.  The warp then walks the list kUnroll entries at a time: every lane
// gathers its columns of those x rows (two 16-byte loads when D % 4 == 0)
// and adds value * row into the registers.  A row is owned by one warp, so
// there are no atomics and the result is the same on every launch.  A full
// tile (the card tests use 100%-dense vals) fills the list 256 entries per
// chunk; the list holds kCap and is drained before it can overflow.
//
// Non-finite x: a zero of vals is skipped, never multiplied, so an inf or
// NaN in a row of x that a tile holds only as zeros does not reach the
// output (the dense product, and the plain version's bmm, would turn
// 0 * inf into NaN).  No path of the port feeds non-finite x.
//
// Bound on the H100 at the collab shape (SBM, N = 235,868, T = 256,
// D = 256, nt = 2,658 tiles over nR = 922 row tiles holding 2.18M edges,
// int8 store).  Bytes: vals once (174 MB) + x once (242 MB) + out once
// (242 MB) + indices, 0.66 GB or 0.20 ms at 3.35 TB/s.  Operations: one
// multiply-add per nonzero and column, 2 * 2.18M * D = 1.1 GFLOP, 0.017 ms
// at the 67 TFLOP/s f32 peak.  So the function is bound by bytes, at
// ~0.20 ms.  This design reads vals and writes out once and does only the
// nonzeros' work; what it adds to the bound is the row gather, nnz * D * 4
// bytes (2.2 GB there, 0.67 ms from HBM).  The tiles' locality keeps much
// of it in L2: a row tile's tiles share column tiles, the four row slices
// of a row tile are neighbours in launch order, and with the label-prop
// order neighbouring row tiles share column tiles too.

//
// In bf16 (x and out 2 bytes an element, int8 tiles) the bytes at the same
// shape are vals 174 MB + x 121 MB + out 121 MB + indices, 0.42 GB or
// 0.12 ms; the row gather halves to nnz * D * 2 bytes (1.1 GB).  A lane's
// 8 columns are then one 16-byte load (columns c0 + 8*lane .. +7).
//
// bf16 x with 16-byte rows (d % 8 == 0) runs a kernel of its own,
// tile_matmul_bf16_kernel.  The design above spends most of its bf16 time
// in the scan, not in the gathers: split on the H100 (chip_sweep_tiles.py,
// one H100 80GB HBM3 at 700.00 W, the SBM shape, int8 tiles), the scan and
// the list alone took 0.242 ms of its 0.421, the scan and the list walked
// with no gather 0.276.  Each group of items waited for its own loads, the
// next row's scan waited for the row before, and every value was converted
// to float to be tested.  The bf16 kernel keeps one warp a row and each
// row's list and sums, so the bits are the design above's (its blocks hold
// 8 warps of kRowsBf rows), and changes what is in flight and what each
// item costs:
// - a warp walks its kRowsBf rows' tile rows as one stream of items (the
//   row of one tile, kChunk columns); a cursor loads the next kGroupBf
//   items (vals and tile_col) before the scan tests the current ones,
//   across rows, so the next row's first loads are in flight while a row
//   drains; the cursors count rows, tiles and chunks, with no division;
// - the scan tests the values as loaded (an int8 byte; a bf16 half with its
//   sign masked off, so -0 is zero; f32 rounded to bf16 first) and converts
//   only the nonzeros;
// - the drain keeps kDepthBf x rows in flight, each raw (16 bytes) until
//   its products, entry e's row issued kDepthBf entries ahead of them.
// 63 registers of the 64 that 4 blocks of 8 warps an SM allow (the f32
// tile store's instantiation spills 24 bytes), 32 KB of shared memory a
// block (the lists).  Measured there: 0.306 ms on int8 tiles and 0.321 on
// bf16 tiles against 0.417 and 0.436 for the design above in the same run;
// its scan alone 0.173, with the list walked and no gather 0.218.  Tried
// and lost, with the same bits: 2 or 4 items a group (spills; 0.30-0.76
// ms), 5, 6 or 8 x rows in flight (spills; bf16 tiles 0.32-0.58), 2 or 8
// rows a warp (0.318, 0.315), 3 blocks an SM (0.34).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // 64
constexpr int kChunk = 256;   // vals columns scanned at a time: 8 a lane
constexpr int kSlice = 256;   // output columns per block: 8 a lane
constexpr int kGroup = 2;     // vals rows in flight
constexpr int kUnroll = 2;    // x rows in flight
constexpr int kCap = 2 * kChunk;  // list entries per warp
// bf16 x with 16-byte rows (tile_matmul_bf16_kernel; set by timing on the
// H100: chip_sweep_tiles.py)
constexpr int kRowsBf = 4;      // rows a warp, one after another
constexpr int kGroupBf = 1;     // tile-row items loaded a group ahead
constexpr int kDepthBf = 4;     // x rows in flight
constexpr int kMinBlocksBf = 4; // blocks an SM
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// the 8 bf16 packed in 4 words, low half first
__device__ __forceinline__ void unpack8(const uint4 raw, float (&v)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// 8 consecutive tile values at p (16-byte aligned for f32 and bf16, 8 for int8)
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

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const bf16* p) {
  return __uint_as_float((unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16(v); }

// W contiguous values of x at p (16-byte aligned) into v[off .. off+W),
// and out back: W = 16 bytes of the element type (4 f32, 8 bf16)
__device__ __forceinline__ void load_run(const float* p, float (&v)[8], int off) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[off] = a.x; v[off + 1] = a.y; v[off + 2] = a.z; v[off + 3] = a.w;
}
__device__ __forceinline__ void load_run(const bf16* p, float (&v)[8], int) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}
__device__ __forceinline__ void store_run(float* p, const float (&v)[8], int off) {
  *reinterpret_cast<float4*>(p) = make_float4(v[off], v[off + 1], v[off + 2], v[off + 3]);
}
__device__ __forceinline__ void store_run(bf16* p, const float (&v)[8], int) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * k])) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1])) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane's 8 columns of the slice that starts at c0.  With VEC (d a
// multiple of W, 16-byte aligned rows) runs of W = 16 / sizeof(T) columns:
// value j is column c0 + 32*W*(j/W) + W*lane + j%W; otherwise column
// c0 + lane + 32*j.  Columns at or past d read 0 and are not written.
template <bool VEC, typename T>
__device__ __forceinline__ void load_cols(const T* row, int c0, int lane, int d,
                                          float (&v)[8]) {
  constexpr int W = 16 / sizeof(T);
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

template <bool VEC, typename T>
__device__ __forceinline__ void store_cols(T* row, int c0, int lane, int d,
                                           const float (&v)[8]) {
  constexpr int W = 16 / sizeof(T);
  if (VEC) {
#pragma unroll
    for (int h = 0; h < 8 / W; ++h) {
      const int c = c0 + 32 * W * h + W * lane;
      if (c < d) store_run(row + c, v, W * h);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) store1(row + c, v[j]);
    }
  }
}

// acc += sum over the list's n entries of val * x[row], in list order.
template <bool VEC, typename T>
__device__ __forceinline__ void drain(const int* lst_row, const float* lst_val, int n,
                                      const T* __restrict__ x, int c0, int lane, int d,
                                      float (&acc)[8]) {
  __syncwarp();
  for (int b = 0; b < n; b += kUnroll) {
    float g[kUnroll][8];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = 0.f;
      if (b + u < n) {
        w[u] = lst_val[b + u];
        load_cols<VEC>(x + (int64_t)lst_row[b + u] * d, c0, lane, d, g[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b + u >= n) break;  // warp-uniform
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(w[u], g[u][c], acc[c]);
    }
  }
  __syncwarp();
}

// At most 64 registers a thread (4 blocks, 32 warps an SM): more warps in
// flight pay more than deeper unrolling (measured on the H100).  V is the
// tile store's type, T that of x and out.
template <typename V, typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
tile_matmul_kernel(const V* __restrict__ vals,
                   const int* __restrict__ tile_col,
                   const int* __restrict__ tile_rowptr,
                   const T* __restrict__ x,
                   T* __restrict__ out,
                   int tile, int n_x, int out_rows, int d) {
  __shared__ int lst_row_all[kWarps][kCap];
  __shared__ float lst_val_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* lst_row = lst_row_all[warp];
  float* lst_val = lst_val_all[warp];
  const int rt = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int t_begin = __ldg(tile_rowptr + rt);
  const int n_chunks = (tile + kChunk - 1) / kChunk;
  const int n_items = (__ldg(tile_rowptr + rt + 1) - t_begin) * n_chunks;
  const int64_t tt = (int64_t)tile * tile;

  for (int k = 0; k < kRowsPerWarp; ++k) {
    // the block's warps take neighbouring rows, so their vals rows are adjacent
    const int r = blockIdx.x * kRowsPerBlock + k * kWarps + warp;
    const int64_t grow = (int64_t)rt * tile + r;
    if (r >= tile || grow >= out_rows) break;  // warp-uniform
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    int n = 0;  // list entries
    for (int q0 = 0; q0 < n_items; q0 += kGroup) {
      float v[kGroup][8];
      int xcol[kGroup];  // x row of the lane's first column, per item
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int q = q0 + g;
        const int i = t_begin + q / n_chunks;
        const int col = (q % n_chunks) * kChunk + 8 * lane;
        xcol[g] = 0;
        if (q < n_items && col < tile) {
          load8(vals + i * tt + (int64_t)r * tile + col, v[g]);
          xcol[g] = __ldg(tile_col + i) * tile + col;
          if constexpr (sizeof(T) == 2 && sizeof(V) == 4) {
            // vals.astype(x.dtype): f32 values rounded to bf16 first
#pragma unroll
            for (int j = 0; j < 8; ++j) v[g][j] = __bfloat162float(__float2bfloat16(v[g][j]));
          }
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
          if (v[g][j] != 0.f && xcol[g] + j < n_x) nz |= 1u << j;
        const int cnt = __popc(nz);
        int incl = cnt;  // inclusive prefix sum over lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        if (n + total > kCap) {
          drain<VEC>(lst_row, lst_val, n, x, c0, lane, d, acc);
          n = 0;
        }
        int pos = n + incl - cnt;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (nz >> j & 1u) {
            lst_row[pos] = xcol[g] + j;
            lst_val[pos] = v[g][j];
            ++pos;
          }
        }
        n += total;
      }
    }
    drain<VEC>(lst_row, lst_val, n, x, c0, lane, d, acc);
    store_cols<VEC>(out + grow * d, c0, lane, d, acc);
  }
}

// ---------------------------------------------------------------------------
// bf16 x with 16-byte rows: the gathers kept raw and in flight
// ---------------------------------------------------------------------------

// Eight values of a tile row as loaded (int8, bf16 or f32).  nonzero()
// tests them as the product takes them (vals.astype(bfloat16): f32 values
// rounded first) without converting int8 or bf16 values, and at(b) converts
// value b, which the scan calls for the nonzeros alone.
template <typename V>
struct Raw8;
template <>
struct Raw8<int8_t> {
  unsigned long long r;
  __device__ __forceinline__ void load(const int8_t* p) {
    r = __ldg(reinterpret_cast<const unsigned long long*>(p));
  }
  __device__ __forceinline__ unsigned nonzero() const {
    unsigned nz = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) nz |= (r >> (8 * b) & 0xffu) ? 1u << b : 0u;
    return nz;
  }
  __device__ __forceinline__ float at(int b) const {
    return static_cast<float>(static_cast<int8_t>(r >> (8 * b)));
  }
};
template <>
struct Raw8<bf16> {
  uint4 r;
  __device__ __forceinline__ void load(const bf16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ unsigned nonzero() const {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
    unsigned nz = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b)  // -0 is zero
      nz |= (w[b / 2] >> (16 * (b & 1)) & 0x7fffu) ? 1u << b : 0u;
    return nz;
  }
  __device__ __forceinline__ float at(int b) const {
    const unsigned long long h = b < 4 ? (unsigned long long)r.y << 32 | r.x
                                       : (unsigned long long)r.w << 32 | r.z;
    return __uint_as_float((unsigned)(h >> (16 * (b & 3))) << 16);
  }
};
template <>
struct Raw8<float> {
  float v[8];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ unsigned nonzero() const {
    unsigned nz = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) nz |= at(b) != 0.f ? 1u << b : 0u;
    return nz;
  }
  __device__ __forceinline__ float at(int b) const {
    return __bfloat162float(__float2bfloat16(v[b]));
  }
};

// 16 bytes of bf16 at `p` if `on`, else zeros.
__device__ __forceinline__ uint4 load_raw(const bf16* p, bool on) {
  return on ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
}

// acc += sum over the list's n entries of val * x[row], in list order, as
// drain does; the lane's 8 columns start at col (16 bytes, loaded if on).
// kDepthBf x rows are in flight, each kept raw until its turn: entry e's
// row is issued kDepthBf entries ahead of its products.
__device__ __forceinline__ void drain_bf16(const int* lst_row, const float* lst_val, int n,
                                           const bf16* __restrict__ x, int col, bool on,
                                           int d, float (&acc)[8]) {
  __syncwarp();
  uint4 g[kDepthBf];
#pragma unroll
  for (int u = 0; u < kDepthBf; ++u)
    g[u] = load_raw(x + (int64_t)(u < n ? lst_row[u] : 0) * d + col, on && u < n);
  for (int b = 0; b < n; b += kDepthBf) {
#pragma unroll
    for (int u = 0; u < kDepthBf; ++u) {
      const int e = b + u;
      if (e >= n) break;  // warp-uniform
      const float w = lst_val[e];
      float xv[8];
      unpack8(g[u], xv);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = fmaf(w, xv[c], acc[c]);
      const int e2 = e + kDepthBf;
      if (e2 < n) g[u] = load_raw(x + (int64_t)lst_row[e2] * d + col, on);
    }
  }
  __syncwarp();
}

// K2 for bf16 x with d % 8 == 0.  The warps, their rows (row k of a warp
// is r0 + k kWarps) and each row's list and sums are tile_matmul_kernel's,
// so the bits are its (kRowsBf rows a warp).  What differs is the work in
// flight: a warp walks the tile rows of its rows as one stream of items
// (kChunk columns of one tile's row), a cursor loading kGroupBf items a
// group ahead of the one the scan tests, across the rows, so the next
// row's first vals and tile_col loads are in flight while a row drains;
// the scan tests the values without converting them and converts only
// the nonzeros; the drain keeps kDepthBf x rows in flight (drain_bf16).
template <typename V>
__global__ void __launch_bounds__(kThreads, kMinBlocksBf)
tile_matmul_bf16_kernel(const V* __restrict__ vals,
                        const int* __restrict__ tile_col,
                        const int* __restrict__ tile_rowptr,
                        const bf16* __restrict__ x,
                        bf16* __restrict__ out,
                        int tile, int n_x, int out_rows, int d) {
  __shared__ int lst_row_all[kWarps][kCap];
  __shared__ float lst_val_all[kWarps][kCap];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* lst_row = lst_row_all[warp];
  float* lst_val = lst_val_all[warp];
  const int rt = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int t_begin = __ldg(tile_rowptr + rt), t_end = __ldg(tile_rowptr + rt + 1);
  const int n_chunks = (tile + kChunk - 1) / kChunk;
  const int r0 = blockIdx.x * (kWarps * kRowsBf) + warp;
  int n_rows = 0;
#pragma unroll
  for (int k = 0; k < kRowsBf; ++k) {
    const int r = r0 + k * kWarps;
    if (r < tile && (int64_t)rt * tile + r < out_rows) n_rows = k + 1;
  }
  if (n_rows == 0) return;  // warp-uniform
  const int col = c0 + 8 * lane;
  const bool on = col < d;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  auto put_row = [&](int k) {
    store_cols<true>(out + ((int64_t)rt * tile + r0 + k * kWarps) * d, c0, lane, d, acc);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  };
  if (t_end == t_begin) {  // no tile: every row is zero
    for (int k = 0; k < n_rows; ++k) put_row(k);
    return;
  }

  // the load cursor: row lk, tile ik, chunk ck (lk == n_rows: past the end)
  int lk = 0, ik = t_begin, ck = 0;
  const V* vrow = vals + (int64_t)t_begin * tile * tile + (int64_t)r0 * tile + 8 * lane;
  auto load_item = [&](Raw8<V>& item, int& tc) {
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
  Raw8<V> cur[kGroupBf], nxt[kGroupBf];
  int tc_cur[kGroupBf], tc_nxt[kGroupBf];  // the item's tile column, -1 past the tile
#pragma unroll
  for (int j = 0; j < kGroupBf; ++j) load_item(cur[j], tc_cur[j]);
  // the scan's cursor: row lr, chunk ch, tile ir
  int lr = 0, ch = 0, ir = t_begin;
  int n = 0;  // list entries
  while (lr < n_rows) {
#pragma unroll
    for (int j = 0; j < kGroupBf; ++j) load_item(nxt[j], tc_nxt[j]);
#pragma unroll
    for (int j = 0; j < kGroupBf; ++j) {
      if (lr == n_rows) break;  // warp-uniform
      const int xcol = tc_cur[j] * tile + ch * kChunk + 8 * lane;
      unsigned nz = tc_cur[j] >= 0 ? cur[j].nonzero() : 0u;
      if (xcol + 8 > n_x) nz &= n_x > xcol ? (1u << (n_x - xcol)) - 1u : 0u;
      const int cnt = __popc(nz);
      int incl = cnt;  // inclusive prefix sum over lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const int total_j = __shfl_sync(kFull, incl, 31);
      if (n + total_j > kCap) {
        drain_bf16(lst_row, lst_val, n, x, col, on, d, acc);
        n = 0;
      }
      int pos = n + incl - cnt;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (nz >> b & 1u) {
          lst_row[pos] = xcol + b;
          lst_val[pos] = cur[j].at(b);
          ++pos;
        }
      }
      n += total_j;
      if (++ch == n_chunks) {
        ch = 0;
        if (++ir == t_end) {  // the row is whole
          ir = t_begin;
          drain_bf16(lst_row, lst_val, n, x, col, on, d, acc);
          put_row(lr);
          n = 0;
          ++lr;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kGroupBf; ++j) {
      cur[j] = nxt[j];
      tc_cur[j] = tc_nxt[j];
    }
  }
}

template <typename V, typename T>
void launch(const V* vals, const int* tile_col, const int* tile_rowptr, const T* x, T* out,
            int n_rowtiles, int tile, int n_x, int out_rows, int d, bool vec,
            cudaStream_t stream) {
  // the row slices of one row tile are neighbours in launch order, so they
  // run together and share their tiles' x rows in L2
  const dim3 grid((tile + kRowsPerBlock - 1) / kRowsPerBlock, n_rowtiles,
                  (d + kSlice - 1) / kSlice);
  if (vec) {
    if constexpr (sizeof(T) == 2)
      tile_matmul_bf16_kernel<V>
          <<<dim3((tile + kWarps * kRowsBf - 1) / (kWarps * kRowsBf), n_rowtiles, grid.z),
             kThreads, 0, stream>>>(vals, tile_col, tile_rowptr, x, out, tile, n_x, out_rows, d);
    else
      tile_matmul_kernel<V, T, true><<<grid, kThreads, 0, stream>>>(
          vals, tile_col, tile_rowptr, x, out, tile, n_x, out_rows, d);
  } else {
    tile_matmul_kernel<V, T, false><<<grid, kThreads, 0, stream>>>(
        vals, tile_col, tile_rowptr, x, out, tile, n_x, out_rows, d);
  }
}

// vals_kind: 0 float32, 1 int8, 2 bfloat16
template <typename T>
int launch_any(const void* vals, int vals_kind, const int* tile_col, const int* tile_rowptr,
               const void* x, void* out, int n_rowtiles, int tile, int n_x, int out_rows,
               int d, int vec, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vals_kind == 1)
    launch(static_cast<const int8_t*>(vals), tile_col, tile_rowptr, xt, ot, n_rowtiles, tile,
           n_x, out_rows, d, vec != 0, stream);
  else if (vals_kind == 2)
    launch(static_cast<const bf16*>(vals), tile_col, tile_rowptr, xt, ot, n_rowtiles, tile,
           n_x, out_rows, d, vec != 0, stream);
  else
    launch(static_cast<const float*>(vals), tile_col, tile_rowptr, xt, ot, n_rowtiles, tile,
           n_x, out_rows, d, vec != 0, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller guarantees: vals (nt, tile, tile) of vals_kind (0 float32,
// 1 int8, 2 bfloat16), contiguous and 16-byte aligned; tile a multiple of
// 16; tile_col (nt) and tile_rowptr (n_rowtiles + 1) int32; x (n_x, d) and
// out (out_rows, d) contiguous, float32 (_f32) or bfloat16 (_bf16), with
// vec: d a multiple of 16 bytes' worth of elements (4 f32, 8 bf16) and both
// 16-byte aligned; out_rows <= n_rowtiles * tile.
extern "C" int plnlp_tile_matmul_f32(const void* vals, int vals_kind, const int* tile_col,
                                     const int* tile_rowptr, const void* x, void* out,
                                     int n_rowtiles, int tile, int n_x, int out_rows, int d,
                                     int vec, cudaStream_t stream) {
  return launch_any<float>(vals, vals_kind, tile_col, tile_rowptr, x, out, n_rowtiles, tile,
                           n_x, out_rows, d, vec, stream);
}

extern "C" int plnlp_tile_matmul_bf16(const void* vals, int vals_kind, const int* tile_col,
                                      const int* tile_rowptr, const void* x, void* out,
                                      int n_rowtiles, int tile, int n_x, int out_rows, int d,
                                      int vec, cudaStream_t stream) {
  return launch_any<bf16>(vals, vals_kind, tile_col, tile_rowptr, x, out, n_rowtiles, tile,
                          n_x, out_rows, d, vec, stream);
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
