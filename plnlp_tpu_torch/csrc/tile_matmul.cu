// Block-sparse dense-tile matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel plnlp_tpu/ops/pallas_tiles.py::_kernel.  Computes
//
//     out[rt*T : (rt+1)*T] = sum over tiles i of row tile rt of
//                            vals[i] @ x[tile_col[i]*T : (tile_col[i]+1)*T]
//
// with vals (nt, T, T) stored as int8 (exact 0/1 or small integer
// adjacencies, negatives included) or f32, tiles sorted by row tile, and the
// tiles of row tile rt at [tile_rowptr[rt], tile_rowptr[rt+1]).  Two
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
constexpr unsigned kFull = 0xffffffffu;

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

// A lane's 8 columns of the slice that starts at c0: with VEC (D % 4 == 0,
// 16-byte aligned rows) two float4 at c0 + 4*lane and c0 + 128 + 4*lane;
// otherwise 8 scalars at c0 + lane + 32*j.  Columns at or past d read 0 and
// are not written.
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

// acc += sum over the list's n entries of val * x[row], in list order.
template <bool VEC>
__device__ __forceinline__ void drain(const int* lst_row, const float* lst_val, int n,
                                      const float* __restrict__ x, int c0, int lane, int d,
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
// flight pay more than deeper unrolling (measured on the H100).
template <typename V, bool VEC>
__global__ void __launch_bounds__(kThreads, 4)
tile_matmul_kernel(const V* __restrict__ vals,
                   const int* __restrict__ tile_col,
                   const int* __restrict__ tile_rowptr,
                   const float* __restrict__ x,
                   float* __restrict__ out,
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

template <typename V>
void launch(const V* vals, const int* tile_col, const int* tile_rowptr, const float* x,
            float* out, int n_rowtiles, int tile, int n_x, int out_rows, int d, bool vec,
            cudaStream_t stream) {
  // the row slices of one row tile are neighbours in launch order, so they
  // run together and share their tiles' x rows in L2
  const dim3 grid((tile + kRowsPerBlock - 1) / kRowsPerBlock, n_rowtiles,
                  (d + kSlice - 1) / kSlice);
  if (vec)
    tile_matmul_kernel<V, true><<<grid, kThreads, 0, stream>>>(
        vals, tile_col, tile_rowptr, x, out, tile, n_x, out_rows, d);
  else
    tile_matmul_kernel<V, false><<<grid, kThreads, 0, stream>>>(
        vals, tile_col, tile_rowptr, x, out, tile, n_x, out_rows, d);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller guarantees: vals (nt, tile, tile) int8 (vals_int8 != 0) or
// f32, contiguous and 16-byte aligned; tile a multiple of 16; tile_col (nt)
// and tile_rowptr (n_rowtiles + 1) int32; x (n_x, d) and out (out_rows, d)
// f32 and contiguous, with vec: d % 4 == 0 and both 16-byte aligned;
// out_rows <= n_rowtiles * tile.
extern "C" int plnlp_tile_matmul_f32(const void* vals, int vals_int8,
                                     const int* tile_col,
                                     const int* tile_rowptr, const float* x,
                                     float* out, int n_rowtiles, int tile,
                                     int n_x, int out_rows, int d, int vec,
                                     cudaStream_t stream) {
  if (vals_int8)
    launch(static_cast<const int8_t*>(vals), tile_col, tile_rowptr, x, out, n_rowtiles,
           tile, n_x, out_rows, d, vec != 0, stream);
  else
    launch(static_cast<const float*>(vals), tile_col, tile_rowptr, x, out, n_rowtiles,
           tile, n_x, out_rows, d, vec != 0, stream);
  return (int)cudaGetLastError();
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
