// Block-sparse dense-tile matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel plnlp_tpu/ops/pallas_tiles.py::_kernel.  Computes
//
//     out[rt*T : (rt+1)*T] = sum over tiles i of row tile rt of
//                            vals[i] @ x[tile_col[i]*T : (tile_col[i]+1)*T]
//
// with vals (nt, T, T) stored as int8 (exact 0/1 or small integer
// adjacencies) or f32, tiles sorted by row tile, and the tiles of row tile rt
// at [tile_rowptr[rt], tile_rowptr[rt+1]).  Two differences from the TPU
// kernel, both in what the caller sees, neither in the sums: row tiles that
// no tile reaches come out zero (the TPU kernel leaves them undefined and
// its callers mask them with row_mask), and any feature width D is taken
// (the ragged column edge is masked; the TPU path pads D to 128 lanes).
// Rows of x at or past n_x read as zero, so a caller hands x at num_nodes
// rows or at num_nodes rounded up to T alike, with no pad copy.
//
// Design.  The TPU kernel walks the tiles in grid order and carries one f32
// accumulator from tile to tile of a row tile.  CUDA blocks run in no order,
// so here each block OWNS one output sub-tile: a row tile (gridDim.x) times
// a 128-row chunk of it (gridDim.y) times a 128-column slice (gridDim.z).
// The block finds its row tile's tiles through tile_rowptr and loops over
// them and over 16-deep chunks of T: it stages the 128 x 16 chunk of vals
// (cast from int8 to f32 in registers, stored transposed) and the matching
// 16 x 128 chunk of the x tile in shared memory, then each of its 256
// threads accumulates an 8 x 8 register micro-tile with IEEE f32 FMAs on
// the CUDA cores (no TF32, so the kernel holds against its plain version at
// f32 tolerance).  A thread's rows and columns are two groups of 4, 64
// apart, so its 16-byte shared-memory reads hit distinct banks.  The block
// writes its sub-tile once; empty row tiles write zeros.
//
// Bound on the H100 at the collab shape (SBM, N = 235,868, T = 256,
// D = 256, nt = 2,658 tiles over nR = 922 row tiles holding 2.18M edges,
// int8 store).  Bytes: vals once (174 MB) + x once (242 MB) + out once
// (242 MB) + indices, 0.66 GB or 0.20 ms at 3.35 TB/s.  Operations the
// function needs: one multiply-add per edge and column, 2 * 2.18M * D =
// 1.1 GFLOP, 0.017 ms at the 67 TFLOP/s f32 peak.  So the function is bound
// by bytes, at ~0.20 ms.
//
// This design does not approach that bound: it runs the dense tile
// products, 2 * nt * T^2 * D = 89 GFLOP, and the tiles are ~1% full, so
// ~99% of its FMAs multiply zeros and its own floor is 1.33 ms at the f32
// peak.  For that work it keeps the CUDA cores fed from registers (256 FMAs
// per 16 bytes read from shared memory, 64 accumulators per thread).
// Reaching the byte bound means skipping zero chunks or gathering by edge;
// tensor cores (bf16 x or TF32 at a stated tolerance), wgmma and TMA
// staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per block (inside one row tile)
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 16;   // depth of one staged chunk of T
constexpr int kThreads = 256;
constexpr int kHalf = 64;  // a thread's two row (column) groups lie 64 apart

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

template <typename V>
__global__ void __launch_bounds__(kThreads)
tile_matmul_kernel(const V* __restrict__ vals,
                   const int* __restrict__ tile_col,
                   const int* __restrict__ tile_rowptr,
                   const float* __restrict__ x,
                   float* __restrict__ out,
                   int tile, int n_x, int out_rows, int d) {
  __shared__ __align__(16) float As[kBK][kBM];  // vals chunk, [k][row]
  __shared__ __align__(16) float Bs[kBK][kBN];  // x chunk, [k][col]
  const int rt = blockIdx.x;
  const int r0 = blockIdx.y * kBM;
  const int c0 = blockIdx.z * kBN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // 0..15: rows ty*4 + {0..3} and 64 + ty*4 + {0..3}
  const int tx = tid & 15;  // 0..15: columns likewise

  // Staging roles: 8 consecutive k of one vals row; 8 consecutive columns
  // of one x row.
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const int b_k = tid >> 4;
  const int b_col = c0 + (tid & 15) * 8;
  const bool a_ok = r0 + a_row < tile;
  const bool b_vec = (d % 4 == 0) && (b_col + 8 <= d);

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  const int64_t tt = (int64_t)tile * tile;
  const int t_end = tile_rowptr[rt + 1];
  for (int i = tile_rowptr[rt]; i < t_end; ++i) {
    const V* vrow = vals + i * tt + (int64_t)(r0 + a_row) * tile + a_k;
    const int64_t x0 = (int64_t)tile_col[i] * tile + b_k;
    for (int k0 = 0; k0 < tile; k0 += kBK) {
      float a[8], b[8];
      if (a_ok) {
        load8(vrow + k0, a);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = 0.f;
      }
      const int64_t xr = x0 + k0;
      if (xr < n_x && b_vec) {
        load8(x + xr * d + b_col, b);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = (xr < n_x && b_col + j < d) ? __ldg(x + xr * d + b_col + j) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[a_k + j][a_row] = a[j];
      *reinterpret_cast<float4*>(&Bs[b_k][b_col - c0]) = make_float4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<float4*>(&Bs[b_k][b_col - c0 + 4]) = make_float4(b[4], b[5], b[6], b[7]);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][kHalf + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][kHalf + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int r = r0 + (m >> 2) * kHalf + ty * 4 + (m & 3);
    const int64_t grow = (int64_t)rt * tile + r;
    if (r >= tile || grow >= out_rows) continue;
    float* orow = out + grow * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + h * kHalf + tx * 4;
      if (d % 4 == 0 && col + 4 <= d) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            acc[m][h * 4], acc[m][h * 4 + 1], acc[m][h * 4 + 2], acc[m][h * 4 + 3]);
      } else {
#pragma unroll
        for (int n = 0; n < 4; ++n)
          if (col + n < d) orow[col + n] = acc[m][h * 4 + n];
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller guarantees: vals (nt, tile, tile) int8 (vals_int8 != 0) or
// f32, contiguous and 16-byte aligned; tile a multiple of 16; tile_col (nt)
// and tile_rowptr (n_rowtiles + 1) int32; x (n_x, d) and out (out_rows, d)
// f32, contiguous and 16-byte aligned; out_rows <= n_rowtiles * tile.
extern "C" int plnlp_tile_matmul_f32(const void* vals, int vals_int8,
                                     const int* tile_col,
                                     const int* tile_rowptr, const float* x,
                                     float* out, int n_rowtiles, int tile,
                                     int n_x, int out_rows, int d,
                                     cudaStream_t stream) {
  const dim3 grid(n_rowtiles, (tile + kBM - 1) / kBM, (d + kBN - 1) / kBN);
  if (vals_int8) {
    tile_matmul_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(vals), tile_col, tile_rowptr, x, out, tile,
        n_x, out_rows, d);
  } else {
    tile_matmul_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(vals), tile_col, tile_rowptr, x, out, tile,
        n_x, out_rows, d);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
