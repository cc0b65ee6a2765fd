// Blocked-CSR weighted scatter-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel plnlp_tpu/ops/pallas_spmm.py::_kernel.  Computes
//
//     out[rb*R + blk_local[e]] += blk_weight[e] * x[blk_src[e]]
//
// over every edge slot e of every sub-block of row-block rb, with rows of a
// row-block that no edge reaches written as zero.  Sub-blocks of row-block
// rb are [blk_rowptr[rb], blk_rowptr[rb+1]); each holds B edge slots, and
// slots with weight 0 are padding.
//
// Design.  The TPU kernel walks sub-blocks in grid order and carries one
// f32 accumulator from step to step.  CUDA blocks run in no order, so here
// each block OWNS one output tile: row-block rb (gridDim.x) times a 64-wide
// column slice (gridDim.y).  The block zero-fills an R x 64 f32 accumulator
// in dynamic shared memory (128 KB at R = 512), lets its warps stride over
// the row-block's edge slots 32 at a time, and writes its rows once.  The
// gather x[blk_src] is fused: a warp reads each source row's 64-column
// slice straight from device memory (two coalesced 128-byte loads), so the
// E x D gathered buffer the JAX path materializes never exists.  Edges of
// a row-block are sorted by destination, so a warp keeps a running row sum
// in registers and issues shared-memory atomics only when the destination
// row changes.  The one-hot matmul of the TPU kernel is MXU layout, not
// semantics, and is not carried over.
//
// Bound on the H100.  Compulsory traffic is x and out once each plus the
// metadata (12 bytes a slot): about 0.5 GB at the collab shape (N = 235,868,
// D = 256), 0.15 ms at 3.35 TB/s.  Without reuse, each real edge re-reads a
// source row slice, E * D * 4 bytes (about 2.3 GB there); L2 (50 MB) holds
// the hot rows of a power-law graph, so the true cost falls between.  The
// f32 adds (2 E D) are far below the FP32 peak.
//
// Known weak spot: a power-law hub row-block holds a large share of all
// edges and runs on gridDim.y blocks only, so it serializes; splitting hub
// row-blocks (with a second reduction pass), cp.async/TMA staging of the
// gathered rows and bf16 inputs are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 64;                 // output columns per block
constexpr int kThreads = 1024;            // 32 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                // source rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;

// One block per SM at R = 512 (128 KB of shared memory), so let each
// thread use up to 64 registers.
__global__ void __launch_bounds__(kThreads, 1)
scatter_matmul_kernel(const float* __restrict__ x,
                      const int* __restrict__ blk_src,
                      const int* __restrict__ blk_local,
                      const float* __restrict__ blk_weight,
                      const int* __restrict__ blk_rowptr,
                      float* __restrict__ out,
                      int out_rows, int block_rows, int block_edges, int d) {
  extern __shared__ float acc[];  // [block_rows][kCols]
  const int rb = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < block_rows * kCols; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int col_a = c0 + lane;
  const int col_b = c0 + lane + 32;
  const bool ok_a = col_a < d;
  const bool ok_b = col_b < d;
  const int64_t e_begin = (int64_t)blk_rowptr[rb] * block_edges;
  const int64_t e_end = (int64_t)blk_rowptr[rb + 1] * block_edges;

  // Running sum of the current destination row (warp-uniform row index).
  int cur_row = -1;
  float sum_a = 0.f, sum_b = 0.f;

  for (int64_t base = e_begin + (int64_t)warp * 32; base < e_end;
       base += (int64_t)kWarps * 32) {
    const int64_t e = base + lane;
    int src = 0, loc = 0;
    float w = 0.f;
    if (e < e_end) {
      src = blk_src[e];
      loc = blk_local[e];
      w = blk_weight[e];
    }
    unsigned live = __ballot_sync(kFull, w != 0.f);
    while (live) {
      int slot[kUnroll];
      float va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        slot[u] = live ? __ffs(live) - 1 : -1;
        live &= live ? live - 1 : 0u;
      }
      // Issue every load of this batch before the first add.
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = slot[u] < 0 ? 0 : slot[u];
        const int s = __shfl_sync(kFull, src, j);
        const float ww = __shfl_sync(kFull, w, j);
        const float* row = x + (int64_t)s * d;
        va[u] = (slot[u] >= 0 && ok_a) ? __ldg(row + col_a) * ww : 0.f;
        vb[u] = (slot[u] >= 0 && ok_b) ? __ldg(row + col_b) * ww : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (slot[u] < 0) break;  // warp-uniform
        const int r = __shfl_sync(kFull, loc, slot[u]);
        if (r != cur_row) {
          if (cur_row >= 0) {
            atomicAdd(&acc[cur_row * kCols + lane], sum_a);
            atomicAdd(&acc[cur_row * kCols + lane + 32], sum_b);
          }
          cur_row = r;
          sum_a = 0.f;
          sum_b = 0.f;
        }
        sum_a += va[u];
        sum_b += vb[u];
      }
    }
  }
  if (cur_row >= 0) {
    atomicAdd(&acc[cur_row * kCols + lane], sum_a);
    atomicAdd(&acc[cur_row * kCols + lane + 32], sum_b);
  }
  __syncthreads();

  const int row0 = rb * block_rows;
  const int nrows = min(block_rows, out_rows - row0);
  for (int i = threadIdx.x; i < nrows * kCols; i += kThreads) {
    const int r = i / kCols;
    const int c = c0 + i % kCols;
    if (c < d) out[(int64_t)(row0 + r) * d + c] = acc[i];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller guarantees shapes: x (n_src, d), blk_* (nblk, block_edges),
// blk_rowptr (n_rowblocks + 1) with n_rowblocks = ceil(out_rows /
// block_rows), out (out_rows, d), all contiguous.
extern "C" int plnlp_scatter_matmul_f32(const float* x, const int* blk_src,
                                        const int* blk_local,
                                        const float* blk_weight,
                                        const int* blk_rowptr, float* out,
                                        int n_rowblocks, int out_rows,
                                        int block_rows, int block_edges, int d,
                                        cudaStream_t stream) {
  const size_t smem = (size_t)block_rows * kCols * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scatter_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_rowblocks, (d + kCols - 1) / kCols);
  scatter_matmul_kernel<<<grid, kThreads, smem, stream>>>(
      x, blk_src, blk_local, blk_weight, blk_rowptr, out, out_rows, block_rows,
      block_edges, d);
  return (int)cudaGetLastError();
}

extern "C" const char* plnlp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
