// Graph Engine linear aggregation: out[i] = sum_j A[i, j] @ h[j].
//
// Replaces: src/repro/kernels/shard_spmm.py::shard_spmm (the Pallas
// kernel with grid (D/B, dst, src) and an (n x B) VMEM accumulator).
//
// Bound on the card: the densified formulation reads every (n x n)
// block once, so it is memory-bound only if the blocks are read at the
// full rate; at Pubmed's shapes it does 2*S^2*n^2*D flops (4.0e11 at
// S=39, n=512, D=500), which float32 FMA outside the tensor cores turns
// into an operations bound (about 6 ms at 67 TFLOP/s). The real edges
// are a tiny fraction of the block entries, so the data-dependent bound
// is the bytes of the blocks.
//
// Design: the TPU's sequential src grid axis becomes a loop inside each
// block. The grid is (ceil(D/64), ceil(n/64), S_dst); a block owns a
// 64x64 (v, d) output tile, keeps it in registers, and streams (64x16)
// slices of A[i, j] and (16x64) slices of h[j] through shared memory for
// every source shard j, skipping slices of A that are all zero. The D
// tiles vary fastest, so the blocks that read the same rows of A run
// together and share them through L2: the 1.59 GB of blocks come from
// device memory about once. The planner's (n, B) are layout only: a
// 512x512 float32 block is 1 MiB and never resides on chip whole. Ragged
// n and D are masked; S_dst != S_src is allowed.
#include "common.cuh"

using namespace gnnk;

__global__ void __launch_bounds__(THREADS)
shard_spmm_kernel(const float* __restrict__ blocks,
                  const float* __restrict__ h, float* __restrict__ out,
                  int s_src, int n, int d) {
  const int d0 = blockIdx.x * TN;
  const int v0 = blockIdx.y * TM;
  const int i = blockIdx.z;
  __shared__ TileSmem s;
  float acc[4][4] = {};
  for (int j = 0; j < s_src; ++j) {
    const float* a = blocks + ((long long)i * s_src + j) * n * n;
    const float* hj = h + (long long)j * n * d;
    gemm_tile(a, n, n, hj, d, d, n, v0, d0, s, acc);
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* o = out + (long long)i * n * d;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int v = v0 + ty + 16 * r;
    if (v >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dd = d0 + tx + 16 * c;
      if (dd < d) o[(long long)v * d + dd] = acc[r][c];
    }
  }
}

extern "C" int shard_spmm_launch(const float* blocks, const float* h,
                                 float* out, int s_dst, int s_src, int n,
                                 int d, cudaStream_t stream) {
  const dim3 grid((d + TN - 1) / TN, (n + TM - 1) / TM, s_dst);
  shard_spmm_kernel<<<grid, THREADS, 0, stream>>>(blocks, h, out, s_src, n,
                                                  d);
  return (int)cudaGetLastError();
}
