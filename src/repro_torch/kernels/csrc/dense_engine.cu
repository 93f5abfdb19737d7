// Dense Engine: out = act(x @ w + b), float32.
//
// Replaces: src/repro/kernels/dense_engine.py::dense_engine_matmul (the
// Pallas kernel with (bm, bn, bk) tiles, an f32 VMEM accumulator and
// bias + activation on the last K step).
//
// Bound on the card: at the model's shapes (M = S*n rows, K = 500 or
// 1000, N = 500 or 16) the product is 2*M*N*K flops in float32 FMA,
// outside the tensor cores; for N = 16 the bytes of x dominate instead.
//
// Design: a tiled SGEMM. Grid (ceil(M/64), ceil(N/64)); each block keeps
// a 64x64 output tile in registers and streams 16-deep K slices of x and
// w through shared memory (every slice, no zero skipping, so Inf and NaN
// propagate as in the plain product). Ragged M, N and K are masked, with no
// padding. The epilogue adds the bias and applies none / relu /
// gelu (tanh) / silu before the one store.
#include "common.cuh"

using namespace gnnk;

__global__ void __launch_bounds__(THREADS)
dense_engine_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int m, int n, int k, int act) {
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  __shared__ TileSmem s;
  float acc[4][4] = {};
  gemm_tile<false>(x, k, m, w, n, n, k, m0, n0, s, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = m0 + ty + 16 * r;
    if (row >= m) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = n0 + tx + 16 * c;
      if (col >= n) continue;
      float y = acc[r][c];
      if (b != nullptr) y += b[col];
      out[(long long)row * n + col] = activate(y, act);
    }
  }
}

extern "C" int dense_engine_launch(const float* x, const float* w,
                                   const float* b, float* out, int m, int n,
                                   int k, int act, cudaStream_t stream) {
  const dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN);
  dense_engine_kernel<<<grid, THREADS, 0, stream>>>(x, w, b, out, m, n, k,
                                                    act);
  return (int)cudaGetLastError();
}
