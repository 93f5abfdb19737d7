// The activation every GNN kernel's epilogue applies, and shard_spmm's
// CUDA-core tile machinery (float32, sm_90a).
//
// One 64x64 output tile per 256-thread block; each thread owns a 4x4
// sub-tile at rows ty + 16*i and columns tx + 16*j, so shared-memory
// reads are broadcasts or conflict-free and global stores coalesce.
// Operands stream through shared memory in 16-deep K slices. Every load
// is bounds-masked, so ragged M, N and K need no padding. Sums use
// plain FMA in float32 (no TF32), matching the float32 reference.
#pragma once

#include <cuda_runtime.h>

namespace gnnk {

constexpr int TM = 64;        // output tile rows
constexpr int TN = 64;        // output tile columns
constexpr int TK = 16;        // contraction slice
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 outputs each

enum Activation : int { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

struct TileSmem {
  float a[TK][TM + 4];  // A slice, transposed: a[k][m]
  float b[TK][TN];      // B slice: b[k][n]
};

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(x, 0.f);
    case kGelu: {  // tanh approximation, as jax.nn.gelu
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case kSilu:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

// This thread's four values of the (64 x 16) A slice that starts at
// column k0: row m0 + t/4, columns k0 + 4*(t%4) .. +3, zero outside
// M x K.
__device__ __forceinline__ void load_a_slice(
    const float* __restrict__ A, long long lda, int M, int K, int m0, int k0,
    float a[4]) {
  const int row = m0 + threadIdx.x / 4;
  const int col = k0 + (threadIdx.x % 4) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    a[q] = (row < M && col + q < K) ? A[row * lda + col + q] : 0.f;
}

__device__ __forceinline__ void store_a_slice(TileSmem& s, const float a[4]) {
  const int row = threadIdx.x / 4, col = (threadIdx.x % 4) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) s.a[col + q][row] = a[q];
}

// One K slice whose A part is already stored in s.a: bring the (16 x 64)
// B slice at row k0 into shared memory and accumulate
// acc[i][j] += sum_k s.a[k][ty + 16i] * B[k0 + k][n0 + tx + 16j].
// Barriers before the reads and after them, so the caller may rewrite
// shared memory right after.
__device__ __forceinline__ void slice_fma(
    const float* __restrict__ B, long long ldb, int N, int K, int n0,
    int k0, TileSmem& s, float acc[4][4]) {
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int bk = k0 + t / 16, b_col = (t % 16) * 4;  // 16 k x 64 cols
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + b_col + q;
    s.b[t / 16][b_col + q] = (bk < K && n < N) ? B[bk * ldb + n] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = s.a[k][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = s.b[k][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
  __syncthreads();
}

// acc[i][j] += sum_{k < K} A[m0 + ty + 16i][k] * B[k][n0 + tx + 16j]
// A is row-major with leading dimension lda and M valid rows; B is
// row-major with leading dimension ldb and N valid columns. The next
// slice of A is loaded into registers while the current one is used.
// A is a densified adjacency (shard_spmm), almost all zero: a K slice
// whose A part is all zero is skipped after one block-wide vote, before
// its B slice is read. This equals the full product only for finite B,
// since a skipped 0 * Inf or 0 * NaN term would have made the sum NaN.
// Ends with a barrier, so the caller may reuse shared memory right
// after.
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ A, long long lda, int M,
    const float* __restrict__ B, long long ldb, int N, int K,
    int m0, int n0, TileSmem& s, float acc[4][4]) {
  float a[4];
  load_a_slice(A, lda, M, K, m0, 0, a);
  for (int k0 = 0; k0 < K; k0 += TK) {
    const bool nonzero =
        a[0] != 0.f || a[1] != 0.f || a[2] != 0.f || a[3] != 0.f;
    store_a_slice(s, a);
    if (k0 + TK < K) load_a_slice(A, lda, M, K, m0, k0 + TK, a);
    if (!__syncthreads_or(nonzero)) continue;  // barrier + vote
    slice_fma(B, ldb, N, K, n0, k0, s, acc);
  }
}

}  // namespace gnnk
