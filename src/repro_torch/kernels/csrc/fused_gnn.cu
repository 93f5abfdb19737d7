// Fused Graph Engine -> Dense Engine layer: out = act((A . H) . W).
//
// Replaces: src/repro/kernels/fused_gnn.py::fused_gnn_layer (the Pallas
// kernel with grid (dst, D/B, src) whose (n x B) aggregate block is
// consumed from VMEM and never written to HBM).
//
// Bound on the card: the aggregation is the same densified product as
// shard_spmm (2*S^2*n^2*D flops, float32 FMA), so operations bound it at
// Pubmed's shapes; the extraction adds 2*S*n*D*F flops, which is small
// for the model's F (16, then 3). What fusion saves is the (S*n x D)
// aggregate's round trip through device memory.
//
// Design: grid (S, ceil(n/64), ceil(F/64)). A block first marks, in a
// shared bitmap, which (64 x 16) slices of its 64 rows of A[i, :] hold
// an edge (eight warps check slices in parallel); a densified adjacency
// is almost all zero, and adding zeros changes no finite sum. Then for
// each 64-wide D tile it aggregates sum_j A[i, j] h[j][:, tile] over the
// marked slices only, in registers, parks the (64 x 64) aggregate in
// shared memory, and multiplies it into a (64 x 64) output accumulator
// with the matching (64 x 64) tile of W.
// The aggregate never reaches global memory. The activation runs once,
// at the end. If F > 64 the aggregation is recomputed for each F tile,
// which keeps any F correct; the slice's F fits one tile.
#include "common.cuh"

using namespace gnnk;

// bitmap capacity in (64 x 16) slices per block row: S * ceil(n/16)
// must fit (the wrapper checks), e.g. S <= 1024 at n = 512
constexpr int kMaxSlices = 32768;

__global__ void __launch_bounds__(THREADS)
fused_gnn_kernel(const float* __restrict__ blocks,
                 const float* __restrict__ h, const float* __restrict__ w,
                 float* __restrict__ out, int s, int n, int d, int f,
                 int act) {
  const int i = blockIdx.x;
  const int v0 = blockIdx.y * TM;
  const int f0 = blockIdx.z * TN;
  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  __shared__ TileSmem sm;
  __shared__ float agg[TM][TN + 1];  // (v, d-tile) aggregate
  __shared__ float ws[TN][TN];       // (d-tile, f-tile) slice of W
  __shared__ unsigned live[kMaxSlices / 32];
  const int ks = (n + TK - 1) / TK;  // slices per source shard
  const int slices = s * ks;
  const int words = (slices + 31) / 32;
  for (int wd = t; wd < words; wd += THREADS) live[wd] = 0u;
  __syncthreads();
  {
    const int warp = t / 32, lane = t % 32;
    for (int idx = warp; idx < slices; idx += THREADS / 32) {
      const int j = idx / ks, k0 = (idx % ks) * TK;
      const float* a = blocks + ((long long)i * s + j) * n * n;
      bool nz = false;
#pragma unroll 8
      for (int q = 0; q < TM * TK / 32; ++q) {
        const int e = lane + 32 * q;
        const int r = v0 + e / TK, c = k0 + e % TK;
        if (r < n && c < n) nz |= a[(long long)r * n + c] != 0.f;
      }
      if (__any_sync(0xffffffffu, nz) && lane == 0)
        atomicOr(&live[idx / 32], 1u << (idx % 32));
    }
  }
  __syncthreads();
  float acc[4][4] = {};
  for (int d0 = 0; d0 < d; d0 += TN) {
    float part[4][4] = {};
    for (int wd = 0; wd < words; ++wd) {
      unsigned bits = live[wd];  // the same for every thread
      while (bits) {
        const int idx = wd * 32 + __ffs(bits) - 1;
        bits &= bits - 1;
        const int j = idx / ks, k0 = (idx % ks) * TK;
        float av[4];
        load_a_slice(blocks + ((long long)i * s + j) * n * n, n, n, n, v0,
                     k0, av);
        store_a_slice(sm, av);
        slice_fma(h + (long long)j * n * d, d, d, n, d0, k0, sm, part);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) agg[ty + 16 * r][tx + 16 * c] = part[r][c];
    for (int e = t; e < TN * TN; e += THREADS) {
      const int r = e / TN, c = e % TN;
      ws[r][c] = (d0 + r < d && f0 + c < f)
                     ? w[(long long)(d0 + r) * f + f0 + c]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TN; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = agg[ty + 16 * r][k];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = ws[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  float* o = out + (long long)i * n * f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int v = v0 + ty + 16 * r;
    if (v >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ff = f0 + tx + 16 * c;
      if (ff < f) o[(long long)v * f + ff] = activate(acc[r][c], act);
    }
  }
}

extern "C" int fused_gnn_launch(const float* blocks, const float* h,
                                const float* w, float* out, int s, int n,
                                int d, int f, int act, cudaStream_t stream) {
  const dim3 grid(s, (n + TM - 1) / TM, (f + TN - 1) / TN);
  fused_gnn_kernel<<<grid, THREADS, 0, stream>>>(blocks, h, w, out, s, n, d,
                                                 f, act);
  return (int)cudaGetLastError();
}
