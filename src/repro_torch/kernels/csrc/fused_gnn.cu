// Fused Graph Engine -> Dense Engine layer: out = act((A . H) . W),
// over the blocks' nonzeros listed by destination row.
//
// Replaces: src/repro/kernels/fused_gnn.py::fused_gnn_layer (the Pallas
// kernel with grid (dst, D/B, src) whose (n x B) aggregate block is
// consumed from VMEM and never written to HBM).
//
// Bound on the card: bytes. The index (csr.linear_index: row_ptr, and a
// column and a value per nonzero) is read once, h once, W once and out
// written once: about 42 MB at Pubmed layer 0 (D 500 -> F 16). Each
// nonzero also gathers one D-wide row of h (217 MB there), mostly from
// L2, since the 40 MB of h fit in the 50 MB L2. The operations
// (2 nnz D + 2 S n D F, float32 FMA) are a tenth of that in time.
//
// Design: csr_walk.cuh's row walk, shared with shard_spmm. L lanes own
// one destination row (L = 32 for D > 128, 8 for
// D <= 128, 4 for D <= 16, so small D packs 8 rows into a warp), each
// lane up to 16 of its columns in registers, as float4 when D % 4 == 0
// and h is 16-byte aligned. A row group walks its row's (col, val)
// entries INF at a time (4, or 8 at D <= 16): INF rows of h in flight,
// and the next INF index entries loading while they are applied, so a
// round costs one load latency and a hub row keeps several rows in the
// air. The aggregate stays in registers and meets W there: W's (D-chunk
// x 16) tile is staged once per block in shared memory, transposed and
// padded so each lane reads its columns as conflict-free float4s; each
// lane forms 16 partial outputs, and a reduce-scatter over the row's L
// lanes (16 shuffles at L = 32) leaves each output on one lane, which
// applies the activation and writes it. D above 512 is split into chunks
// whose partial outputs add up in out (the same lane owns an output in
// every chunk); F above 16 is split into chunks that aggregate again.
// Hub rows (more than csr.HUB_ENTRIES = 32 entries; Pubmed's 135 such
// rows sit among its first few hundred, the longest has 314) would set
// the kernel's time, one round of loads after another in one warp, in
// the few blocks that hold them: linear_index lists them, and the first
// blocks of the grid take one each, their 8 warps an eighth of its
// entries apiece, adding the partial outputs in shared memory. No
// atomics: each output has one writer and a fixed order. A row with no
// nonzero gives act(0).
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "csr_walk.cuh"

namespace {

using namespace gnnk::walk;

constexpr int FC = 16;         // output columns per chunk
constexpr unsigned kFull = 0xffffffffu;

// Sum the N partial outputs v over the row's lanes (xor offsets OFF, OFF/2,
// .., 1), halving the values a lane keeps at each step while it keeps
// more than one: afterwards the lane holds outputs base .. base + N' - 1.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float (&v)[FC], int lane,
                                               int& base) {
  if constexpr (OFF >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      if (up) base += H;
      reduce_scatter<H, OFF / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, lane, base);
    }
  }
}

// Stage W's (C x FC) chunk at (c0, f0) into ws, transposed, zero past
// D x F; every thread of the block takes part.
template <int C>
__device__ __forceinline__ void stage_w(float (&ws)[FC][C + 4],
                                        const float* __restrict__ w, int d,
                                        int f, int c0, int f0) {
#pragma unroll
  for (int i = 0; i < FC * C / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int c = e / FC, q = e % FC;  // W read along F
    ws[q][c] = (c0 + c < d && f0 + q < f)
                   ? __ldg(w + (long long)(c0 + c) * f + f0 + q)
                   : 0.f;
  }
}

// p[q] = sum over this lane's columns of agg * W (the staged chunk).
template <int L, bool kVec>
__device__ __forceinline__ void extract(const float (&agg)[Cfg<L>::PL],
                                        const float (&ws)[FC][Cfg<L>::C + 4],
                                        int l, float (&p)[FC]) {
  constexpr int PL = Cfg<L>::PL;
#pragma unroll
  for (int q = 0; q < FC; ++q) p[q] = 0.f;
  if (kVec) {
#pragma unroll
    for (int g = 0; g < PL / 4; ++g) {
      const int c = column<L, true>(l, 4 * g);
#pragma unroll
      for (int q = 0; q < FC; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[q][c]);
        p[q] = fmaf(agg[4 * g], wv.x, p[q]);
        p[q] = fmaf(agg[4 * g + 1], wv.y, p[q]);
        p[q] = fmaf(agg[4 * g + 2], wv.z, p[q]);
        p[q] = fmaf(agg[4 * g + 3], wv.w, p[q]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int c = column<L, false>(l, j);
#pragma unroll
      for (int q = 0; q < FC; ++q) p[q] = fmaf(agg[j], ws[q][c], p[q]);
    }
  }
}

// One hub row (more than hub_min entries) for the whole block: each of
// the 8 warps gathers a contiguous eighth of the row's entries (L = 32
// layout), forms its 16 partial outputs against the staged W, and the
// partials add up in shared memory in warp order.
template <bool kVec>
__device__ __forceinline__ void hub_row(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const float* __restrict__ val, const float* __restrict__ h,
    const float* __restrict__ w, float* __restrict__ out, int rows, int d,
    int f, int act, int nnz, int row, float (&ws)[FC][Cfg<32>::C + 4],
    float (&part)[WARPS][FC]) {
  using K = Cfg<32>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nd = (d + K::C - 1) / K::C;
  int begin, end;
  row_span(row_ptr, row, nnz, begin, end);
  const int seg = (end - begin + WARPS - 1) / WARPS;
  const int b = min(end, begin + warp * seg), e = min(end, b + seg);
  for (int f0 = 0; f0 < f; f0 += FC) {
    for (int dc = 0; dc < nd; ++dc) {
      __syncthreads();  // the last chunk's readers are done
      stage_w<K::C>(ws, w, d, f, dc * K::C, f0);
      __syncthreads();
      float agg[K::PL];
#pragma unroll
      for (int j = 0; j < K::PL; ++j) agg[j] = 0.f;
      gather<32, kVec>(col, val, h, rows, d, dc * K::C, lane, b, e, agg);
      float p[FC];
      extract<32, kVec>(agg, ws, lane, p);
      int base = 0;
      reduce_scatter<FC, 16>(p, lane, base);  // lanes 2q, 2q+1: output q
      if ((lane & 1) == 0) part[warp][base] = p[0];
      __syncthreads();
      if (threadIdx.x < FC && f0 + threadIdx.x < f) {
        float y = 0.f;
#pragma unroll
        for (int v = 0; v < WARPS; ++v) y += part[v][threadIdx.x];
        float* o = out + (long long)row * f + f0 + threadIdx.x;
        if (dc > 0) y += *o;
        *o = dc == nd - 1 ? gnnk::activate(y, act) : y;
      }
    }
  }
}

// Blocks [0, n_hubs) take one hub row each (hubs: csr.linear_index's
// list of the rows of more than hub_min entries), so the longest rows
// start first; the rest own ROWS rows each and skip the hubs.
template <int L, bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
fused_gnn_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                 const float* __restrict__ val, const int* __restrict__ hubs,
                 const float* __restrict__ h, const float* __restrict__ w,
                 float* __restrict__ out, int rows, int d, int f, int act,
                 int nnz, int n_hubs, int hub_min) {
  using K = Cfg<L>;
  constexpr int PL = K::PL, C = K::C;
  constexpr int R = FC >= L ? FC / L : 1;  // outputs a lane keeps
  // W chunk, transposed; sized for the hub blocks' L = 32 layout
  __shared__ __align__(16) float ws[FC][Cfg<32>::C + 4];
  __shared__ float part[WARPS][FC];
  if (blockIdx.x < n_hubs) {
    const int row = hubs[blockIdx.x];
    if (row >= 0 && row < rows)  // block-uniform
      hub_row<kVec>(row_ptr, col, val, h, w, out, rows, d, f, act, nnz, row,
                    ws, part);
    return;
  }
  const int block = blockIdx.x - n_hubs;

  const int lane = threadIdx.x % 32;
  const int l = lane % L;  // lane within the row
  const int slot = (threadIdx.x / 32) * K::GROUPS + lane / L;
  const int nd = (d + C - 1) / C;

  for (int f0 = 0; f0 < f; f0 += FC) {
    for (int it = 0; it < K::ITERS; ++it) {
      const int row = block * K::ROWS + it * WARPS * K::GROUPS + slot;
      // rows of more than hub_min entries are the hub blocks'
      int begin = 0, end = 0;
      if (row < rows) row_span(row_ptr, row, nnz, begin, end);
      const bool mine = row < rows && end - begin <= hub_min;
      for (int dc = 0; dc < nd; ++dc) {
        const int c0 = dc * C;
        if (nd > 1 || it == 0) {  // block-uniform
          __syncthreads();        // the last chunk's readers are done
          stage_w<C>(reinterpret_cast<float(&)[FC][C + 4]>(ws), w, d, f,
                     c0, f0);
          __syncthreads();
        }
        float agg[PL];
#pragma unroll
        for (int j = 0; j < PL; ++j) agg[j] = 0.f;
        if (mine) gather<L, kVec>(col, val, h, rows, d, c0, l, begin, end, agg);
        float p[FC];
        extract<L, kVec>(agg, reinterpret_cast<float(&)[FC][C + 4]>(ws), l,
                         p);
        // every lane of the warp reaches this point (rows past the end
        // carry zeros), as the full-mask shuffles need
        int base = 0;
        reduce_scatter<FC, L / 2>(p, lane, base);
        // the D chunks' partial outputs add up in out (one writer per
        // element, the same lane every chunk); the last applies act
        if (mine && (L <= FC || (l & (L / FC - 1)) == 0)) {
          float* o = out + (long long)row * f + f0 + base;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (f0 + base + i >= f) continue;
            const float y = dc == 0 ? p[i] : o[i] + p[i];
            o[i] = dc == nd - 1 ? gnnk::activate(y, act) : y;
          }
        }
      }
    }
  }
}

template <int L>
int launch(const int* row_ptr, const int* col, const float* val,
           const int* hubs, const float* h, const float* w, float* out,
           int rows, int d, int f, int act, int nnz, int n_hubs, int hub_min,
           bool vec, cudaStream_t stream) {
  const dim3 grid(n_hubs + (rows + Cfg<L>::ROWS - 1) / Cfg<L>::ROWS);
  if (vec)
    fused_gnn_kernel<L, true><<<grid, THREADS, 0, stream>>>(
        row_ptr, col, val, hubs, h, w, out, rows, d, f, act, nnz, n_hubs,
        hub_min);
  else
    fused_gnn_kernel<L, false><<<grid, THREADS, 0, stream>>>(
        row_ptr, col, val, hubs, h, w, out, rows, d, f, act, nnz, n_hubs,
        hub_min);
  return (int)cudaGetLastError();
}

}  // namespace

// row_ptr (rows + 1,), col (nnz,) int32, val (nnz,) float32 and hubs
// (n_hubs,) int32 (the rows of more than hub_min entries) from
// csr.linear_index; h the (rows, d) source matrix, w (d, f), out
// (rows, f). The wrapper checks shapes and types.
extern "C" int fused_gnn_launch(const int* row_ptr, const int* col,
                                const float* val, const int* hubs,
                                const float* h, const float* w, float* out,
                                int rows, int d, int f, int act, int nnz,
                                int n_hubs, int hub_min,
                                cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  if (d <= 16)
    return launch<4>(row_ptr, col, val, hubs, h, w, out, rows, d, f, act,
                     nnz, n_hubs, hub_min, vec, stream);
  if (d <= 128)
    return launch<8>(row_ptr, col, val, hubs, h, w, out, rows, d, f, act,
                     nnz, n_hubs, hub_min, vec, stream);
  return launch<32>(row_ptr, col, val, hubs, h, w, out, rows, d, f, act,
                    nnz, n_hubs, hub_min, vec, stream);
}
