// Graph Engine linear aggregation: out[i] = sum_j A[i, j] @ h[j], over
// the blocks' nonzeros listed by destination row.
//
// Replaces: src/repro/kernels/shard_spmm.py::shard_spmm (the Pallas
// kernel with grid (D/B, dst, src) and an (n x B) VMEM accumulator that
// multiplies every dense (n x n) block).
//
// Bound on the card: bytes. The function needs only the blocks' nonzeros
// (csr.linear_index: row_ptr, and a column and a value per nonzero), h
// and out: about 81 MB at Pubmed layer 0 (index 0.95 MB; h and out 39.9
// MB each at S 39, n 512, D 500), 0.024 ms at 3.35 TB/s. Each nonzero
// also gathers one D-wide row of h (217 MB there), mostly from L2, since
// the 40 MB of h fit in the 50 MB L2. The 2 nnz D float32 FMA operations
// take a tenth of the bytes' time.
//
// Design: csr_walk.cuh's row walk. L lanes own one destination row (L =
// 32 for D > 128, 8 for D <= 128, 4 for D <= 16), each lane up to 16 of
// its columns in registers, as float4 when D % 4 == 0 and h and out are
// 16-byte aligned; the row's (col, val) entries are walked INF at a time
// with the next INF loading meanwhile, and the aggregate is stored
// straight from the registers: each output has one writer, no atomics,
// and its sum runs in the fixed order (j, u). D above one chunk (L x 16
// columns, 512 at L = 32) is split into chunks that walk the row's
// entries again. Hub rows (more than csr.HUB_ENTRIES = 32 entries, listed
// by linear_index, longest first; Pubmed's longest has 314) would hold
// one warp for many rounds of loads: the first blocks of the grid take
// one each, their 8 warps an eighth of its entries apiece, and the
// eighths are added in shared memory in warp order. A row with no nonzero
// gives 0. Destination rows (S_dst n) and source rows (S_src n) are
// counted apart, so a rectangular grid needs
// nothing else; a column outside h is skipped.
#include <cuda_runtime.h>

#include <cstdint>

#include "csr_walk.cuh"

namespace {

using namespace gnnk::walk;

// Store this lane's PL aggregate values of a row at chunk c0 (nothing
// past D).
template <int L, int PL, bool kVec>
__device__ __forceinline__ void store_row(float* __restrict__ orow, int l,
                                          int c0, int d,
                                          const float (&agg)[PL]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < PL / 4; ++q) {
      const int col = c0 + column<L, true>(l, 4 * q);
      if (col < d)
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            agg[4 * q], agg[4 * q + 1], agg[4 * q + 2], agg[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int col = c0 + column<L, false>(l, j);
      if (col < d) orow[col] = agg[j];
    }
  }
}

// One hub row for the whole block: each of the 8 warps gathers a
// contiguous eighth of the row's entries (L = 32 layout) into its row of
// `part`, and the block adds the eighths in warp order, chunk by chunk.
template <bool kVec>
__device__ __forceinline__ void hub_row(
    const int* __restrict__ row_ptr, const int* __restrict__ col,
    const float* __restrict__ val, const float* __restrict__ h,
    float* __restrict__ out, int rows_src, int d, int nnz, int row,
    float (&part)[WARPS][Cfg<32>::C]) {
  using K = Cfg<32>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nd = (d + K::C - 1) / K::C;
  int begin, end;
  row_span(row_ptr, row, nnz, begin, end);
  const int seg = (end - begin + WARPS - 1) / WARPS;
  const int b = min(end, begin + warp * seg), e = min(end, b + seg);
  float* orow = out + (long long)row * d;
  for (int dc = 0; dc < nd; ++dc) {
    const int c0 = dc * K::C;
    float agg[K::PL];
#pragma unroll
    for (int j = 0; j < K::PL; ++j) agg[j] = 0.f;
    gather<32, kVec>(col, val, h, rows_src, d, c0, lane, b, e, agg);
    if (dc > 0) __syncthreads();  // the last chunk's readers are done
    if (kVec) {
#pragma unroll
      for (int q = 0; q < K::PL / 4; ++q)
        *reinterpret_cast<float4*>(&part[warp][column<32, true>(lane, 4 * q)]) =
            make_float4(agg[4 * q], agg[4 * q + 1], agg[4 * q + 2],
                        agg[4 * q + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < K::PL; ++j)
        part[warp][column<32, false>(lane, j)] = agg[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < K::C && c0 + c < d; c += THREADS) {
      float y = 0.f;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) y += part[v][c];
      orow[c0 + c] = y;
    }
  }
}

// Blocks [0, n_hubs) take one hub row each (hubs: csr.linear_index's
// list of the rows of more than hub_min entries), so the longest rows
// start first; the rest own ROWS rows each and skip the hubs.
template <int L, bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
shard_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                  const float* __restrict__ val, const int* __restrict__ hubs,
                  const float* __restrict__ h, float* __restrict__ out,
                  int rows, int rows_src, int d, int nnz, int n_hubs,
                  int hub_min) {
  using K = Cfg<L>;
  constexpr int PL = K::PL, C = K::C;
  __shared__ __align__(16) float part[WARPS][Cfg<32>::C];
  if (blockIdx.x < n_hubs) {
    const int row = hubs[blockIdx.x];
    if (row >= 0 && row < rows)  // block-uniform
      hub_row<kVec>(row_ptr, col, val, h, out, rows_src, d, nnz, row, part);
    return;
  }
  const int block = blockIdx.x - n_hubs;
  const int lane = threadIdx.x % 32;
  const int l = lane % L;  // lane within the row
  const int slot = (threadIdx.x / 32) * K::GROUPS + lane / L;
  const int nd = (d + C - 1) / C;
  // no barrier or shuffle below: a lane leaves as soon as its rows end
  for (int it = 0; it < K::ITERS; ++it) {
    const int row = block * K::ROWS + it * WARPS * K::GROUPS + slot;
    if (row >= rows) return;
    int begin, end;
    row_span(row_ptr, row, nnz, begin, end);
    if (end - begin > hub_min) continue;  // a hub block's row
    float* orow = out + (long long)row * d;
    for (int dc = 0; dc < nd; ++dc) {
      float agg[PL];
#pragma unroll
      for (int j = 0; j < PL; ++j) agg[j] = 0.f;
      gather<L, kVec>(col, val, h, rows_src, d, dc * C, l, begin, end, agg);
      store_row<L, PL, kVec>(orow, l, dc * C, d, agg);
    }
  }
}

template <int L>
int launch(const int* row_ptr, const int* col, const float* val,
           const int* hubs, const float* h, float* out, int rows,
           int rows_src, int d, int nnz, int n_hubs, int hub_min, bool vec,
           cudaStream_t stream) {
  const dim3 grid(n_hubs + (rows + Cfg<L>::ROWS - 1) / Cfg<L>::ROWS);
  if (vec)
    shard_spmm_kernel<L, true><<<grid, THREADS, 0, stream>>>(
        row_ptr, col, val, hubs, h, out, rows, rows_src, d, nnz, n_hubs,
        hub_min);
  else
    shard_spmm_kernel<L, false><<<grid, THREADS, 0, stream>>>(
        row_ptr, col, val, hubs, h, out, rows, rows_src, d, nnz, n_hubs,
        hub_min);
  return (int)cudaGetLastError();
}

}  // namespace

// row_ptr (rows + 1,), col (nnz,) int32, val (nnz,) float32 and hubs
// (n_hubs,) int32 (the rows of more than hub_min entries) from
// csr.linear_index of (S_dst, S_src, n, n) blocks: rows = S_dst n
// destination rows, columns j n + u < rows_src = S_src n. h the
// (rows_src, d) source matrix, out (rows, d). The wrapper checks shapes
// and types.
extern "C" int shard_spmm_launch(const int* row_ptr, const int* col,
                                 const float* val, const int* hubs,
                                 const float* h, float* out, int rows,
                                 int rows_src, int d, int nnz, int n_hubs,
                                 int hub_min, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (d <= 16)
    return launch<4>(row_ptr, col, val, hubs, h, out, rows, rows_src, d, nnz,
                     n_hubs, hub_min, vec, stream);
  if (d <= 128)
    return launch<8>(row_ptr, col, val, hubs, h, out, rows, rows_src, d, nnz,
                     n_hubs, hub_min, vec, stream);
  return launch<32>(row_ptr, col, val, hubs, h, out, rows, rows_src, d, nnz,
                    n_hubs, hub_min, vec, stream);
}
