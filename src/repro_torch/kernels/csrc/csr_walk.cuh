// The destination-row walk over csr.linear_index of shard_spmm (float32,
// sm_90a); fused_gnn takes only the block shape and row_span from here
// (its walk is 4 lanes a row chunk at every width, csrc/fused_gnn.cu).
//
// L lanes own one destination row (L = 32 for D > 128, 8 for D <= 128, 4
// for D <= 16, so small D packs several rows into a warp), each lane up
// to 16 of its columns in registers, as float4 when D % 4 == 0 and h is
// 16-byte aligned. gather() walks a row's (col, val) entries INF at a
// time (4, or 8 at D <= 16): INF rows of h in flight, and the next INF
// index entries loading while they are applied, so a round costs one
// load latency. The sum runs in entry order, that is (j, u).
#pragma once

#include <cuda_runtime.h>

namespace gnnk {
namespace walk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Column of value j of lane l (of L) within a chunk of L * 16 columns.
template <int L, bool kVec>
__device__ __forceinline__ int column(int l, int j) {
  return kVec ? 4 * L * (j / 4) + 4 * l + (j % 4) : L * j + l;
}

// This lane's PL values of source row `hr` in the chunk at c0 (0 past D).
template <int L, int PL, bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ hr, int l,
                                         int c0, int d, float (&x)[PL]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < PL / 4; ++q) {
      const int col = c0 + column<L, true>(l, 4 * q);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < d) v = __ldg(reinterpret_cast<const float4*>(hr + col));
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int col = c0 + column<L, false>(l, j);
      x[j] = col < d ? __ldg(hr + col) : 0.f;
    }
  }
}

// Per-configuration constants: L lanes a row, PL columns a lane, INF
// entries of a row in flight, ITERS row rounds a warp.
template <int L>
struct Cfg {
  static constexpr int PL = L == 4 ? 4 : 16;
  static constexpr int C = L * PL;              // columns a chunk holds
  static constexpr int INF = L == 4 ? 8 : 4;
  static constexpr int GROUPS = 32 / L;         // rows a warp holds at once
  static constexpr int ITERS = L == 32 ? 2 : 1;
  static constexpr int ROWS = WARPS * GROUPS * ITERS;  // rows a block owns
};

// agg[j] += sum over the row's entries [begin, end) of val * h[col][c0 +
// column j], INF rows of h in flight; the next INF (col, val) pairs load
// while the current rows are applied. `rows` is the number of rows of h:
// columns outside [0, rows) (an index not made by linear_index) are
// skipped.
template <int L, bool kVec>
__device__ __forceinline__ void gather(const int* __restrict__ col,
                                       const float* __restrict__ val,
                                       const float* __restrict__ h, int rows,
                                       int d, int c0, int l, int begin,
                                       int end, float (&agg)[Cfg<L>::PL]) {
  constexpr int PL = Cfg<L>::PL, INF = Cfg<L>::INF;
  int u[INF];
  float a[INF];
#pragma unroll
  for (int r = 0; r < INF; ++r) {
    u[r] = begin + r < end ? __ldg(col + begin + r) : -1;
    a[r] = begin + r < end ? __ldg(val + begin + r) : 0.f;
  }
  for (int e = begin; e < end; e += INF) {
    float x[INF][PL];
#pragma unroll
    for (int r = 0; r < INF; ++r) {
      if (u[r] >= 0 && u[r] < rows)
        load_row<L, PL, kVec>(h + (long long)u[r] * d, l, c0, d, x[r]);
      else
        a[r] = 0.f;
    }
    int un[INF];
    float an[INF];
#pragma unroll
    for (int r = 0; r < INF; ++r) {
      const int k = e + INF + r;
      un[r] = k < end ? __ldg(col + k) : -1;
      an[r] = k < end ? __ldg(val + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < INF; ++r) {
      if (a[r] == 0.f) continue;
#pragma unroll
      for (int j = 0; j < PL; ++j) agg[j] = fmaf(a[r], x[r][j], agg[j]);
    }
#pragma unroll
    for (int r = 0; r < INF; ++r) {
      u[r] = un[r];
      a[r] = an[r];
    }
  }
}

// the row's entries [begin, end), clamped to [0, nnz]: an index that is
// not linear_index's reads nothing out of range
__device__ __forceinline__ void row_span(const int* __restrict__ row_ptr,
                                         int row, int nnz, int& begin,
                                         int& end) {
  begin = max(0, row_ptr[row]);
  end = min(nnz, row_ptr[row + 1]);
}

}  // namespace walk
}  // namespace gnnk
