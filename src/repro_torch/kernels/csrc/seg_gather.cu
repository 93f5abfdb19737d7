// Graph Engine gather aggregation (max or sum) over a destination-sorted
// edge index.
//
// Replaces: src/repro/kernels/seg_gather.py::seg_gather_aggregate (the
// Pallas kernel that walks each shard pair's padded COO list, gathers
// source rows and scatter-reduces max or sum into an (n x B) block).
//
// Bound on the card: bytes. Each valid edge reads one D-wide source row
// (4 * D bytes) and does D comparisons or adds; the index (4 bytes an
// edge, 4 a row) is read once and the output written once. At Pubmed
// layer 0 the rows are 217 MB of reads, mostly from L2 (the 40 MB source
// matrix fits in the 50 MB L2), against 40 MB written.
//
// Design: the index (seg_gather.py::gather_index) lists, for every
// global destination row, its global source rows in the (j, e) order in
// which the TPU kernel applies them (row_ptr / src, CSR). One warp owns
// one destination row and up to 512 feature columns (grid: ceil(rows / 8)
// blocks of 8 warps x ceil(D / 512)). Lane l keeps its 16 columns in
// registers: 4 l + 128 c (+0..3) as float4 when D % 4 == 0 and the rows
// are 16-byte aligned, else l + 32 c. The warp reads 32 source ids at a
// time, broadcasts each by shuffle, loads INFLIGHT source rows before it
// applies any, and writes its row once. No shared memory, no atomics:
// each output has one writer and a fixed order, so sum is deterministic
// and max exact. A row with no edge gives 0; so does a max that is not
// finite, as in the plain version.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 512;     // columns per warp: 16 per lane
constexpr int PER_LANE = 16;
constexpr int INFLIGHT = 4;   // source rows loaded before they are applied
constexpr unsigned kFull = 0xffffffffu;

// Column of this lane's value j within the warp's chunk.
template <bool kVec>
__device__ __forceinline__ int column(int lane, int j) {
  return kVec ? 128 * (j / 4) + 4 * lane + (j % 4) : 32 * j + lane;
}

// The 16 values of source row `hr` this lane owns (0 past D).
template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ hr,
                                         int lane, int c0, int d,
                                         float (&x)[PER_LANE]) {
  if (kVec) {
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int col = c0 + column<true>(lane, 4 * q);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < d) v = __ldg(reinterpret_cast<const float4*>(hr + col));
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int col = c0 + column<false>(lane, j);
      x[j] = col < d ? __ldg(hr + col) : 0.f;
    }
  }
}

template <bool kVec, bool kMax>
__global__ void __launch_bounds__(THREADS, 2)
seg_gather_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ src, const float* __restrict__ h,
                  float* __restrict__ out, int rows, int d, int nnz,
                  int rows_src) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * COLS;

  float acc[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) acc[j] = kMax ? -INFINITY : 0.f;

  // an index that is not gather_index's reads nothing out of range:
  // bounds clamped to [0, nnz], source ids outside [0, rows_src) skipped
  const int begin = max(0, row_ptr[row]);
  const int end = min(nnz, row_ptr[row + 1]);
  for (int base = begin; base < end; base += 32) {
    const int count = min(32, end - base);  // warp-uniform
    const int mine = lane < count ? src[base + lane] : 0;
    for (int e = 0; e < count; e += INFLIGHT) {
      float x[INFLIGHT][PER_LANE];
      bool use[INFLIGHT];
#pragma unroll
      for (int r = 0; r < INFLIGHT; ++r) {
        const int u = __shfl_sync(kFull, mine, (e + r) & 31);
        use[r] = e + r < count && u >= 0 && u < rows_src;  // warp-uniform
        if (use[r]) load_row<kVec>(h + (long long)u * d, lane, c0, d, x[r]);
      }
#pragma unroll
      for (int r = 0; r < INFLIGHT; ++r) {
        if (!use[r]) continue;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j)
          acc[j] = kMax ? fmaxf(acc[j], x[r][j]) : acc[j] + x[r][j];
      }
    }
  }

  if (kMax) {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (!isfinite(acc[j])) acc[j] = 0.f;
  }
  float* o = out + (long long)row * d + c0;
  if (kVec) {
#pragma unroll
    for (int q = 0; q < PER_LANE / 4; ++q) {
      const int col = column<true>(lane, 4 * q);
      if (c0 + col < d)
        *reinterpret_cast<float4*>(o + col) = make_float4(
            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int col = column<false>(lane, j);
      if (c0 + col < d) o[col] = acc[j];
    }
  }
}

template <bool kVec>
int launch(const int* row_ptr, const int* src, const float* h, float* out,
           int rows, int d, int is_max, int nnz, int rows_src,
           cudaStream_t stream) {
  const dim3 grid((rows + WARPS - 1) / WARPS, (d + COLS - 1) / COLS);
  if (is_max)
    seg_gather_kernel<kVec, true><<<grid, THREADS, 0, stream>>>(
        row_ptr, src, h, out, rows, d, nnz, rows_src);
  else
    seg_gather_kernel<kVec, false><<<grid, THREADS, 0, stream>>>(
        row_ptr, src, h, out, rows, d, nnz, rows_src);
  return (int)cudaGetLastError();
}

}  // namespace

// row_ptr (rows + 1,) and src (nnz,) int32 from gather_index, h the
// (rows_src, d) float32 source matrix, out (rows, d). The wrapper checks
// shapes and types.
extern "C" int seg_gather_launch(const int* row_ptr, const int* src,
                                 const float* h, float* out, int rows, int d,
                                 int is_max, int nnz, int rows_src,
                                 cudaStream_t stream) {
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return vec ? launch<true>(row_ptr, src, h, out, rows, d, is_max, nnz,
                            rows_src, stream)
             : launch<false>(row_ptr, src, h, out, rows, d, is_max, nnz,
                             rows_src, stream);
}
