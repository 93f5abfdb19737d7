// Fused Graph Engine -> Dense Engine layer: out = act(A . H . W), over
// the blocks' nonzeros listed by destination row.
//
// Replaces: src/repro/kernels/fused_gnn.py::fused_gnn_layer (the Pallas
// kernel with grid (dst, D/B, src) whose (n x B) aggregate block is
// consumed from VMEM and never written to HBM).
//
// Bound on the card: bytes. The least work takes the product in the
// cheaper association and aggregates at width K = min(D, F): the index
// (csr.linear_index: row_ptr, and a column and a value per nonzero) read
// once, h once, W once and out written once. Reddit x0.1's layer 0 (D 602
// -> F 16, 11.46 M nonzeros) needs 150 MB, 0.045 ms at 3.35 TB/s;
// Pubmed's layer 0 (D 500 -> F 16) 42 MB. Each nonzero also gathers one
// K-wide row (64 B at K 16: 0.73 GB at reddit, from L2), and the
// operations (2 nnz K + 2 rows D F, float32 FMA) take a fraction of the
// bytes' time.
//
// Design: one cooperative launch of a persistent grid (as many blocks as
// fit on the card at once), in two phases around a grid-wide barrier.
// - D > F, project first: phase 1 streams h once and writes Z = H . W
//   (rows x Kp, Kp = F rounded up to 4, zero past F) into the wrapper's
//   workspace, 64 rows x 16 columns a tile, h and W staged 32 deep in
//   shared memory, the next stage loading into registers meanwhile; each
//   stage's products are summed apart and then added to the total.
//   Phase 2 aggregates Z at width F and applies the activation.
// - D <= F, aggregate first: phase 2 aggregates h at width D and
//   multiplies each row's aggregate, held on chip, by every column of W
//   (read through the read-only cache).
// Phase 2 walks K in chunks of 16 columns: a chunk of one row is 4 lanes
// holding a float4 each, so a warp keeps tens of gathers in flight. Rows
// of at most csr.HUB_ENTRIES entries take 4 lanes each; hub rows a warp
// each, its 8 lane groups taking every 8th entry, 64 entries a round with
// the next round's index loading meanwhile; hub rows of more than
// BLOCK_ENTRIES entries a block each, in 8 segments, one a warp, added in
// segment order. Work is handed out from counters in the workspace
// (linear_index lists the hub rows longest first, so the longest start
// first), but a row's arithmetic depends on its length alone, never on
// which warp or block takes it: no float atomics, one writer per output,
// a fixed order of summation, and the output bitwise the same from run
// to run. A row with no nonzero gives act(0); a column outside [0, rows)
// is skipped and row pointers are clamped to the entry list. Widths
// above 16 walk a row's entries once per chunk: each column is still
// gathered once.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "csr_walk.cuh"

namespace {

namespace cg = cooperative_groups;
using gnnk::walk::row_span;
using gnnk::walk::THREADS;
using gnnk::walk::WARPS;

constexpr unsigned kFull = 0xffffffffu;
constexpr int KC = 16;               // columns of a chunk: 4 lanes x float4
constexpr int GROUPS = 32 / 4;       // lane groups of a warp
constexpr int SEGMENTS = WARPS;      // a block row's segments
constexpr int BLOCK_ENTRIES = 2048;  // hub rows longer than this: a block
// phase 1's tile: TR rows x KC columns of Z, TK deep
constexpr int TR = 64, TK = 32;

struct Params {
  const int* row_ptr;
  const int* col;
  const float* val;
  const int* hubs;
  const float* h;      // (rows, d)
  const float* w;      // (d, f)
  float* out;          // (rows, f)
  float* z;            // (rows, kp): H . W when projecting first
  int* ctr;            // 2 work counters
  int rows, d, f, kp, act, nnz, n_hubs, hub_min;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma4(float a, const float4& x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// Columns c .. c + 3 of row xr of width k (0 past k); kVec: the row's
// start and c are 16-byte aligned and the row's stride covers c + 3.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ xr, int c,
                                        int k) {
  if (kVec)
    return c < k ? __ldg(reinterpret_cast<const float4*>(xr + c)) : zero4();
  float4 v;
  v.x = c < k ? __ldg(xr + c) : 0.f;
  v.y = c + 1 < k ? __ldg(xr + c + 1) : 0.f;
  v.z = c + 2 < k ? __ldg(xr + c + 2) : 0.f;
  v.w = c + 3 < k ? __ldg(xr + c + 3) : 0.f;
  return v;
}

// The source of phase 2: x (rows x ld), k real columns.
struct Src {
  const float* x;
  int rows, ld, k;
};

template <bool kVec>
__device__ __forceinline__ float4 gather4(const Src& s, int u, float& a,
                                          int c) {
  if (u >= 0 && u < s.rows)
    return load4<kVec>(s.x + (long long)u * s.ld, c, s.k);
  a = 0.f;
  return zero4();
}

// Phase 1: z = h . w, (rows x kp), zero in columns f .. kp - 1.
__device__ __forceinline__ void project(const Params& p,
                                        float (&hs)[TK][TR + 1],
                                        float (&ws)[TK][KC]) {
  const int t = threadIdx.x;
  const int tr = t / 4, tq = t % 4;  // this thread's row and float4
  const int lr = t / 32, lc = t % 32;  // h loads: row lr + 8 i, column lc
  const int tiles_c = (p.kp + KC - 1) / KC;
  const int tiles = (p.rows + TR - 1) / TR * tiles_c;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile / tiles_c * TR, f0 = tile % tiles_c * KC;
    float hr[TR / WARPS], wr[TK * KC / THREADS];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < TR / WARPS; ++i) {
        const int r = r0 + lr + WARPS * i, k = k0 + lc;
        hr[i] = r < p.rows && k < p.d ? __ldg(p.h + (long long)r * p.d + k)
                                      : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TK * KC / THREADS; ++i) {
        const int e = t + THREADS * i;
        const int k = k0 + e / KC, q = f0 + e % KC;
        wr[i] = k < p.d && q < p.f ? __ldg(p.w + (long long)k * p.f + q)
                                   : 0.f;
      }
    };
    float4 acc = zero4();
    fetch(0);
    for (int k0 = 0; k0 < p.d; k0 += TK) {
      __syncthreads();  // the last stage's readers are done
#pragma unroll
      for (int i = 0; i < TR / WARPS; ++i) hs[lc][lr + WARPS * i] = hr[i];
#pragma unroll
      for (int i = 0; i < TK * KC / THREADS; ++i) {
        const int e = t + THREADS * i;
        ws[e / KC][e % KC] = wr[i];
      }
      __syncthreads();
      if (k0 + TK < p.d) fetch(k0 + TK);
      // a stage's products summed apart, then added to the total: at D
      // 500 a third of the rounding of one running sum
      float4 part = zero4();
#pragma unroll
      for (int k = 0; k < TK; ++k)
        fma4(hs[k][tr], *reinterpret_cast<const float4*>(&ws[k][4 * tq]),
             part);
      add4(acc, part);
    }
    const int r = r0 + tr, c = f0 + 4 * tq;
    if (r < p.rows && c < p.kp)
      *reinterpret_cast<float4*>(p.z + (long long)r * p.kp + c) = acc;
  }
}

// A warp walks entries [b, e) of one row at chunk column c0: lane group g
// takes entries g, g + 8, .. of each round of 64 (lanes load them two
// apiece, coalesced, and hand them out by shuffle), the next round's
// index loading while this round's rows arrive. The groups' sums are then
// added over the warp by xor shuffles: every group ends with the same
// bits, lane q holding columns c0 + 4q .. + 3.
template <bool kVec>
__device__ __forceinline__ float4 warp_walk(const Params& p, const Src& s,
                                            int b, int e, int c0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int c = c0 + 4 * q;
  float4 acc = zero4();
  auto index = [&](int k, int& u, float& a) {
    u = k < e ? __ldg(p.col + k) : -1;
    a = k < e ? __ldg(p.val + k) : 0.f;
  };
  int u0, u1;
  float a0, a1;
  index(b + lane, u0, a0);
  index(b + 32 + lane, u1, a1);
  for (int k0 = b; k0 < e; k0 += 64) {
    float4 x[8];
    float a[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int src = g + GROUPS * j;
      const int ua = __shfl_sync(kFull, u0, src);
      const int ub = __shfl_sync(kFull, u1, src);
      a[j] = __shfl_sync(kFull, a0, src);
      a[j + 4] = __shfl_sync(kFull, a1, src);
      x[j] = gather4<kVec>(s, ua, a[j], c);
      x[j + 4] = gather4<kVec>(s, ub, a[j + 4], c);
    }
    index(k0 + 64 + lane, u0, a0);
    index(k0 + 96 + lane, u1, a1);
#pragma unroll
    for (int j = 0; j < 8; ++j) fma4(a[j], x[j], acc);
  }
#pragma unroll
  for (int off = 4; off < 32; off *= 2) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  return acc;
}

// The 4 lanes of a group walk entries [b, e) of their own row, 8 rows of
// the source in flight; lane q holds columns c0 + 4q .. + 3.
template <bool kVec>
__device__ __forceinline__ float4 group_walk(const Params& p, const Src& s,
                                             int b, int e, int c0) {
  const int c = c0 + 4 * (threadIdx.x % 4);
  float4 acc = zero4();
  for (int k0 = b; k0 < e; k0 += 8) {
    float4 x[8];
    float a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = k0 + r;
      const int u = k < e ? __ldg(p.col + k) : -1;
      a[r] = k < e ? __ldg(p.val + k) : 0.f;
      x[r] = gather4<kVec>(s, u, a[r], c);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) fma4(a[r], x[r], acc);
  }
  return acc;
}

// Segment i of SEGMENTS of a block row's entries [b, e).
__device__ __forceinline__ void segment(int b, int e, int i, int& sb,
                                        int& se) {
  const int seg = (e - b + SEGMENTS - 1) / SEGMENTS;
  sb = min(e, b + i * seg);
  se = min(e, sb + seg);
}

// The project-first epilogue: act of the aggregate y (columns c .. c + 3)
// into out's row.
__device__ __forceinline__ void put4(const Params& p, int row, int c,
                                     const float4& y) {
  float* o = p.out + (long long)row * p.f;
  const float v[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c + i < p.f) o[c + i] = gnnk::activate(v[i], p.act);
}

// The aggregate-first epilogue: out's row (+)= agg (chunk c0 of the
// D-wide aggregate) . W[c0 .. c0 + 15, :], outputs t, t + step, ..; the
// last chunk applies act. Each output's sum runs in column order.
__device__ __forceinline__ void extract(const Params& p, int row, int c0,
                                        const float (&agg)[KC], int t,
                                        int step) {
  float* o = p.out + (long long)row * p.f;
  const int kc = min(KC, p.d - c0);
  const bool first = c0 == 0, last = c0 + KC >= p.d;
  for (int j = t; j < p.f; j += step) {
    const float* wc = p.w + (long long)c0 * p.f + j;
    float y = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < kc) y = fmaf(agg[c], __ldg(wc + (long long)c * p.f), y);
    if (!first) y = o[j] + y;
    o[j] = last ? gnnk::activate(y, p.act) : y;
  }
}

// Every lane of each group gets the group's 16 aggregate values.
__device__ __forceinline__ void all_gather(const float4& acc,
                                           float (&agg)[KC]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    agg[4 * q] = __shfl_sync(kFull, acc.x, q, 4);
    agg[4 * q + 1] = __shfl_sync(kFull, acc.y, q, 4);
    agg[4 * q + 2] = __shfl_sync(kFull, acc.z, q, 4);
    agg[4 * q + 3] = __shfl_sync(kFull, acc.w, q, 4);
  }
}

// One hub row for one warp (all lanes, warp-uniform). Rows of more than
// BLOCK_ENTRIES entries are summed by segments in segment order, as a
// block sums them.
template <bool kProject, bool kVec>
__device__ __forceinline__ void warp_row(const Params& p, const Src& s,
                                         int row) {
  int b, e;
  row_span(p.row_ptr, row, p.nnz, b, e);
  const int lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < s.k; c0 += KC) {
    float4 y;
    if (e - b > BLOCK_ENTRIES) {
      y = zero4();
      for (int i = 0; i < SEGMENTS; ++i) {
        int sb, se;
        segment(b, e, i, sb, se);
        add4(y, warp_walk<kVec>(p, s, sb, se, c0));
      }
    } else {
      y = warp_walk<kVec>(p, s, b, e, c0);
    }
    if (kProject) {
      if (lane < 4) put4(p, row, c0 + 4 * lane, y);
    } else {
      float agg[KC];
      all_gather(y, agg);
      extract(p, row, c0, agg, lane, 32);
    }
  }
}

// One hub row of more than BLOCK_ENTRIES entries for the whole block:
// warp i walks segment i, and the segments' sums are added in order.
template <bool kProject, bool kVec>
__device__ __forceinline__ void block_row(const Params& p, const Src& s,
                                          int row,
                                          float (&part)[SEGMENTS][KC],
                                          float (&sum)[KC]) {
  int b, e;
  row_span(p.row_ptr, row, p.nnz, b, e);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int sb, se;
  segment(b, e, warp, sb, se);
  for (int c0 = 0; c0 < s.k; c0 += KC) {
    const float4 y = warp_walk<kVec>(p, s, sb, se, c0);
    if (lane < 4) *reinterpret_cast<float4*>(&part[warp][4 * lane]) = y;
    __syncthreads();
    if (threadIdx.x < KC) {
      float v = 0.f;
      for (int i = 0; i < SEGMENTS; ++i) v += part[i][threadIdx.x];
      sum[threadIdx.x] = v;
    }
    __syncthreads();
    if (kProject) {
      if (threadIdx.x < KC && c0 + (int)threadIdx.x < p.f)
        p.out[(long long)row * p.f + c0 + threadIdx.x] =
            gnnk::activate(sum[threadIdx.x], p.act);
    } else if (warp == 0) {
      float agg[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) agg[c] = sum[c];
      extract(p, row, c0, agg, lane, 32);
    }
  }
}

// 8 consecutive rows from row0, one a lane group; rows of more than
// hub_min entries are the hub phases'.
template <bool kProject, bool kVec>
__device__ __forceinline__ void light_rows(const Params& p, const Src& s,
                                           int row0) {
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int row = row0 + lane / 4;
  int b = 0, e = 0;
  if (row < p.rows) row_span(p.row_ptr, row, p.nnz, b, e);
  const bool mine = row < p.rows && e - b <= p.hub_min;
  if (!mine) b = e = 0;
  for (int c0 = 0; c0 < s.k; c0 += KC) {
    const float4 y = group_walk<kVec>(p, s, b, e, c0);
    if (kProject) {
      if (mine) put4(p, row, c0 + 4 * q, y);
    } else {
      float agg[KC];
      all_gather(y, agg);  // every lane takes part
      if (mine) extract(p, row, c0, agg, q, 4);
    }
  }
}

// The hub list's row i, or -1 for an entry outside [0, rows) or a row
// of at most hub_min entries (the light phase's).
__device__ __forceinline__ int hub(const Params& p, int i, int& len) {
  const int row = p.hubs[i];
  len = 0;
  if (row < 0 || row >= p.rows) return -1;
  int b, e;
  row_span(p.row_ptr, row, p.nnz, b, e);
  len = e - b;
  return len > p.hub_min ? row : -1;
}

template <bool kProject, bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
fused_gnn_kernel(const Params p) {
  __shared__ float hs[TK][TR + 1];
  __shared__ __align__(16) float ws[TK][KC];
  __shared__ __align__(16) float part[SEGMENTS][KC];
  __shared__ float sum[KC];
  __shared__ int item;

  if (kProject) project(p, hs, ws);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.ctr[0] = p.ctr[1] = 0;
  cg::this_grid().sync();

  const Src s = kProject ? Src{p.z, p.rows, p.kp, p.f}
                         : Src{p.h, p.rows, p.d, p.d};
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // hub rows longer than BLOCK_ENTRIES, a block each, until the counter
  // hands out a shorter one: warp 0 takes that, and the block turns to
  // the warps' phase
  int carried = -1;
  for (;;) {
    __syncthreads();  // the last item's readers are done
    if (threadIdx.x == 0) item = atomicAdd(&p.ctr[0], 1);
    __syncthreads();
    const int i = item;
    if (i >= p.n_hubs) break;
    int len;
    const int row = hub(p, i, len);
    if (row < 0) continue;
    if (len > BLOCK_ENTRIES) {
      block_row<kProject, kVec>(p, s, row, part, sum);
      continue;
    }
    if (warp == 0) carried = i;
    break;
  }
  // the other hub rows, a warp each
  for (;;) {
    int i = carried;
    carried = -1;
    if (i < 0) {
      if (lane == 0) i = atomicAdd(&p.ctr[0], 1);
      i = __shfl_sync(kFull, i, 0);
    }
    if (i >= p.n_hubs) break;
    int len;
    const int row = hub(p, i, len);
    if (row >= 0) warp_row<kProject, kVec>(p, s, row);
  }
  // the rows of at most hub_min entries, 8 a warp
  const int items = (p.rows + GROUPS - 1) / GROUPS;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&p.ctr[1], 1);
    j = __shfl_sync(kFull, j, 0);
    if (j >= items) break;
    light_rows<kProject, kVec>(p, s, j * GROUPS);
  }
}

template <bool kProject, bool kVec>
int launch(const Params& p, cudaStream_t stream) {
  const void* kernel =
      reinterpret_cast<const void*>(&fused_gnn_kernel<kProject, kVec>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err == cudaSuccess) {
    void* args[] = {const_cast<Params*>(&p)};
    err = cudaLaunchCooperativeKernel(kernel, dim3(per_sm * sms),
                                      dim3(THREADS), args, 0, stream);
  }
  cudaGetLastError();  // clear a launch error; it is returned
  return (int)err;
}

}  // namespace

// row_ptr (rows + 1,), col (nnz,) int32, val (nnz,) float32 and hubs
// (n_hubs,) int32 (the rows of more than hub_min entries, longest first)
// from csr.linear_index; h the (rows, d) source matrix, w (d, f), out
// (rows, f). project (the wrapper's rule: d > f) selects the order;
// work is the workspace: (rows x kp) floats of Z when projecting first
// (kp = f rounded up to 4), then 2 ints. The wrapper checks shapes and
// types.
extern "C" int fused_gnn_launch(const int* row_ptr, const int* col,
                                const float* val, const int* hubs,
                                const float* h, const float* w, float* out,
                                float* work, int rows, int d, int f, int act,
                                int nnz, int n_hubs, int hub_min, int project,
                                cudaStream_t stream) {
  Params p{row_ptr, col, val, hubs, h, w, out, nullptr, nullptr,
           rows, d, f, 0, act, nnz, n_hubs, hub_min};
  if (project) {
    p.kp = (f + 3) / 4 * 4;
    p.z = work;
    p.ctr = reinterpret_cast<int*>(work + (long long)rows * p.kp);
    return launch<true, true>(p, stream);
  }
  p.ctr = reinterpret_cast<int*>(work);
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0)
    return launch<false, true>(p, stream);
  return launch<false, false>(p, stream);
}
