// Graph Engine gather/scatter aggregation for non-linear reductions.
//
// Replaces: src/repro/kernels/seg_gather.py::seg_gather_aggregate (the
// Pallas kernel that walks each shard pair's padded COO list, gathers
// source rows and scatter-reduces max or sum into an (n x B) block).
//
// Bound on the card: bytes. Each valid edge moves one D-wide source row
// (4*D bytes) and does D comparisons or adds; the padded edge lists
// (9 bytes a slot) and h itself are read once. There is no arithmetic
// intensity to speak of.
//
// Design: grid (S_dst, ceil(D/32)), one warp per block. The block keeps
// its destination shard's (n x 32) accumulator in dynamic shared memory
// (64 KB at n = 512), and lane l owns feature column d0 + l. The warp
// walks the source shards and their edge slots in order, 32 slots at a
// time: each lane loads one slot, a ballot finds the valid ones, and the
// warp applies them in order, the slot's (src, dst) broadcast by shuffle
// and the source row read coalesced. Every accumulator cell has one
// owner and a fixed update order, so there are no atomics and the result
// is deterministic. With three such warps per SM the walk is latency
// bound, so loads are issued ahead: the slot metadata of four chunks
// before any is used, and the source rows of up to four valid edges
// before any is applied. Padding slots cost one ballot per 32.
// max starts from -3e38 and writes 0 where no edge arrived (acc <= -1.5e38),
// as the TPU kernel does; sum starts from 0.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GD = 32;     // feature columns per block = lanes of the warp
constexpr int CHUNKS = 4;  // 32-slot chunks whose metadata load together
constexpr int ROWS = 4;    // source rows in flight before they are applied
constexpr float kNegIdentity = -3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(GD)
seg_gather_kernel(const int* __restrict__ esrc, const int* __restrict__ edst,
                  const uint8_t* __restrict__ evalid,
                  const float* __restrict__ h, float* __restrict__ out,
                  int s_src, int n, int e, int d, int is_max) {
  extern __shared__ float acc[];  // (n, GD)
  const int i = blockIdx.x;
  const int lane = threadIdx.x;
  const int col = blockIdx.y * GD + lane;
  const bool live = col < d;
  const float ident = is_max ? kNegIdentity : 0.f;
  for (int v = 0; v < n; ++v) acc[v * GD + lane] = ident;
  for (int j = 0; j < s_src; ++j) {
    const long long base = ((long long)i * s_src + j) * e;
    const float* hj = h + (long long)j * n * d;
    for (int e0 = 0; e0 < e; e0 += CHUNKS * GD) {
      bool ok[CHUNKS];
      int src[CHUNKS], dst[CHUNKS];
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int slot = e0 + c * GD + lane;
        const bool in = slot < e;
        ok[c] = in && evalid[base + slot] != 0;
        src[c] = in ? esrc[base + slot] : 0;
        dst[c] = in ? edst[base + slot] : 0;
      }
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        unsigned mask = __ballot_sync(kFull, ok[c]);
        while (mask) {  // warp-uniform
          float x[ROWS];
          int v[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            v[r] = -1;
            x[r] = 0.f;
            if (mask) {
              const int b = __ffs(mask) - 1;
              mask &= mask - 1;
              const int u = __shfl_sync(kFull, src[c], b);
              v[r] = __shfl_sync(kFull, dst[c], b);
              // out-of-range ids are dropped, like the reference scatter
              const bool use = live && u >= 0 && u < n && v[r] >= 0 &&
                               v[r] < n;
              x[r] = use ? hj[(long long)u * d + col] : 0.f;
              if (!use) v[r] = -1;
            }
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (v[r] < 0) continue;
            float& a = acc[v[r] * GD + lane];
            a = is_max ? fmaxf(a, x[r]) : a + x[r];
          }
        }
      }
    }
  }
  if (!live) return;
  float* o = out + (long long)i * n * d;
  for (int v = 0; v < n; ++v) {
    float a = acc[v * GD + lane];
    if (is_max && a <= 0.5f * kNegIdentity) a = 0.f;
    o[(long long)v * d + col] = a;
  }
}

}  // namespace

extern "C" int seg_gather_launch(const int* esrc, const int* edst,
                                 const uint8_t* evalid, const float* h,
                                 float* out, int s_dst, int s_src, int n,
                                 int e, int d, int is_max,
                                 cudaStream_t stream) {
  const size_t smem = (size_t)n * GD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      seg_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(s_dst, (d + GD - 1) / GD);
  seg_gather_kernel<<<grid, GD, smem, stream>>>(esrc, edst, evalid, h, out,
                                                s_src, n, e, d, is_max);
  return (int)cudaGetLastError();
}
