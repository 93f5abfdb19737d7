// Flash attention: out = softmax(q k^T * scale + mask) v, online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas kernel with a (bq x bk) logit tile and a (bq x dh) f32 VMEM
// accumulator, walking Skv blockwise with a running max and denominator),
// for float32 at any head dim up to 256 and for bfloat16 at head dims
// other than 64, 128 and 256; bfloat16 at those goes to
// flash_attention_tc.cu (flash_attention.py::_route).
//
// Semantics, as the TPU kernel: q (B, Hq, Sq, dh), k and v (B, Hkv, Skv,
// dh), Hq % Hkv == 0 and query head h reads kv head h / (Hq / Hkv) (GQA).
// Query row i sits at position qpos = Skv - Sq + i. A key at kpos is kept
// iff kpos <= qpos (causal) and kpos > qpos - window (window >= 0). Masked
// logits are -0.7 * FLT_MAX and their probabilities 0; the denominator is
// clamped at 1e-30, so a row with no key left gives 0. Arithmetic is
// float32; inputs are float32 or bfloat16 and the output has their type.
//
// Bound on the card: at the LM prefill shape (B 4, Hq 32, Hkv 8, S 2048,
// dh 128, causal) the work is 4 * dh FLOP per kept (q, k) pair, 1.4e11
// FLOP against 84 MB of q, k, v and out, so operations bound it. This
// kernel does them in float32 FMA on the CUDA cores, not on the tensor
// cores, so it sits far above the bf16 tensor-core bound.
//
// Design: one 256-thread block owns one (batch * head, 64-row q tile); the
// grid is (ceil(Sq / 64), B * Hq). The q tile stays in shared memory; the
// block walks kv tiles of 64 rows: K into shared memory, S = q k^T with a
// 4x4 sub-tile per thread (rows ty + 16i, columns tx + 16j), mask, running
// max and denominator (a thread's rows are its own, reduced over the 16
// threads of a half-warp with shuffles), P into shared memory, then V into
// the same buffer K used and O += P V with a 4 x (MAX_DH / 16) accumulator
// per thread in registers. kv tiles wholly above the causal diagonal or
// wholly before the window are skipped; the ragged tails of Sq, Skv and dh
// are masked, so no length has to be a multiple of 64.
//
// The kernel is a template on the largest head dim it takes: MAX_DH 128
// (dh <= 128: 32 accumulators a thread, two blocks an SM) and MAX_DH 256
// (128 < dh <= 256, e.g. recurrentgemma's MQA at dh 256 in float32: 64
// accumulators a thread, one block an SM; shared memory (64 + 64) * 257
// * 4 + 64 * 65 * 4 = 148 KB of the 227 KB a block may have).
#include <cfloat>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int MAX_DH_SMALL = 128;
constexpr int MAX_DH_LARGE = 256;
constexpr float MASKED = -0.7f * FLT_MAX;

enum Dtype : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [row0, row0 + 64) (BQ == BK) of a (len, dh) row-major matrix into
// dst (row stride ld) as float32; rows at or past len are zero.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int row0,
                                          int len, int dh, float* dst,
                                          int ld) {
  for (int idx = threadIdx.x; idx < BK * dh; idx += THREADS) {
    const int r = idx / dh, c = idx - r * dh;
    const int row = row0 + r;
    dst[r * ld + c] =
        row < len ? to_f32(src[(long long)row * dh + c]) : 0.f;
  }
}

// Max (or sum) over the 16 threads that share a row group (one half-warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <typename T, int MAX_DH>
__global__ void __launch_bounds__(THREADS, MAX_DH <= MAX_DH_SMALL ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int skv, int dh, float scale,
                       int causal, int window) {
  constexpr int DC = MAX_DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  const int ld = dh + 1;       // odd row stride: column reads hit 16 banks
  float* qs = smem;            // [BQ][ld]
  float* kv = qs + BQ * ld;    // [BK][ld]: K, then V of the same tile
  float* ps = kv + BK * ld;    // [BQ][BK + 1]

  const int bh = blockIdx.y;   // b * hq + h
  const int b = bh / hq, h = bh - (bh / hq) * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (long long)bh * sq * dh;
  const T* kp = k + (long long)kvh * skv * dh;
  const T* vp = v + (long long)kvh * skv * dh;

  const int t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;
  const int off = skv - sq;    // qpos of row i is off + i

  // kv range this tile can see: keys kpos <= the last row's qpos (causal)
  // and kpos > the first row's qpos - window
  const int q_last = off + min(q0 + BQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window >= 0 ? max(0, off + q0 - window + 1) : 0;

  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  load_tile(qp, q0, sq, dh, qs, ld);

  for (int kt = (k_begin / BK) * BK; kt < k_end; kt += BK) {
    __syncthreads();  // the previous tile's P V is done with kv and ps
    load_tile(kp, kt, skv, dh, kv, ld);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kv[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = off + q0 + ty + 16 * i;
      bool keep[4];
      float row_max = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + tx + 16 * j;
        keep[j] = kpos < skv && (!causal || kpos <= qpos) &&
                  (window < 0 || kpos > qpos - window);
        s[i][j] = keep[j] ? s[i][j] * scale : MASKED;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        row_sum += p;
        ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }

    __syncthreads();  // everyone is done reading K
    load_tile(vp, kt, skv, dh, kv, ld);
    __syncthreads();  // V and P are in place

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float vv = kv[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* dst = out + ((long long)bh * sq + row) * dh;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) store(dst + col, o[i][c] / denom);
    }
  }
}

template <typename T, int MAX_DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int dh, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(BQ + BK) * (dh + 1) + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, MAX_DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, MAX_DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, dh,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int b,
              int hq, int hkv, int sq, int skv, int dh, float scale,
              int causal, int window, cudaStream_t stream) {
  if (dh <= MAX_DH_SMALL)
    return launch<T, MAX_DH_SMALL>(q, k, v, out, b, hq, hkv, sq, skv, dh,
                                   scale, causal, window, stream);
  return launch<T, MAX_DH_LARGE>(q, k, v, out, b, hq, hkv, sq, skv, dh,
                                 scale, causal, window, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; window < 0 means no window. The wrapper
// guarantees contiguous tensors, Hq % Hkv == 0, 1 <= dh <= 256 and
// B * Hq <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int hq,
                                      int hkv, int sq, int skv, int dh,
                                      float scale, int causal, int window,
                                      int dtype, cudaStream_t stream) {
  if (dh < 1 || dh > MAX_DH_LARGE) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16)
    return launch_dh<__nv_bfloat16>(q, k, v, out, b, hq, hkv, sq, skv, dh,
                                    scale, causal, window, stream);
  if (dtype == kFloat32)
    return launch_dh<float>(q, k, v, out, b, hq, hkv, sq, skv, dh, scale,
                            causal, window, stream);
  return (int)cudaErrorInvalidValue;
}
