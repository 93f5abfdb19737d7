// Dense Engine: out = act(x @ w + b), float32, on the tensor cores at
// float32 accuracy (3xTF32).
//
// Replaces: src/repro/kernels/dense_engine.py::dense_engine_matmul (the
// Pallas kernel with (bm, bn, bk) tiles, an f32 VMEM accumulator and
// bias + activation on the last K step).
//
// Bound on the card: at the model's pool product (M = S*n = 19968,
// K = N = 500) operations: three TF32 passes of 2*M*N*K flops at
// 495 TFLOP/s; at the concat product (K = 1000, N = 16) bytes: the 80 MB
// of x at 3.35 TB/s.
//
// Precision: one TF32 pass keeps 10 mantissa bits, about 1e-3 relative
// at K = 500-1000. Each operand is split, hi = tf32(a) (rounded to
// nearest) and lo = a - hi cut to TF32, and the tensor cores sum
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (small terms first) into a fresh
// float32 sum per k8 step (mma.sync) or per 32-deep slice (wgmma),
// which is then added to the accumulator in float32. Chaining the
// tensor cores' own accumulation over all of K read a biased 7e-6
// relative error at K = 1000 on the card (as if each step rounded
// toward zero); with the fresh sums it reads 2e-7, close to float32's.
// Non-finite values: where hi is Inf or NaN, lo is 0, and the cross
// terms use a copy of hi that is 0 there (hs), so an Inf meets only the
// other operand's hi, as in the plain product: x*Inf stays +-Inf and
// 0*Inf gives NaN. Every K slice is multiplied; none is skipped.
//
// Design, N > 32 (the pool product): wgmma m64n128k8 TF32 from split
// planes in shared memory, in a persistent, warp-specialized kernel.
// A first pass splits w once per call into planes in device memory: for
// each 128-column tile and 32-deep K slice, hi, lo and hs, transposed
// to K-major (TF32 wgmma takes no MN-major operand) in wgmma's 128-byte
// swizzle, 48 KB ready for one bulk copy. The main kernel runs one
// block per SM over 128 x 128 output tiles (N tiles fastest, so blocks
// running together share rows of x through L2) with two stages of six
// 16 KB planes (x's and w's hi, lo, hs). Two producer warpgroups load x
// slices three ahead into registers, split them, store the three A
// planes and bulk-copy w's, signalling a full mbarrier; two consumer
// warpgroups (64 rows each) run the slice's twelve wgmma (four k8 steps
// of three terms) into a fresh sum, wait, release the stage on its
// empty mbarrier, and add the sum to their accumulator in float32;
// after the last slice they add the bias, apply the activation and
// store pairs of columns. The producers give registers to the consumers
// (setmaxnreg 72 / 184), which hold two 64-float sums a thread. Ragged
// M, N and K load as zeros.
// Design, N <= 32 (the concat product): mma.sync m16n8k8 (row.col,
// f32 += tf32 * tf32) from 32 x 16 blocks of two 16 x 16 warp tiles,
// where the job is streaming x (624 small blocks at Pubmed, all resident
// at once). Operands stream into a 3-stage shared-memory ring through
// cp.async (16 bytes a copy when K and N are multiples of 4 and the
// pointers 16-byte aligned, else 4), zero-filled out of range, one
// barrier per 64-deep K slice; x stays K-major and w N-major, padded so
// the fragment loads are conflict-free, and each warp splits its
// fragments in registers (each x element is read by one warp).
// Both add the bias and apply none / relu / gelu (tanh) / silu in the
// epilogue, before the one store.
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 4) from src to shared dst; zero-fill if !valid
// (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const float* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo in TF32; hs = hi where finite, else 0 (see the header).
// hi rounds a to nearest, ties away (cvt.rna.tf32's rounding), by integer
// ops on its bits: cvt runs at a quarter of the FP32 rate and would set
// the kernel's pace. lo = a - hi is exact in float32 and is cut to TF32.
struct Split {
  unsigned hi, lo, hs;
};

__device__ __forceinline__ Split split(float a) {
  const float r = __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
  // not finite: a itself, or a rounded past FLT_MAX
  const bool fin = fabsf(a) <= FLT_MAX && fabsf(r) <= FLT_MAX;
  const float hi = fin ? r : a;
  const float lo = fin ? a - r : 0.f;
  return {__float_as_uint(hi), __float_as_uint(lo) & 0xffffe000u,
          fin ? __float_as_uint(r) : 0u};
}

__device__ __forceinline__ void mma(float (&c)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block tile BM x BN, K slice BK, warp tile WM x WN, STAGES-deep ring.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
  static constexpr int AP = BK + 4;   // x row pitch: conflict-free frags
  static constexpr int BP = BN + 8;   // w row pitch: conflict-free frags
  static constexpr int A_FLOATS = BM * AP, B_FLOATS = BK * BP;
  static constexpr int SMEM = STAGES * (A_FLOATS + B_FLOATS) * 4;
};

using Narrow = Tile<32, 16, 64, 16, 16, 3>;   // 2 warps, 44,544 B smem

// Stage the (BM x BK) slice of x at (m0, k0) and the (BK x BN) slice of
// w at (k0, n0) into stage buffers sa / sb, zero outside M x K / K x N.
template <class T, bool kVec>
__device__ __forceinline__ void load_stage(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int m, int n, int k, int m0,
                                           int n0, int k0, float* sa,
                                           float* sb) {
  constexpr int V = kVec ? 4 : 1;
  for (int c = threadIdx.x; c < T::BM * T::BK / V; c += T::THREADS) {
    const int r = c / (T::BK / V), kk = (c % (T::BK / V)) * V;
    const bool ok = m0 + r < m && k0 + kk < k;
    cp_async<4 * V>(sa + r * T::AP + kk,
                    ok ? x + (long long)(m0 + r) * k + k0 + kk : x, ok);
  }
  for (int c = threadIdx.x; c < T::BK * T::BN / V; c += T::THREADS) {
    const int r = c / (T::BN / V), nn = (c % (T::BN / V)) * V;
    const bool ok = k0 + r < k && n0 + nn < n;
    cp_async<4 * V>(sb + r * T::BP + nn,
                    ok ? w + (long long)(k0 + r) * n + n0 + nn : w, ok);
  }
}

// acc += this warp's (WM x WN) share of the landed slice A (BM x BK) times
// B (BK x BN).
template <class T>
__device__ __forceinline__ void slice_mma(const float* A, const float* B,
                                          int wm, int wn, int g, int t,
                                          float (&acc)[T::MT][T::NT][4]) {
#pragma unroll
  for (int k8 = 0; k8 < T::BK; k8 += 8) {
    Split af[T::MT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) {
      const int o = (wm + 16 * i + g) * T::AP + k8 + t;
      af[i][0] = split(A[o]);                  // (g, t)
      af[i][1] = split(A[o + 8 * T::AP]);      // (g+8, t)
      af[i][2] = split(A[o + 4]);              // (g, t+4)
      af[i][3] = split(A[o + 8 * T::AP + 4]);  // (g+8, t+4)
    }
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      const int o = (k8 + t) * T::BP + wn + 8 * j + g;
      const Split b0 = split(B[o]);              // (t, g)
      const Split b1 = split(B[o + 4 * T::BP]);  // (t+4, g)
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        // the three products of this k8 step go into a fresh sum that
        // is added to acc in float32 (see the header's precision note)
        const Split* a = af[i];
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma(part, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hs, b1.hs);
        mma(part, a[0].hs, a[1].hs, a[2].hs, a[3].hs, b0.lo, b1.lo);
        mma(part, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
      }
    }
  }
}

template <class T, bool kVec>
__global__ void __launch_bounds__(T::THREADS)
dense_engine_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ out,
                    int m, int n, int k, int act) {
  extern __shared__ __align__(16) float smem[];
  float* sa = smem;                              // STAGES x A_FLOATS
  float* sb = smem + T::STAGES * T::A_FLOATS;    // STAGES x B_FLOATS

  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / (T::BN / T::WN)) * T::WM;  // warp tile origin
  const int wn = (warp % (T::BN / T::WN)) * T::WN;
  const int g = lane / 4, t = lane % 4;  // mma groupID, thread in group

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int kt_count = (k + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < kt_count)
      load_stage<T, kVec>(x, w, m, n, k, m0, n0, s * T::BK,
                          sa + s * T::A_FLOATS, sb + s * T::B_FLOATS);
    cp_async_commit();
  }

  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<T::STAGES - 2>();  // slice kt has landed (this thread)
    __syncthreads();                 // ... for all threads; slice kt-1 done
    {
      const int next = kt + T::STAGES - 1;
      const int s = next % T::STAGES;
      if (next < kt_count)
        load_stage<T, kVec>(x, w, m, n, k, m0, n0, next * T::BK,
                            sa + s * T::A_FLOATS, sb + s * T::B_FLOATS);
      cp_async_commit();
    }
    slice_mma<T>(sa + (kt % T::STAGES) * T::A_FLOATS,
                 sb + (kt % T::STAGES) * T::B_FLOATS, wm, wn, g, t, acc);
  }
  cp_async_wait<0>();

  // epilogue: acc[i][j] holds rows g, g + 8 and columns 2t, 2t + 1 of
  // the (16 x 8) tile (i, j)
#pragma unroll
  for (int i = 0; i < T::MT; ++i) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm + 16 * i + g + 8 * (q / 2);
        const int col = n0 + wn + 8 * j + 2 * t + (q % 2);
        if (row < m && col < n) {
          float y = acc[i][j][q];
          if (b != nullptr) y += b[col];
          out[(long long)row * n + col] = gnnk::activate(y, act);
        }
      }
    }
  }
}

template <class T, bool kVec>
int launch_tile(const float* x, const float* w, const float* b, float* out,
                int m, int n, int k, int act, cudaStream_t stream) {
  // dynamic shared memory above 48 KB needs this opt-in (per device)
  const cudaError_t err = cudaFuncSetAttribute(
      dense_engine_kernel<T, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN);
  dense_engine_kernel<T, kVec><<<grid, T::THREADS, T::SMEM, stream>>>(
      x, w, b, out, m, n, k, act);
  return (int)cudaGetLastError();
}

template <class T>
int launch(const float* x, const float* w, const float* b, float* out, int m,
           int n, int k, int act, cudaStream_t stream) {
  const bool vec = k % 4 == 0 && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return vec ? launch_tile<T, true>(x, w, b, out, m, n, k, act, stream)
             : launch_tile<T, false>(x, w, b, out, m, n, k, act, stream);
}

// ---------------------------------------------------------------------
// N > 32: wgmma from split planes, persistent and warp-specialized
// ---------------------------------------------------------------------
namespace wide {

constexpr int BM = 128, BN = 128, BK = 32;  // output tile, K slice
constexpr int CONSUMERS = 256;              // two warpgroups: 64 rows each
constexpr int PRODUCERS = 256;              // two warpgroups split x
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int XV = BM * BK / 4 / PRODUCERS;  // float4s of x a producer splits
// registers a thread: producers give theirs up to the consumers, which
// hold two 64-float sums (setmaxnreg; 65,536 in all)
constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 184;
constexpr int PLANE = 128 * BK * 4;         // 128 rows x 128 B: 16 KB
// a stage holds A (x) hi, lo, hs then B (w transposed) hi, lo, hs
constexpr int A_HI = 0, A_LO = 1, A_HS = 2, B_HI = 3, B_LO = 4, B_HS = 5;
constexpr int B_BYTES = 3 * PLANE;
constexpr int STAGE = 6 * PLANE;
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE + 1024 + 64;  // + 1 KB alignment, barriers

// Byte offset of (row r, k) in a plane: K-major, 128 B a row, 16-byte
// chunks swizzled within each 8-row, 1 KB atom (wgmma's 128B swizzle).
__device__ __forceinline__ int swz(int r, int k) {
  return (r >> 3) * 1024 + (r & 7) * 128 + ((((k >> 2) ^ r) & 7) << 4) +
         (k & 3) * 4;
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: 1 KB
// between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= (uint64_t)(16 >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= 1ull << 62;
  return d;
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A B, both TF32 from shared
// memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving reads or writes of the sums across the
// asynchronous products.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global src to shared dst in one bulk copy; completes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// w split once per call: for every (N tile nb, K slice kt) its three
// planes (hi, lo, hs; 48 KB, zero past K x N), transposed to K-major in
// the swizzled layout, ready for one bulk copy per slice.
__global__ void __launch_bounds__(256)
split_w(const float* __restrict__ w, char* __restrict__ planes, int n, int k,
        int kt_count) {
  // one 16-byte chunk (4 k of one n) a thread: 4 blocks per slice
  const int slice = blockIdx.x / 4;
  const int kt = slice % kt_count, nb = slice / kt_count;
  const int e = (blockIdx.x % 4) * 256 + threadIdx.x;
  const int nl = e % BN, k4 = (e / BN) * 4;  // reads along n
  const int nn = nb * BN + nl;
  unsigned hi[4], lo[4], hs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kk = kt * BK + k4 + j;
    const Split sp = split(kk < k && nn < n ? w[(long long)kk * n + nn] : 0.f);
    hi[j] = sp.hi;
    lo[j] = sp.lo;
    hs[j] = sp.hs;
  }
  char* dst = planes + (long long)slice * B_BYTES + swz(nl, k4);
  *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(dst + PLANE) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
  *reinterpret_cast<uint4*>(dst + 2 * PLANE) =
      make_uint4(hs[0], hs[1], hs[2], hs[3]);
}

// This producer thread's XV float4s of the (BM x BK) slice of x at
// (m0, k0): rows c / 8, k 4 (c % 8) for c = p + PRODUCERS i; zero
// outside.
template <bool kVec>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int m,
                                       int k, int m0, int k0, int p,
                                       float4 (&v)[XV]) {
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int c = p + PRODUCERS * i;
    const int row = m0 + c / 8, kk = k0 + (c % 8) * 4;
    const float* src = x + (long long)row * k + kk;
    if (kVec) {
      v[i] = row < m && kk < k ? __ldg(reinterpret_cast<const float4*>(src))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      const bool ok = row < m;
      v[i] = make_float4(ok && kk < k ? __ldg(src) : 0.f,
                         ok && kk + 1 < k ? __ldg(src + 1) : 0.f,
                         ok && kk + 2 < k ? __ldg(src + 2) : 0.f,
                         ok && kk + 3 < k ? __ldg(src + 3) : 0.f);
    }
  }
}

// Split the slice into the stage's three A planes.
__device__ __forceinline__ void store_x(char* stage, int p,
                                        const float4 (&v)[XV]) {
#pragma unroll
  for (int i = 0; i < XV; ++i) {
    const int c = p + PRODUCERS * i;
    const int off = swz(c / 8, (c % 8) * 4);
    const Split sx = split(v[i].x), sy = split(v[i].y), sz = split(v[i].z),
                sw = split(v[i].w);
    *reinterpret_cast<uint4*>(stage + A_HI * PLANE + off) =
        make_uint4(sx.hi, sy.hi, sz.hi, sw.hi);
    *reinterpret_cast<uint4*>(stage + A_LO * PLANE + off) =
        make_uint4(sx.lo, sy.lo, sz.lo, sw.lo);
    *reinterpret_cast<uint4*>(stage + A_HS * PLANE + off) =
        make_uint4(sx.hs, sy.hs, sz.hs, sw.hs);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const float* __restrict__ x, const char* __restrict__ wplanes,
       const float* __restrict__ b, float* __restrict__ out, int m, int n,
       int k, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);  // the producers (+ B's bytes)
      mbar_init(&empty[s], 2);   // one thread of each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = n_tiles * ((m + BM - 1) / BM);
  const int kt_count = (k + BK - 1) / BK;
  // tiles in N-fastest order, so the blocks running at once share rows
  // of x through L2; slice q of this block's sequence uses stage q % 2

  if (tid >= CONSUMERS) {
    // producer: x slices split into the A planes, loaded three slices
    // ahead into three register sets (slice q into set q % 3, so the
    // loop runs in threes and the sets stay registers); w's planes
    // (split once per call) by bulk copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int p = tid - CONSUMERS;
    const int my_tiles =
        blockIdx.x < tiles ? (tiles - blockIdx.x - 1) / gridDim.x + 1 : 0;
    const int nq = my_tiles * kt_count;  // this block's slices
    auto load = [&](int q, float4 (&v)[XV]) {
      const int tile = blockIdx.x + (q / kt_count) * gridDim.x;
      load_x<kVec>(x, m, k, (tile / n_tiles) * BM, (q % kt_count) * BK, p,
                   v);
    };
    auto step = [&](int q, float4 (&v)[XV]) {
      const int tile = blockIdx.x + (q / kt_count) * gridDim.x;
      const int s = q % STAGES;
      mbar_wait(&empty[s], ((q / STAGES) & 1) ^ 1);
      char* stage = smem + s * STAGE;
      store_x(stage, p, v);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (p == 0) {
        mbar_expect_tx(&full[s], B_BYTES);
        bulk_copy(stage + B_HI * PLANE,
                  wplanes + ((long long)(tile % n_tiles) * kt_count +
                             q % kt_count) * B_BYTES,
                  B_BYTES, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
      if (q + 3 < nq) load(q + 3, v);
    };
    float4 v0[XV], v1[XV], v2[XV];
    if (nq > 0) load(0, v0);
    if (nq > 1) load(1, v1);
    if (nq > 2) load(2, v2);
    for (int q = 0; q < nq; q += 3) {
      step(q, v0);
      if (q + 1 < nq) step(q + 1, v1);
      if (q + 2 < nq) step(q + 2, v2);
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid / 128;
  const int lane = tid % 32;
  float acc[64], part[64];
  int q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * BM;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < kt_count; ++kt, ++q) {
      const int s = q % STAGES;
      mbar_wait(&full[s], (q / STAGES) & 1);
      const uint32_t base = smem_addr(smem + s * STAGE);
      // the twelve products of this slice, small terms first in each k8
      // step, into a fresh sum; A is this warpgroup's 64 rows (8 KB)
      fence_regs(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t a = base + wg * (PLANE / 2) + kk * 32;
        const uint32_t bb = base + kk * 32;
        wgmma_tf32(part, desc(a + A_LO * PLANE), desc(bb + B_HS * PLANE),
                   kk > 0);
        wgmma_tf32(part, desc(a + A_HS * PLANE), desc(bb + B_LO * PLANE), 1);
        wgmma_tf32(part, desc(a + A_HI * PLANE), desc(bb + B_HI * PLANE), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(part);
      if (tid % 128 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    // epilogue: acc[4c + 2r + e] is row 16 (warp % 4) + lane / 4 + 8 r
    // of this warpgroup's 64, column 8 c + 2 (lane % 4) + e
    const int r0 = m0 + wg * 64 + 16 * ((tid / 32) % 4) + lane / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= m) continue;
      float* o = out + (long long)row * n;
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        const int col = n0 + 8 * c + 2 * (lane % 4);
        float y0 = acc[4 * c + 2 * r], y1 = acc[4 * c + 2 * r + 1];
        if (b != nullptr) {
          if (col < n) y0 += b[col];
          if (col + 1 < n) y1 += b[col + 1];
        }
        y0 = gnnk::activate(y0, act);
        y1 = gnnk::activate(y1, act);
        if (col + 1 < n && n % 2 == 0) {  // 8-byte aligned pair
          *reinterpret_cast<float2*>(o + col) = make_float2(y0, y1);
        } else {
          if (col < n) o[col] = y0;
          if (col + 1 < n) o[col + 1] = y1;
        }
      }
    }
  }
}

// wplanes: ceil(n / 128) * ceil(k / 32) * 48 KB of scratch (the wrapper
// allocates it).
int launch(const float* x, const float* w, const float* b, void* wplanes,
           float* out, int m, int n, int k, int act, cudaStream_t stream) {
  const int kt_count = (k + BK - 1) / BK;
  const int n_tiles = (n + BN - 1) / BN;
  if (kt_count > 0) {
    split_w<<<n_tiles * kt_count * 4, 256, 0, stream>>>(
        w, static_cast<char*>(wplanes), n, k, kt_count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const void* fn = vec ? reinterpret_cast<const void*>(kernel<true>)
                       : reinterpret_cast<const void*>(kernel<false>);
  // dynamic shared memory above 48 KB needs this opt-in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles = n_tiles * ((m + BM - 1) / BM);
  const int grid = tiles < sms ? tiles : sms;  // persistent: one per SM
  if (vec)
    kernel<true><<<grid, THREADS, SMEM, stream>>>(
        x, static_cast<const char*>(wplanes), b, out, m, n, k, act);
  else
    kernel<false><<<grid, THREADS, SMEM, stream>>>(
        x, static_cast<const char*>(wplanes), b, out, m, n, k, act);
  return (int)cudaGetLastError();
}

}  // namespace wide

}  // namespace

// scratch: the split planes of w for N > 32 (wide::launch says how
// large), unused for N <= 32. The wrapper checks shapes and types.
extern "C" int dense_engine_launch(const float* x, const float* w,
                                   const float* b, void* scratch, float* out,
                                   int m, int n, int k, int act,
                                   cudaStream_t stream) {
  return n <= 32 ? launch<Narrow>(x, w, b, out, m, n, k, act, stream)
                 : wide::launch(x, w, b, scratch, out, m, n, k, act, stream);
}
