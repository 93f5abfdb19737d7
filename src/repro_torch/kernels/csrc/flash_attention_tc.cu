// Flash attention on Hopper's tensor cores (bf16 in, f32 accumulate):
// out = softmax(q k^T * scale + mask) v with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the
// Pallas kernel with a (bq x bk) logit tile and a (bq x dh) f32 VMEM
// accumulator, walking Skv blockwise with a running max and denominator),
// for bfloat16 inputs with dh 64, 128 or 256. flash_attention.cu keeps
// float32 and the other head dims (the route is flash_attention.py::_route).
//
// Semantics, as the TPU kernel: q (B, Hq, Sq, dh), k and v (B, Hkv, Skv,
// dh), query head h reads kv head h / (Hq / Hkv) (GQA). Query row i sits
// at position qpos = Skv - Sq + i; a key at kpos is kept iff kpos <= qpos
// (causal) and kpos > qpos - window (window >= 0). Masked logits are
// -0.7 * FLT_MAX and their probabilities 0; the denominator is clamped at
// 1e-30, so a row with no key left gives 0. One difference: the TPU
// kernel multiplies V by float32 P (it casts v to float32 first, so its
// p.astype(v.dtype) keeps float32). Here P is rounded to bf16 before P V,
// because wgmma's A operand is bf16: the port's own choice, about 2^-9
// relative a probability, within the 5e-3 relative-norm gate; the
// denominator sums the f32 P.
//
// Bound on the card: operations; the kept (q, k) pairs need 4 * dh FLOP
// each, at 989 TFLOP/s of dense bf16. The LM prefill (B 4, Hq 32, Hkv 8,
// S 2048, dh 128, causal): 1.375e11 FLOP, 0.139 ms; q, k, v and out are
// 84 MB, 0.025 ms at 3.35 TB/s. recurrentgemma-2b's local attention (B 4,
// MQA 10/1, dh 256, window 2048, causal): S 1024 2.15e10 FLOP, 0.0217 ms
// (46 MB, 0.014 ms); S 2048 8.59e10, 0.0869 ms (92 MB, 0.028 ms); S 4096,
// where the window cuts the causal triangle, 2.58e11, 0.261 ms (185 MB).
//
// Design: one block owns 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows each and a producer (one warp, 288
// threads; at dh 256 a warpgroup, 384 threads), one block per SM. The
// grid is (ceil(Sq / 128), B * Hq) with the q tile index reversed, so
// the longest causal rows start first; the query heads that share a kv
// head (MQA's ten) are neighbours in the grid, so their K and V tiles
// come from L2 after the first read.
// - Copies: the producer's first thread loads the q tile once, then BN-row K
//   and V tiles into a 2-stage ring, all by TMA with 128-byte swizzle,
//   each completing on its own mbarrier; the consumers release a stage on
//   an "empty" mbarrier. The tensor maps are 3-D, (dh, S, B * H), so rows
//   past Sq or Skv read as zeros within their own head; Q's boxes are 128
//   rows, K's and V's BN.
// - BN is 128 at dh 64 and 128 (q 32 KB plus two stages of K and V 128
//   KB: 160 KB at dh 128). At dh 256 it is 64: two 128-row stages would
//   be 256 KB beside q's 64 KB, over the 227 KB a block may have, so q 64
//   KB + 2 x (K 32 KB + V 32 KB) = 192 KB. A tile's products are then as
//   large as dh 128's (64 x 64 x 256 multiply-adds a warpgroup for S, the
//   same for P V) and its softmax half as long. Splitting dh across the
//   two warpgroups instead would make each recompute or exchange S.
// - Registers at dh 256: O is 64 x 256 f32 a warpgroup, 128 a thread; S
//   32 and P 16 more. ptxas allocates registers by warpgroup, so 288
//   threads cap a thread at 168 as 384 do: there the products spilled
//   (528 bytes) and ran one at a time (ptxas C7512). So the producer is a
//   warpgroup that gives its registers away (setmaxnreg: 24 a producer
//   thread, 240 a consumer). -Xptxas -v: <256> 168 registers at entry
//   (before setmaxnreg), 0 bytes spilled; <128> 168 and <64> 140, 0.
// - S = Q K^T: wgmma m64n{BN}k16 from shared memory (Q and K both
//   K-major), dh / 16 k-steps, f32 accumulators in registers (BN / 2).
// - Online softmax in registers: a row is spread over the 4 threads of a
//   quad (2 columns of every 8), reduced with two shuffles; exp2f with
//   scale * log2(e) folded into the logits. Only tiles that touch the
//   causal diagonal, the ragged Skv tail or the window edge are masked;
//   tiles wholly before the window or after the diagonal are not loaded.
//   A row whose keys so far are all masked uses 0 as its max, so its
//   probabilities underflow to 0.
// - O += P V: P goes to bf16 in registers; the f32 accumulator layout of
//   the first product is the A-fragment layout of the second, so P is
//   the register A operand of wgmma m64n{dh}k16, with V from shared
//   memory, MN-major (the transpose bit), BN / 16 k-steps.
// - Epilogue: O / l to bf16, two columns per 32-bit store; rows at or
//   past Sq are not written.
// Not done here (later work): overlapping one warpgroup's softmax with
// the other's products by schedule (ping-pong), a persistent grid, fp8.
#include <cfloat>
#include <cstdint>

// CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run
// time through the runtime's entry-point query, so nothing extra is linked
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                    // q rows per block
constexpr int STAGES = 2;                  // K/V ring depth
constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int BOX_COLS = 64;               // bf16 columns in a 128-byte row
constexpr int ROW_BYTES = 128;             // one row of a box
// registers a thread after setmaxnreg (dh 256): 384 threads start at the
// 168 the launch bound allows; 128 x 24 + 256 x 240 = 65,536 - 1,024
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float MASKED = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory; every box (64 columns of BM or BN rows) starts on a
// 1024-byte boundary (the swizzle atom), which wgmma's descriptors (base
// offset 0) assume. kv tiles are 128 rows up to dh 128 and 64 at dh 256,
// where two stages of 128-row K and V (256 KB) beside Q (64 KB) would
// not fit the 227 KB a block may have: Q 64 + 2 x (32 + 32) = 192 KB.
template <int DH>
struct Smem {
  static constexpr int BN = DH > 128 ? 64 : 128;  // kv rows per tile
  static constexpr int BOXES = DH / BOX_COLS;
  static constexpr int Q_BOX = BM * ROW_BYTES;    // bytes of a Q box
  static constexpr int KV_BOX = BN * ROW_BYTES;   // of a K or V box
  // the producer: one warp, or at dh 256 a warpgroup that gives its
  // registers to the consumers (setmaxnreg works per warpgroup)
  static constexpr bool SHIFT_REGS = DH > 128;
  static constexpr int THREADS = CONSUMERS + (SHIFT_REGS ? 128 : 32);
  alignas(1024) uint8_t q[BOXES][Q_BOX];
  alignas(1024) uint8_t k[STAGES][BOXES][KV_BOX];
  alignas(1024) uint8_t v[STAGES][BOXES][KV_BOX];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
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

// One (64 columns x box rows x 1 head) box of a 3-D tensor map into
// shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. lbo/sbo in bytes: for
// K-major operands sbo is the stride between 8-row groups (lbo unused);
// for MN-major ones lbo is the stride between 64-column boxes along MN
// and sbo the stride between 8-row groups along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A B, A and B from shared memory
// (both K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d (64 x 64, f32) = (scale_d ? d : 0) + A B, A and B from shared memory
// (both K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-fragment layout, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-fragment layout, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, f32) += A B, A (64 x 16 bf16) from registers in the
// accumulator-fragment layout, B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int BN>
struct QK;  // S = Q K^T for a kv tile of BN rows
template <>
struct QK<128> {
  static __device__ __forceinline__ void mma(float (&s)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    wgmma_ss_n128(s, da, db, scale_d);
  }
};
template <>
struct QK<64> {
  static __device__ __forceinline__ void mma(float (&s)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    wgmma_ss_n64(s, da, db, scale_d);
  }
};

template <int DH>
struct PV;  // O += P V for this head dim
template <>
struct PV<256> {
  static __device__ __forceinline__ void mma(float (&o)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n256(o, a, db);
  }
};
template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&o)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n128(o, a, db);
  }
};
template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    wgmma_rs_n64(o, a, db);
  }
};

template <int DH>
__global__ void __launch_bounds__(Smem<DH>::THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ out, int hq, int hkv,
                          int sq, int skv, float scale_log2, int causal,
                          int window) {
  constexpr int BN = Smem<DH>::BN;
  constexpr int BOXES = Smem<DH>::BOXES;
  constexpr uint32_t Q_BYTES = BOXES * Smem<DH>::Q_BOX;
  constexpr uint32_t KV_BYTES = BOXES * Smem<DH>::KV_BOX;
  extern __shared__ uint8_t smem_raw[];
  Smem<DH>& sm = *reinterpret_cast<Smem<DH>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));

  const int bh = blockIdx.y;  // b * hq + h
  const int b = bh / hq, h = bh - b * hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int off = skv - sq;  // qpos of row i is off + i

  // kv tiles this block can see: keys at or before its last row's qpos
  // (causal), after its first row's qpos - window
  const int q_last = off + min(q0 + BM, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window >= 0 ? max(0, off + q0 - window + 1) : 0;
  const int kt0 = (k_begin / BN) * BN;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: thread CONSUMERS keeps the ring full
    if constexpr (Smem<DH>::SHIFT_REGS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    if (tid == CONSUMERS && n_tiles > 0) {
      mbar_expect_tx(&sm.q_full, Q_BYTES);
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
        tma_load(sm.q[c], &tq, &sm.q_full, c * BOX_COLS, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&sm.empty[s], (t / STAGES - 1) & 1);
        const int kt = kt0 + t * BN;
        mbar_expect_tx(&sm.k_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load(sm.k[s][c], &tk, &sm.k_full[s], c * BOX_COLS, kt, kvh);
        mbar_expect_tx(&sm.v_full[s], KV_BYTES);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load(sm.v[s][c], &tv, &sm.v_full[s], c * BOX_COLS, kt, kvh);
      }
    }
    return;
  }

  if constexpr (Smem<DH>::SHIFT_REGS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
  // consumer warpgroup wg owns block rows [64 wg, 64 wg + 64); this
  // thread holds rows r0 and r0 + 8 of them, columns 8 c + 2 (lane % 4)
  // and + 1 of every 8-column chunk c
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int r0 = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int qpos0 = off + q0 + r0;           // this thread's first row
  const int wg_first = off + q0 + wg * 64;   // the warpgroup's rows
  const int wg_last = wg_first + 63;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {MASKED, MASKED};  // running max, log2 domain
  float l[2] = {0.f, 0.f};        // this thread's part of the denominator

  if (n_tiles > 0) mbar_wait(&sm.q_full, 0);
  const uint64_t q_desc =
      smem_desc(sm.q[0] + wg * 64 * ROW_BYTES, 16, 1024);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const uint32_t parity = (t / STAGES) & 1;
    const int kt = kt0 + t * BN;

    // S = Q K^T
    float sc[BN / 2];
    mbar_wait(&sm.k_full[s], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = kk / 4, step = (kk % 4) * 32;  // box, bytes into row
      QK<BN>::mma(sc, q_desc + ((c * Smem<DH>::Q_BOX + step) >> 4),
                  smem_desc(sm.k[s][c], 16, 1024) + (step >> 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // logits in the log2 domain; mask only where a tile needs it
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
    const bool need_mask = kt + BN > skv || (causal && kt + BN - 1 > wg_first)
                           || (window >= 0 && kt <= wg_last - window);
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int qpos = qpos0 + 8 * ((i >> 1) & 1);
        const int kpos = kt + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
        const bool keep = kpos < skv && (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
        if (!keep) sc[i] = MASKED;
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], sc[i]);
    }
    float alpha[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with every key so far masked: exp2(MASKED - 0) is 0
      base[r] = mx[r] == MASKED ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }
    float rs[2] = {0.f, 0.f};
    uint32_t pa[BN / 4];  // P in bf16 pairs, the A fragments of P V
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(sc[i] - base[r]);
      const float p1 = exp2f(sc[i + 1] - base[r]);
      rs[r] += p0 + p1;
      const __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
      pa[i / 2] = *reinterpret_cast<const uint32_t*>(&pair);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V; k-step kk takes kv rows 16 kk .. 16 kk + 15, which are
    // accumulator chunks 2 kk and 2 kk + 1 of S: pairs 4 kk .. 4 kk + 3
    mbar_wait(&sm.v_full[s], parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      PV<DH>::mma(o, a,
                  smem_desc(sm.v[s][0], Smem<DH>::KV_BOX, 1024) +
                      ((kk * 16 * ROW_BYTES) >> 4));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int row = q0 + r0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dst = out + ((long long)bh * sq + row) * DH;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * c + 2 * r] * inv,
                                o[4 * c + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (dh, rows, heads) bf16 tensor, boxes of 64 columns x box_rows rows x
// 1 head, 128-byte swizzle; out-of-range rows read as zeros.
cudaError_t make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
                     int dh, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)rows * dh * 2};
  const cuuint32_t box[3] = {BOX_COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           int window, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  constexpr int BN = Smem<DH>::BN;
  cudaError_t err = make_map(encode, &tq, q, DH, sq, b * hq, BM);
  if (err == cudaSuccess)
    err = make_map(encode, &tk, k, DH, skv, b * hkv, BN);
  if (err == cudaSuccess)
    err = make_map(encode, &tv, v, DH, skv, b * hkv, BN);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(Smem<DH>) + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(flash_attention_tc_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BM - 1) / BM, b * hq);
  flash_attention_tc_kernel<DH><<<grid, Smem<DH>::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv,
      scale * LOG2E, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, out; dh 64, 128 or 256 (flash_attention.cu takes
// every other head dim, and float32); window < 0 means no window. The
// wrapper guarantees contiguous tensors with 16-byte aligned data,
// Hq % Hkv == 0, Sq, Skv >= 1 and B * Hq <= 65535.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int b,
                                         int hq, int hkv, int sq, int skv,
                                         int dh, float scale, int causal,
                                         int window, cudaStream_t stream) {
  if (dh == 256)
    return launch<256>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal,
                       window, stream);
  if (dh == 128)
    return launch<128>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal,
                       window, stream);
  if (dh == 64)
    return launch<64>(q, k, v, out, b, hq, hkv, sq, skv, scale, causal,
                      window, stream);
  return (int)cudaErrorInvalidValue;
}
