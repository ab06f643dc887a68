// Hand-written Hopper (sm_90a) forward attention on the tensor cores, bf16
// (src/repro_torch/kernels/flash_attention.py::flash_attention).
//
//   flash_attention_wgmma_kernel   replaces src/repro/kernels/
//                                  flash_attention.py::flash_attention_tpu
//                                  for bf16 at head dims 16, 32, 64, 80,
//                                  128 and 256
//
// q [b, tq, h, hd], k and v [b, tkv, kvh, hd] bf16 (the model's layout, read
// directly) -> o [b, tq, h, hd] bf16.  Query head i reads kv head
// i / (h / kvh).  Masks: causal (key <= query), sliding window
// (key > query - window) and the ragged end of the keys (key < tkv).  The
// softmax statistics are fp32: the running max starts at the finite
// NEG_INF = -1e30, a masked score is -inf and contributes p = 0, and the
// output is O / max(l, 1e-30), so a row with no live key gives zeros here
// (the wrapper then gives such rows the Pallas kernel's value).  fp32 goes
// to flash_attention_tf32x3.cu, other head dims to flash_attention.cu.  The
// plain PyTorch version is flash_attention.py::flash_attention_plain.
//
// What bounds it on an H100: operations.  At glm4_9b's widths (h = 32,
// kvh = 2, hd = 128, t = 4096, causal) the live score and value products
// are 1.37e11 FLOP, 139 us at the 989 TFLOP/s bf16 tensor-core rate,
// against 71 MB of HBM traffic (21 us at 3.35 TB/s).  So both products run
// on the tensor cores (wgmma, bf16 in, fp32 out), and the loads are kept
// off the threads that issue them (TMA into a ring of stages).  P is held
// as two bf16 terms (below), so the tensor cores do 1.5x the work that
// bound counts.
//
// Design.  One block per (128 query rows, head, batch), three warpgroups:
//   - a producer: one thread issues the TMA loads (Q once, then K and V
//     tiles into a ring of kStages stages, each with a "full" and an
//     "empty" mbarrier); the warpgroup gives its registers up (setmaxnreg);
//   - two consumers of 64 query rows each.  Per kv tile: S = Q K^T with
//     wgmma m64nNk16 (Q and K K-major in shared memory, 128-byte swizzle as
//     TMA writes it); the online softmax in registers, each row reduced
//     over the 4 threads of the accumulator fragment that share it; P
//     split into hi = bf16(p) and lo = bf16(p - hi) in the registers where
//     S was, which are already the layout of wgmma's register A operand
//     (the FlashAttention-3 arrangement); O += P_hi V + P_lo V with V the
//     MN-major B operand (the transpose bit).  bf16 P alone (2^-8) moves O
//     on rows with few live keys by more than the plain fp32 version's
//     tolerance; the two terms hold P to about 2^-16.  Masks are applied
//     only on tiles that cross the causal diagonal, the window edge or the
//     ragged end; a tile masked for all of a consumer's rows is skipped.
//     The two consumers' softmax and products interleave on their own.  A
//     form that issued tile n's S with tile n - 1's P V, to overlap the
//     softmax with it, spilled: ptxas gave every thread 168 registers
//     whether the consumers' setmaxnreg asked for 232 or 240.
// The block visits the kv tiles live for some of its rows (the Pallas
// kernel's block skip).  Shared memory holds 64-column chunks (128 bytes a
// row, the swizzle's width): Q [chunks][128 rows], each stage K and V
// [chunks][kKeys rows].  Tiles: 128 keys at hd <= 128 (Q 32 KB + 2 stages
// of 64 KB), 64 keys at hd = 256 (Q 64 KB + 2 stages of 64 KB).  hd = 80
// is stored as 128 and hd 16 / 32 as 64, with the dims past hd read as
// zeros (TMA's out-of-bounds fill); Q K^T runs hd / 16 k-steps and P V hd
// columns (m64n80 reads the second 64-column chunk of V in part, m64n16 /
// m64n32 the first).  TMA maps are 4-D (hd, heads, t, b), so
// rows past t read as zeros and no tile reads the next batch's rows.  The
// epilogue stages O through the consumer's own Q rows and writes 16-byte
// pieces of the rows below tq.  Blocks run head-major with the heaviest
// causal q tiles first.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the .so needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#include "tma_wgmma.cuh"

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileQ = 64 * kConsumers;            // query rows per block
constexpr int kStages = 2;                         // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tile {
  static constexpr int kHdp = (HD + 63) / 64 * 64;  // width in shared memory
  static constexpr int kChunks = kHdp / 64;         // 64-column chunks
  static constexpr int kKeys = kHdp > 128 ? 64 : 128;   // keys per kv tile
  static constexpr int kSteps = (HD + 15) / 16;     // k16 steps of Q K^T
  static constexpr int kN = (HD + 7) / 8 * 8;       // columns of P V
  static constexpr uint32_t kQChunk = kTileQ * 128;     // bytes
  static constexpr uint32_t kKvChunk = kKeys * 128;
  static constexpr uint32_t kQBytes = kQChunk * kChunks;
  static constexpr uint32_t kKvBytes = kKvChunk * kChunks;  // K (or V)
  static constexpr uint32_t kStageBytes = 2 * kKvBytes;
  static constexpr uint32_t kBarriers = kQBytes + kStages * kStageBytes;
  // + 1024 to align the base to the swizzle's 1024-byte pattern
  static constexpr uint32_t kSmem = 1024 + kBarriers + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi = bf16(a, b) and lo = bf16((a, b) - hi).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The wgmma instructions this kernel issues (bf16 in, fp32 accumulators).

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 80] (+)= A[64 x 16] B[16 x 80]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256]: A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
    int tq, int tkv, int h, int kvh, float scale, int causal, int window) {
  using T = Tile<HD>;
  constexpr int kKeys = T::kKeys;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);       // generic view of base
  const uint32_t q_s = base;                 // [chunk][kTileQ rows][128 B]
  const uint32_t kv_s = base + T::kQBytes;   // [stage][K, V][chunk][kKeys]
  const uint32_t q_full = base + T::kBarriers;
  const uint32_t full0 = q_full + 8;                    // full[s]: + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;          // empty[s]: + 8 s

  const int hi = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileQ;  // heaviest first
  const int bi = blockIdx.z;
  const int kvi = hi / (h / kvh);
  // The kv tiles live for some row of the block: [kv_lo, kv_hi).
  const int q_last = min(q0 + kTileQ, tq) - 1;
  const int kv_hi = causal ? min(tkv, q_last + 1) : tkv;
  const int kv_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kKeys * kKeys;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * T::kQChunk, &map_q, q_full, 64 * c, hi, q0, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = full0 + 8 * s;
        const uint32_t k_dst = kv_s + s * T::kStageBytes;
        const uint32_t v_dst = k_dst + T::kKvBytes;
        const int k0 = kv_lo + it * kKeys;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, T::kStageBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(k_dst + c * T::kKvChunk, &map_k, full, 64 * c, kvi, k0, bi);
          tma_load(v_dst + c * T::kKvChunk, &map_v, full, 64 * c, kvi, k0, bi);
        }
      }
    }
  } else {
    // Consumer g: query rows [r_lo, r_lo + 64) of the block.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int r_lo = q0 + 64 * g, r_hi = r_lo + 63;
    // Accumulator fragment: element i of an m64nN accumulator lies in row
    // row0 + 8 ((i >> 1) & 1) and column 8 (i / 4) + col0 + (i & 1).
    const int row0 = r_lo + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_wg = q_s + g * 64 * 128;  // its rows in each Q chunk
    const float sc = scale * kLog2e;

    float acc[T::kN / 2];
    float sco[kKeys / 2];
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) sco[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t k_src = kv_s + s * T::kStageBytes;
      const uint32_t v_src = k_src + T::kKvBytes;
      const int k0 = kv_lo + it * kKeys;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const bool skip = k0 >= tkv || (causal && k0 > r_hi) ||
                        (window > 0 && k0 + kKeys - 1 <= r_lo - window);
      if (!skip) {
        // S = Q K^T.
        keep(sco);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kSteps; ++kk) {
          const uint32_t off = (kk % 4) * 32;     // 16 columns = 32 bytes
          wgmma_ss(sco,
                   smem_desc(q_wg + (kk / 4) * T::kQChunk + off, 16, 1024),
                   smem_desc(k_src + (kk / 4) * T::kKvChunk + off, 16, 1024),
                   kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        keep(sco);

        const bool masked = k0 + kKeys > tkv ||
                            (causal && k0 + kKeys - 1 > r_lo) ||
                            (window > 0 && k0 <= r_hi - window);
        if (masked) {
#pragma unroll
          for (int i = 0; i < kKeys / 2; ++i) {
            const int key = k0 + 8 * (i / 4) + col0 + (i & 1);
            const int row = row0 + 8 * ((i >> 1) & 1);
            bool live = key < tkv;
            if (causal) live = live && key <= row;
            if (window > 0) live = live && key > row - window;
            if (!live) sco[i] = -INFINITY;
          }
        }
        // Online softmax in log2 units; m stays finite (NEG_INF at most).
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sco[i]);
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * sc);
          corr[r] = ex2(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int r = (i >> 1) & 1;
          sco[i] = ex2(fmaf(sco[i], sc, -m[r]));
          sum[r] += sco[i];
        }
        l[0] = l[0] * corr[0] + sum[0];
        l[1] = l[1] * corr[1] + sum[1];
#pragma unroll
        for (int i = 0; i < T::kN / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        // P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi).  The S
        // fragment of keys [16 kk, 16 kk + 16) is the A fragment of k-step
        // kk.
        uint32_t p_hi[kKeys / 16][4], p_lo[kKeys / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_bf16(sco[8 * kk + 2 * j], sco[8 * kk + 2 * j + 1],
                       p_hi[kk][j], p_lo[kk][j]);

        // O += P V.
        keep(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint64_t v_desc =
              smem_desc(v_src + kk * 16 * 128, T::kKvChunk, 1024);
          wgmma_rs(acc, p_hi[kk], v_desc, 1);
          wgmma_rs(acc, p_lo[kk], v_desc, 1);
        }
        wgmma_commit();
        wgmma_wait();
        keep(acc);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // Epilogue: O / max(l, 1e-30) in bf16, staged in the consumer's own Q
    // rows (16-byte units swizzled by row, as TMA lays them), then written
    // in 16-byte pieces to the rows below tq.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const uint32_t stage = g * 64 * 128;   // offset of its rows in a chunk
#pragma unroll
    for (int j = 0; j < T::kN / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        const uint32_t off = (j / 8) * T::kQChunk + stage + row * 128 +
                             ((j % 8) ^ (row % 8)) * 16 + 4 * (lane % 4);
        *reinterpret_cast<uint32_t*>(smem + off) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r],
                      acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    constexpr int kUnits = HD / 8;                // 16-byte pieces a row
    for (int e = tid; e < 64 * kUnits; e += 128) {
      const int row = e / kUnits, u = e % kUnits;
      if (r_lo + row >= tq) break;
      const uint32_t off = (u / 8) * T::kQChunk + stage + row * 128 +
                           ((u % 8) ^ (row % 8)) * 16;
      *reinterpret_cast<uint4*>(
          o + (((size_t)bi * tq + r_lo + row) * h + hi) * HD + 8 * u) =
          *reinterpret_cast<const uint4*>(smem + off);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tkv, int h, int kvh, float scale, int causal,
           int window, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap map_q, map_k, map_v;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = make_map(&map_q, kBf16, 2, q, b, tq, h, HD, 64, kTileQ);
  if (err == 0)
    err = make_map(&map_k, kBf16, 2, k, b, tkv, kvh, HD, 64, T::kKeys);
  if (err == 0)
    err = make_map(&map_v, kBf16, 2, v, b, tkv, kvh, HD, 64, T::kKeys);
  if (err != 0) return err;
  auto kern = flash_attention_wgmma_kernel<HD>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(h, (tq + kTileQ - 1) / kTileQ, b);
  kern<<<grid, kThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), tq, tkv, h, kvh,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q[b, tq, h, hd], k and v[b, tkv, kvh, hd] bf16 -> o[b, tq, h, hd] bf16,
// for hd in {16, 32, 64, 80, 128, 256}; h % kvh == 0 and 16-byte aligned,
// contiguous tensors (the wrapper checks).  Launches on `stream` of `device` and
// returns the cudaError_t of the launch (0 = queued).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, int b, int tq, int tkv, int h, int kvh,
                          int hd, float scale, int causal, int window,
                          int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || h <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (tkv <= 0)
    return (int)cudaMemsetAsync(o, 0, (size_t)b * tq * h * hd * 2, s);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, b, tq, tkv, h, kvh, scale, causal, window,
                        s);
    case 32:
      return launch<32>(q, k, v, o, b, tq, tkv, h, kvh, scale, causal, window,
                        s);
    case 64:
      return launch<64>(q, k, v, o, b, tq, tkv, h, kvh, scale, causal, window,
                        s);
    case 80:
      return launch<80>(q, k, v, o, b, tq, tkv, h, kvh, scale, causal, window,
                        s);
    case 128:
      return launch<128>(q, k, v, o, b, tq, tkv, h, kvh, scale, causal,
                         window, s);
    case 256:
      return launch<256>(q, k, v, o, b, tq, tkv, h, kvh, scale, causal,
                         window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
