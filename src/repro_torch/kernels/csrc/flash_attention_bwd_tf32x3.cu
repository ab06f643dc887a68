// Hand-written Hopper (sm_90a) backward of attention on the tensor cores,
// fp32 as three TF32 products (src/repro_torch/kernels/flash_attention.py::
// flash_attention_bwd): the gradients dq, dk and dv of the forward that
// flash_attention_tf32x3.cu computes.  bf16 goes to
// flash_attention_bwd_wgmma.cu, whose shape this kernel keeps.
//
// It replaces no TPU kernel: the JAX package's Pallas attention
// (src/repro/kernels/flash_attention.py::flash_attention_tpu) is forward
// only, and XLA differentiates the plain pair-list attention on the
// reference's training path.  Its plain PyTorch twin is
// flash_attention.py::flash_attention_bwd_plain.
//
// With S = Q K^T, P = exp(scale S - LSE), LSE each row's log-sum-exp that
// the forward kernel wrote (its kLse instance), four launches:
//   attn_bwd_prep        D = rowsum(dO o O), fp32 [b, h, tq]
//                        (flash_attention_bwd_prep.cuh)
//   attn_bwd_dkdv_kernel one block per (64 keys, kv head, split of its GQA
//                        group, batch): over the split's query heads and
//                        their live q tiles, dV += P^T dO and
//                        dK += dS^T Q with dS = P o (dP - D), as fp32
//                        partials a split
//   attn_bwd_dkdv_sum    dk = scale * the partials' sum, dv the sum
//                        (flash_attention_bwd_prep.cuh)
//   attn_bwd_dq_kernel   one block per (q tile, head, batch): over the live
//                        kv tiles, dQ += dS K; dq = scale dQ
// No atomics: every sum is taken in one order, so a call gives the same
// bits on every run.  Masks: causal (key <= query), a sliding window
// (key > query - window), ragged tq and tkv.  GQA: query head i reads kv
// head i / (h / kvh).  A row with no live key has no gradient: the wrapper
// raises before the launch.
//
// What bounds it on an H100: operations.  At glm4_9b's widths (b 2, t 4096,
// h 32, kvh 2, hd 128, causal) the live pairs need 5 products of hd-long
// rows (S, dP, dV, dK, dQ), 0.69 TFLOP; keeping dQ out of atomics costs S
// and dP twice (7 products, 0.97 TFLOP).  One TF32 pass keeps 11 bits of
// each operand and misses the fp32 tolerance (chip_smoke.py's BWD_TOL
// 1e-4 of each gradient's largest entry; tests/test_torch_flash_backward.py
// holds an emulation of both on the CPU), so every product runs as 3xTF32
// (tf32_convert.cuh): a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, each term
// an m64nNk8 .tf32 wgmma with fp32 accumulators; 3 x 0.97 TFLOP at the 495
// TFLOP/s TF32 rate is 5.9 ms (the bound, from the 5 products: 4.2 ms).
//
// What the .tf32 form changes against the bf16 kernel:
//   - B is K-major only (no transpose bit), and so is an A operand in
//     shared memory.  The first products, S^T = K Q^T and dP^T = V dO^T
//     (dK/dV) or S = Q K^T and dP = dO V^T (dQ), have both operands K-major
//     as TMA writes them (128-byte swizzle, 32 fp32 columns a row): A_hi B
//     and A_hi B_lo read A and B from shared memory (the tensor core reads
//     an fp32 operand's hi term), A_lo B from registers, A_lo split from A
//     two k8 steps at a time, two groups in flight (`product3`).  The
//     second products, dV += P^T dO, dK += dS^T Q and dQ += dS K, take A
//     (P^T, dS^T, dS) from the registers of the accumulator it was formed
//     in, split into hi and lo there, and their B (dO, Q, K) is MN-major
//     as stored: the producer's converter warps write it transposed, as
//     dOt / dOt_lo, Qt / Qt_lo and Kt / Kt_lo, its rows in the order the
//     register fragment's k index wants (tf32_convert.cuh), as the
//     forward's converters write Vt.  (The other way, each such product
//     computed transposed with the MN-major operand split into registers
//     as A and P^T / dS^T written to shared memory as the K-major B,
//     needs the same lo copies of Q and dO for the first products and
//     moves the accumulators to M = hd rows; it was not built.)
//   - The lo terms of B (Q_lo, dO_lo; K_lo, V_lo) are converted copies in
//     the stage beside the TMA tiles.
//   - Tiles are twice bf16's size and lo copies double them, so shared
//     memory sets the tiles (below).  ptxas gives each thread of a
//     384-thread block 168 registers whatever setmaxnreg asks (PERF.md §6;
//     352 threads too), and the converters need more than a producer's
//     24, so no warpgroup asks: every accumulator, fragment and A_lo group
//     fits 168.
//
// dK/dV: keys are M, 64 a block (the FlashAttention-3 arrangement).  The
// producer's first thread loads the block's K and V once and then, for
// each query head of the split and each live q tile of kQ rows, Q and dO
// into a ring of stages; its last three warps, the converters, write each
// stage's Q_lo, dO_lo, Qt, Qt_lo, dOt, dOt_lo and its rows' LSE (log2
// units, +inf past tq, so P = 0 there) and D.  The dV consumer computes
// S^T, P^T = ex2(S^T scale log2e - LSE log2e) (masked), hands P^T to the
// dK consumer through the stage (fp32, an mbarrier; in Q_lo's bytes, dead
// once its S^T has read them, where they fit) and accumulates dV; the dK
// consumer computes dP^T, dS^T = P^T o (dP^T - D) and accumulates dK.  The
// accumulators stay in registers for the whole block and are written
// once, as fp32 partials over splits of the GQA group (`splits`, the most
// that keeps the grid within four waves); the grid runs the heaviest kv
// tiles first.  Past W 128 each consumer makes passes over the items, 96
// columns of its accumulator each (two at W 160-192, three at 224-256;
// S^T and dP^T again in each), and the converters transpose only the
// pass's columns.  kQ is the most of 64, 32, 16 for which two stages fit,
// else one stage of 16:
//     W     kQ  stages  K+V KB  stage KB   (stage: Q, dO, Q_lo, dO_lo,
//     16    64    2       16       64      transposes, P^T where it is
//     32    64    2       16       80      not in Q_lo)
//     64    32    2       32       64
//     80    32    2       48       88
//     96-128 16   2    48-64    48-64
//     160   16    2       80       64
//     192   16    1       96       72
//     224   16    1      112       80
//     256   16    1      128       88      (217.2 KB of the 227)
// Each call's second product is formed in zeroed accumulators and added
// to the block's in registers (round to nearest): the tensor cores
// truncate each addition to an fp32 accumulator, and thousands of q tiles
// added into one accumulator biased dk and dv past BWD_TOL.
// dQ: queries are M, the forward's arrangement.  The producer loads the
// block's Q and dO once and the live kv tiles of kKeys keys into a ring;
// the converters write each stage's K_lo, V_lo, Kt, Kt_lo.  A consumer
// reads its rows' LSE and D once, computes S and dP, P and dS as above,
// and dQ += dS Kt.  Up to W 128 each consumer takes 64 of the block's 128
// rows; past it both take its 64 rows and split dQ's columns, [0, W / 2)
// and [W / 2, W), consumer 0 computing S and P and consumer 1 dP and dS,
// each handed to the other through the stage.  kKeys 32 up to W 64 (2
// stages), 16 above (2 stages to W 160, one at W 192-256: Q + dO 96-128
// KB, a stage 72-96 KB).  dq is written in fp32 from the accumulators.
// Masks are applied only on tiles that cross the causal diagonal, the
// window edge or a ragged end; a tile with no live pair for a consumer's
// rows is skipped.  Widths: the kernel is built for the forward's padded
// widths W (TF32_WIDTHS) and runs head dim hd, a multiple of 4, at the
// smallest W >= hd (columns hd..W-1 zeros in shared memory, TMA's
// out-of-bounds fill, and so in every lo copy and transpose; only columns
// below hd stored); the wrapper zero-pads any other hd and passes the
// scale of the real one.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the .so needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#include "tma_wgmma.cuh"
#include "wgmma_tf32.cuh"
#include "tf32_convert.cuh"
#include "flash_attention_bwd_prep.cuh"

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConverters = 96;      // producer threads preparing the stages
constexpr uint32_t kMaxSmem = 232448;              // one block's, bytes
constexpr float kLog2e = 1.4426950408889634f;

// The widths the kernel is built for, the forward's
// (flash_attention.py::TF32_WIDTHS).
#define TF32_WIDTHS 16, 32, 64, 80, 96, 112, 128, 160, 192, 224, 256

// The shape of width W shared by the two kernels.
template <int W>
struct Width {
  static constexpr int kHdp = (W + 31) / 32 * 32;   // width in shared memory
  static constexpr int kChunks = kHdp / 32;         // 32-column chunks
  // Past W 128 an accumulator of W columns does not fit a thread's
  // registers: dK/dV cut it into passes of kPassN columns (the last pass
  // what is left; passes of 128 or of W / 2 spilled 8-156 bytes at W
  // 160-256), dQ between its two consumers.
  static constexpr bool kSplit = W > 128;
  static constexpr int kPassN = !kSplit ? W : 96;
  static constexpr int kPasses = (W + kPassN - 1) / kPassN;
  __host__ __device__ static constexpr int pass_n(int pass) {
    return W - pass * kPassN < kPassN ? W - pass * kPassN : kPassN;
  }
};

// dK / dV with stages of Q query rows: the block's 64 keys (K, V), then
// per stage Q, dO (TMA), Q_lo, dO_lo, Qt, Qt_lo, dOt, dOt_lo (converted; a
// transpose holds the pass's kTRows columns) and P^T (in Q_lo where it
// fits), then per stage the rows' LSE and D, then the mbarriers.
template <int W, int Q>
struct DkdvShape : Width<W> {
  using B = Width<W>;
  static constexpr int kQ = Q;
  static constexpr uint32_t kKChunk = 64 * 128;          // bytes
  static constexpr uint32_t kKBytes = kKChunk * B::kChunks;    // K or V
  static constexpr uint32_t kQChunk = Q * 128;
  static constexpr uint32_t kQBytes = kQChunk * B::kChunks;    // Q, dO, lo
  static constexpr int kTRows = B::kPassN;
  static constexpr uint32_t kTBytes = kTRows * Q * 4;    // a transpose
  static constexpr uint32_t kPBytes = 64 * Q * 4;
  static constexpr bool kPtInQlo = kQBytes >= kPBytes;
  static constexpr uint32_t kDo = kQBytes, kQlo = 2 * kQBytes;
  static constexpr uint32_t kDoLo = 3 * kQBytes, kQt = 4 * kQBytes;
  static constexpr uint32_t kQtLo = kQt + kTBytes, kDot = kQt + 2 * kTBytes;
  static constexpr uint32_t kDotLo = kQt + 3 * kTBytes;
  static constexpr uint32_t kPt = kPtInQlo ? kQlo : kQt + 4 * kTBytes;
  static constexpr uint32_t kStageBytes =
      kQt + 4 * kTBytes + (kPtInQlo ? 0 : kPBytes);
  // + 1024 to align the base to the swizzle's 1024-byte pattern; kv_full,
  // then full, ready, empty and p_full of each stage
  static constexpr uint32_t smem(int stages) {
    return 1024 + 2 * kKBytes + stages * (kStageBytes + 2 * Q * 4) +
           8 * (1 + 4 * stages);
  }
};

template <int W>
constexpr int dkdv_rows() {
  return DkdvShape<W, 64>::smem(2) <= kMaxSmem   ? 64
         : DkdvShape<W, 32>::smem(2) <= kMaxSmem ? 32
                                                 : 16;
}

template <int W>
struct DkdvTile : DkdvShape<W, dkdv_rows<W>()> {
  using S = DkdvShape<W, dkdv_rows<W>()>;
  static constexpr int kStages = S::smem(2) <= kMaxSmem ? 2 : 1;
  static constexpr uint32_t kStats = 2 * S::kKBytes + kStages * S::kStageBytes;
  static constexpr uint32_t kBarriers = kStats + kStages * 2 * S::kQ * 4;
  static constexpr uint32_t kSmem = S::smem(kStages);
  static_assert(kSmem <= kMaxSmem, "shared memory of one block");
  static_assert(S::kStageBytes % 1024 == 0, "stages on the swizzle pattern");
};

// dQ with stages of kKeys keys: the block's kRows query rows (Q, dO), then
// per stage K, V (TMA), K_lo, V_lo, Kt, Kt_lo (converted), then the
// mbarriers.
template <int W, int kKeys_>
struct DqShape : Width<W> {
  using B = Width<W>;
  static constexpr int kKeys = kKeys_;
  static constexpr int kRows = B::kSplit ? 64 : 64 * kConsumers;
  static constexpr uint32_t kQChunk = kRows * 128;       // bytes
  static constexpr uint32_t kQBytes = kQChunk * B::kChunks;    // Q or dO
  static constexpr uint32_t kKChunk = kKeys * 128;
  static constexpr uint32_t kKBytes = kKChunk * B::kChunks;    // K, V, lo
  static constexpr uint32_t kTBytes = W * kKeys * 4;     // Kt or Kt_lo
  static constexpr uint32_t kV = kKBytes, kKlo = 2 * kKBytes;
  static constexpr uint32_t kVlo = 3 * kKBytes, kKt = 4 * kKBytes;
  static constexpr uint32_t kKtLo = kKt + kTBytes;
  static constexpr uint32_t kStageBytes = kKt + 2 * kTBytes;
  // q_full, then full, ready and empty of each stage
  static constexpr uint32_t smem(int stages) {
    return 1024 + 2 * kQBytes + stages * kStageBytes + 8 * (1 + 3 * stages);
  }
};

template <int W>
constexpr int dq_keys() {
  return DqShape<W, 32>::smem(2) <= kMaxSmem ? 32 : 16;
}

template <int W>
struct DqTile : DqShape<W, dq_keys<W>()> {
  using S = DqShape<W, dq_keys<W>()>;
  static constexpr int kStages = S::smem(2) <= kMaxSmem ? 2 : 1;
  static constexpr uint32_t kBarriers = 2 * S::kQBytes + kStages * S::kStageBytes;
  static constexpr uint32_t kSmem = S::smem(kStages);
  static_assert(kSmem <= kMaxSmem, "shared memory of one block");
  static_assert(S::kStageBytes % 1024 == 0, "stages on the swizzle pattern");
};

// x = A B^T over the W / 8 k8 steps of width W, as 3xTF32: A the 64 rows
// at a_s (K-major, chunks of a_chunk bytes; a_gen the same rows, generic),
// B and B_lo at b_s and blo_s (N = 2 R rows K-major, chunks of b_chunk).
// A_hi B and A_hi B_lo with both operands in shared memory, then A_lo B
// with A_lo split from A, two steps a group, two groups in flight: the
// fragment of step kk is (rows 16 warp + gq + 8 (e & 1), column
// 8 kk + tg + 4 (e >> 1)) for e = 0 ... 3.  kUnroll: the 32-column chunks
// unrolled kUnroll at a time (0: all).  Returns with every product
// complete.
template <int W, int kUnroll = 0, int R>
__device__ __forceinline__ void product3(float (&x)[R], uint32_t a_s,
                                         const uint8_t* a_gen,
                                         uint32_t a_chunk, uint32_t b_s,
                                         uint32_t blo_s, uint32_t b_chunk,
                                         int warp, int gq, int tg) {
  constexpr int kChunks = (W + 31) / 32;
  // steps of chunk c: 4, or what W leaves of its last (W 80, 112)
  auto steps = [](int c) { return W / 8 - 4 * c < 4 ? W / 8 - 4 * c : 4; };
  // Descriptors: the first step's, the address field advanced by a step's
  // offset (in 16-byte units; no carry: shared memory < 256 KB).
  const uint64_t a0 = smem_desc(a_s, 16, 1024), b0 = smem_desc(b_s, 16, 1024);
  const uint64_t bl0 = smem_desc(blo_s, 16, 1024);
  // A's rows gq and gq + 8 of this warp's 16: step k4 of a chunk reads its
  // 16-byte units 2 k4 and 2 k4 + 1, swizzled by the row (gq)
  const uint8_t* const a_row = a_gen + (16 * warp + gq) * 128 + 4 * tg;
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = 0.f;
  keep(x);
  wgmma_fence();
#pragma unroll(kUnroll ? kUnroll : kChunks)
  for (int c = 0; c < kChunks; ++c) {
    const uint64_t ac = a0 + ((c * a_chunk) >> 4);
    const uint64_t bc = b0 + ((c * b_chunk) >> 4);
    const uint64_t blc = bl0 + ((c * b_chunk) >> 4);
#pragma unroll
    for (int k4 = 0; k4 < steps(c); ++k4) {
      wgmma_ss(x, ac + 2 * k4, bc + 2 * k4, 1);
      wgmma_ss(x, ac + 2 * k4, blc + 2 * k4, 1);
    }
  }
  wgmma_commit();
  uint32_t lo[2][2][4];
#pragma unroll(kUnroll ? kUnroll : kChunks)
  for (int c = 0; c < kChunks; ++c) {
    const uint64_t bc = b0 + ((c * b_chunk) >> 4);
    const uint8_t* const a_c = a_row + c * a_chunk;
#pragma unroll
    for (int g = 0; g < 2; ++g) {          // the chunk's two groups
      if (2 * g >= steps(c)) break;
      if (c > 0) wgmma_wait<1>();          // buffer g's last group is done
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k4 = 2 * g + j;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = *reinterpret_cast<const float*>(
              a_c + 1024 * (e & 1) + (((2 * k4 + (e >> 1)) ^ gq) << 4));
          lo[g][j][e] = __float_as_uint(v - tf32_hi(v));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) wgmma_rs(x, lo[g][j], bc + 2 * (2 * g + j), 1);
      wgmma_commit();
    }
  }
  wgmma_wait();
  keep(x);
}

// Descriptor of k8 step kk of a transposed tile at `addr` of kKeys keys a
// row (t_unit's layout, t_rows rows), from row n0 on.
template <int kKeys>
__device__ __forceinline__ uint64_t t_desc(uint32_t addr, int kk, int n0,
                                           int t_rows) {
  if constexpr (kKeys == 16)
    return smem_desc(addr + n0 * 64 + kk * 32, 16, 512, 2);
  else
    return smem_desc(addr + (kk / 4) * t_rows * 128 + n0 * 128 + (kk % 4) * 32,
                     16, 1024);
}

// part (=) A B as 3xTF32 for B's 2 P rows from row n0 (t_desc), A the
// register fragments (hi, lo) of kK / 8 k8 steps; committed and waited for.
template <int kK, int P>
__device__ __forceinline__ void product3_part(float (&part)[P],
                                              uint32_t (&a_hi)[kK / 8][4],
                                              uint32_t (&a_lo)[kK / 8][4],
                                              uint32_t t_s, uint32_t tlo_s,
                                              int n0, int t_rows) {
#pragma unroll
  for (int i = 0; i < P; ++i) part[i] = 0.f;
  keep(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk) {
    const uint64_t bt = t_desc<kK>(t_s, kk, n0, t_rows);
    wgmma_rs(part, a_hi[kk], bt, 1);
    wgmma_rs(part, a_hi[kk], t_desc<kK>(tlo_s, kk, n0, t_rows), 1);
    wgmma_rs(part, a_lo[kk], bt, 1);
  }
  wgmma_commit();
  wgmma_wait();
  keep(part);
}

// acc[P0, kR) += A B as 3xTF32, A the register fragments (hi, lo) of
// kK / 8 k8 steps, B the transposed tile at t_s and its lo terms at tlo_s,
// rows from n0 on.  The tensor cores truncate each addition to an fp32
// accumulator (toward zero), which over the thousands of q tiles a dK/dV
// block adds into one accumulator biased dk and dv by ~3e-4 of their
// largest entry (PERF.md §6): so each call's product is formed in zeroed
// accumulators of at most kPart registers (2 kPart columns), each added
// to acc here, rounded to nearest.
template <int kK, int kPart, int kR, int P0 = 0, int R>
__device__ __forceinline__ void product3_rs(float (&acc)[R],
                                            uint32_t (&a_hi)[kK / 8][4],
                                            uint32_t (&a_lo)[kK / 8][4],
                                            uint32_t t_s, uint32_t tlo_s,
                                            int n0, int t_rows) {
  static_assert(kR <= R, "the accumulator's registers");
  constexpr int kP = kR - P0 < kPart ? kR - P0 : kPart;
  float part[kP];
  product3_part<kK>(part, a_hi, a_lo, t_s, tlo_s, n0 + 2 * P0, t_rows);
#pragma unroll
  for (int i = 0; i < kP; ++i) acc[P0 + i] += part[i];
  if constexpr (P0 + kP < kR)
    product3_rs<kK, kPart, kR, P0 + kP>(acc, a_hi, a_lo, t_s, tlo_s, n0,
                                        t_rows);
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// The two consumers of a dK/dV block share its 64 keys and each q tile:
// the dV consumer computes S^T and P^T, hands P^T to the dK consumer
// through the stage, and accumulates dV; the dK consumer computes dP^T,
// dS^T from that P^T, and accumulates dK.
enum Role { kDv = 0, kDk = 1 };

// A stage for both consumers of item `it` (pass `pass`), by converter
// thread `ctid`: Q_lo, dO_lo, the pass's columns of Q and dO transposed
// (Qt, Qt_lo, dOt, dOt_lo), and the rows' LSE in log2 units (+inf past tq)
// and D.
template <int W>
__device__ __forceinline__ void convert_dkdv(const Params& p, uint8_t* st,
                                             float* stats, int pass, int q0,
                                             size_t row, int ctid) {
  using T = DkdvTile<W>;
  lo_tile(st, st + T::kQlo, T::kQBytes, ctid, kConverters);
  lo_tile(st + T::kDo, st + T::kDoLo, T::kQBytes, ctid, kConverters);
  const int c0 = pass * T::kPassN, rows = min(T::kPassN, W - c0);
  transpose_tile<T::kQ>(st, st + T::kQt, st + T::kQtLo, c0, rows, T::kTRows,
                        ctid, kConverters);
  transpose_tile<T::kQ>(st + T::kDo, st + T::kDot, st + T::kDotLo, c0, rows,
                        T::kTRows, ctid, kConverters);
  for (int rr = ctid; rr < T::kQ; rr += kConverters) {
    const int q = q0 + rr;
    stats[rr] = q < p.tq ? p.lse[row + q] * kLog2e : INFINITY;
    stats[T::kQ + rr] = q < p.tq ? p.dsum[row + q] : 0.f;
  }
}

// A dK/dV block's place: kv tile j (the slowest index: heaviest causal
// tiles first), then batch, kv head and split; its 64 keys from k0, the
// query heads of its split from head0, and the q tiles of kQ rows live for
// some key, [t_lo, t_lo + n_q): an item is one of them for one head, in
// each pass.  Each pass reads %ctaid afresh (volatile), so that none of
// it lives across a pass in registers (past W 128 ptxas spilled such
// values around the items' loop).
struct DkdvBlock {
  int bi, kvi, split, head0, n_heads, k0, t_lo, n_q, n_items;
  __device__ __forceinline__ DkdvBlock(const Params& p, int kQ) {
    uint32_t block;
    asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(block));
    const int per_tile = p.b * p.kvh * p.splits;
    const int j = block / per_tile;
    int r = block % per_tile;
    bi = r / (p.kvh * p.splits);
    r %= p.kvh * p.splits;
    kvi = r / p.splits;
    split = r % p.splits;
    const int g = p.h / p.kvh, gs = g / p.splits;
    head0 = kvi * g + split * gs;
    n_heads = p.fault == kOneHead ? (split == 0 ? 1 : 0) : gs;
    k0 = j * 64;
    const int q_lo = p.causal ? max(0, k0 - diag(p)) : 0;
    const int q_end = p.window > 0 ? min(p.tq, k0 + 63 + p.window) : p.tq;
    t_lo = q_lo / kQ;
    n_q = q_end > q_lo ? (q_end + kQ - 1) / kQ - t_lo : 0;
    n_items = n_heads * n_q;
  }
};

// Pass `pass` of consumer `role` over the block's items: N columns from
// column kPassN pass on, accumulated in the first N / 2 registers of acc
// (one array for every pass) and written as the split's fp32 partials at
// the end.  `smem` is the block's shared memory (generic),
// `base` its address, `bars` its first mbarrier.
template <int W, int N, int kRole, int R>
__device__ __forceinline__ void dkdv_pass(const Params& p, uint8_t* smem,
                                          uint32_t base, uint32_t bars,
                                          int pass, int tid, float (&acc)[R],
                                          float* __restrict__ parts) {
  using T = DkdvTile<W>;
  constexpr int kQ = T::kQ, kStages = T::kStages;
  const DkdvBlock blk(p, kQ);
  const int n = blk.n_items, it0 = pass * n, n_q = blk.n_q;
  const int t_lo = blk.t_lo, k0 = blk.k0;
  const uint32_t full0 = bars + 8, ready0 = full0 + 8 * kStages;
  const uint32_t empty0 = ready0 + 8 * kStages;
  const uint32_t p_full0 = empty0 + 8 * kStages;
  const uint32_t a_off = kRole == kDv ? 0 : T::kKBytes;   // K or V
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tg = lane % 4;
  // Accumulator fragment: element i of an m64nN accumulator lies in row
  // key0 + 8 ((i >> 1) & 1) and column 8 (i / 4) + 2 tg + (i & 1).
  const int key0 = k0 + 16 * warp + gq;
  const float sc = p.scale * kLog2e;
  float x[kQ / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int it = it0; it < it0 + n; ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const uint32_t st = 2 * T::kKBytes + s * T::kStageBytes;   // offset
    const int qa = (t_lo + (it - it0) % n_q) * kQ;
    const float* const stats =
        reinterpret_cast<const float*>(smem + T::kStats) + s * 2 * kQ;
    float2* const pt = reinterpret_cast<float2*>(smem + st + T::kPt) + tid;
    mbar_wait(ready0 + 8 * s, par);
    const bool live = any_live(p, qa, kQ, k0, 64);
    if (live)
      product3<W>(x, base + a_off, smem + a_off, T::kKChunk,
                  base + st + (kRole == kDv ? 0 : T::kDo),
                  base + st + (kRole == kDv ? T::kQlo : T::kDoLo),
                  T::kQChunk, warp, gq, tg);
    // The P^T hand-over: the dV consumer arrives on every item, live or
    // not, once P^T is stored; the dK consumer waits on every item.
    if (kRole == kDk) mbar_wait(p_full0 + 8 * s, par);
    // The accumulator product's A fragments: k-step kk's (queries 8 kk ...
    // 8 kk + 7, k index t for query 8 kk + 2 t, t + 4 for 8 kk + 2 t + 1)
    // is (x[4 kk], x[4 kk + 2], x[4 kk + 1], x[4 kk + 3]).
    uint32_t a_hi[kQ / 8][4], a_lo[kQ / 8][4];
    if (live) {
      const bool edge = kRole == kDv && !all_live(p, qa, kQ, k0, 64);
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * kk + 2 * r, cq = 8 * kk + 2 * tg;
          float v0, v1;
          if (kRole == kDv) {
            v0 = ex2(fmaf(x[i], sc, -stats[cq]));
            v1 = ex2(fmaf(x[i + 1], sc, -stats[cq + 1]));
            if (edge) {
              const int key = key0 + 8 * r;
              if (!live_pair(p, qa + cq, key)) v0 = 0.f;
              if (!live_pair(p, qa + cq + 1, key)) v1 = 0.f;
            }
            pt[(2 * kk + r) * 128] = make_float2(v0, v1);
          } else {
            const float2 pp = pt[(2 * kk + r) * 128];
            v0 = pp.x * (x[i] - stats[kQ + cq]);
            v1 = pp.y * (x[i + 1] - stats[kQ + cq + 1]);
          }
          split_tf32(v0, a_hi[kk][r], a_lo[kk][r]);
          split_tf32(v1, a_hi[kk][2 + r], a_lo[kk][2 + r]);
        }
      }
    }
    if (kRole == kDv) mbar_arrive(p_full0 + 8 * s);
    // dV += P^T dOt or dK += dS^T Qt, in one part (1.5 % faster than in
    // parts of 64 columns at glm4_9b).
    if (live)
      product3_rs<kQ, 64, N / 2>(acc, a_hi, a_lo,
                      base + st + (kRole == kDv ? T::kDot : T::kQt),
                      base + st + (kRole == kDv ? T::kDotLo : T::kQtLo), 0,
                      T::kTRows);
    mbar_arrive(empty0 + 8 * s);
  }

  // The split's partials, fp32 [2, splits, b, tkv, kvh, hd]: dK, then dV;
  // this thread's two rows (keys key0, key0 + 8) from its first column.
  const size_t size = (size_t)p.b * p.tkv * p.kvh * p.hd;
  const int col0 = T::kPassN * pass + 2 * tg;
  float* const row = parts +
                     ((kRole == kDk ? 0 : (size_t)p.splits) + blk.split) *
                         size +
                     (((size_t)blk.bi * p.tkv + key0) * p.kvh + blk.kvi) *
                         p.hd + col0;
  const size_t next = (size_t)8 * p.kvh * p.hd;     // key0 + 8's row
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i >> 1) & 1, dc = 8 * (i / 4);
    if (key0 + 8 * r < p.tkv && col0 + dc < p.hd)
      *reinterpret_cast<float2*>(row + r * next + dc) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// Consumer `role`'s passes: one over all of W, or two past W 128 (columns
// [0, 128), then [128, W)), each over all the block's items.
template <int W, int kRole>
__device__ __forceinline__ void dkdv_consume(const Params& p, uint8_t* smem,
                                             uint32_t base, uint32_t bars,
                                             int tid,
                                             float* __restrict__ parts) {
  using T = DkdvTile<W>;
  float acc[T::kPassN / 2];
  dkdv_pass<W, T::pass_n(0), kRole>(p, smem, base, bars, 0, tid, acc, parts);
  if constexpr (T::kPasses > 1)
    dkdv_pass<W, T::pass_n(1), kRole>(p, smem, base, bars, 1, tid, acc,
                                      parts);
  if constexpr (T::kPasses > 2)
    dkdv_pass<W, T::pass_n(2), kRole>(p, smem, base, bars, 2, tid, acc,
                                      parts);
  static_assert(T::kPasses <= 3, "passes");
}

// TMA maps over q, dO (boxes of kQ rows), k and v (boxes of 64).
template <int W>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, float* __restrict__ parts,
    const Params p) {
  using T = DkdvTile<W>;
  constexpr int kQ = T::kQ, kStages = T::kStages;
  constexpr int kPasses = T::kPasses;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);       // generic view of base
  const uint32_t bars = base + T::kBarriers;   // kv_full, then per stage
  const uint32_t kv_full = bars;
  const uint32_t full0 = bars + 8, ready0 = full0 + 8 * kStages;
  const uint32_t empty0 = ready0 + 8 * kStages;
  const uint32_t p_full0 = empty0 + 8 * kStages;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kConverters);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
      mbar_init(p_full0 + 8 * s, 128);      // the dV consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer.
    const DkdvBlock blk(p, kQ);
    const int bi = blk.bi, kvi = blk.kvi, k0 = blk.k0, n_q = blk.n_q;
    const int t_lo = blk.t_lo, head0 = blk.head0, n_items = blk.n_items;
    const int ptid = threadIdx.x - 128 * kConsumers;
    if (ptid == 0) {
      // The loads.
      mbar_expect_tx(kv_full, 2 * T::kKBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(base + c * T::kKChunk, &map_k, kv_full, 32 * c, kvi, k0, bi);
        tma_load(base + T::kKBytes + c * T::kKChunk, &map_v, kv_full, 32 * c,
                 kvi, k0, bi);
      }
      for (int it = 0; it < kPasses * n_items; ++it) {
        const int s = it % kStages, rest = it % n_items;
        const uint32_t full = full0 + 8 * s;
        const uint32_t q_dst = base + 2 * T::kKBytes + s * T::kStageBytes;
        const int head = head0 + rest / n_q, q0 = (t_lo + rest % n_q) * kQ;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::kQBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(q_dst + c * T::kQChunk, &map_q, full, 32 * c, head, q0, bi);
          tma_load(q_dst + T::kDo + c * T::kQChunk, &map_do, full, 32 * c,
                   head, q0, bi);
        }
      }
    } else if (ptid >= 128 - kConverters) {
      // The converters.
      for (int it = 0; it < kPasses * n_items; ++it) {
        const int s = it % kStages, rest = it % n_items;
        const int head = head0 + rest / n_q, q0 = (t_lo + rest % n_q) * kQ;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        convert_dkdv<W>(p, smem + 2 * T::kKBytes + s * T::kStageBytes,
                        reinterpret_cast<float*>(smem + T::kStats) +
                            s * 2 * kQ,
                        it / n_items, q0, ((size_t)bi * p.h + head) * p.tq,
                        ptid - (128 - kConverters));
        release(ready0 + 8 * s);
      }
    }
    return;
  }

  const int tid = threadIdx.x - 128 * wg;
  mbar_wait(kv_full, 0);
  if (wg == kDv)
    dkdv_consume<W, kDv>(p, smem, base, bars, tid, parts);
  else
    dkdv_consume<W, kDk>(p, smem, base, bars, tid, parts);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// A stage for both consumers, by converter thread `ctid`: K_lo, V_lo, and K
// transposed (Kt, Kt_lo; its W rows).
template <int W>
__device__ __forceinline__ void convert_dq(uint8_t* st, int ctid) {
  using T = DqTile<W>;
  lo_tile(st, st + T::kKlo, T::kKBytes, ctid, kConverters);
  lo_tile(st + T::kV, st + T::kVlo, T::kKBytes, ctid, kConverters);
  transpose_tile<T::kKeys>(st, st + T::kKt, st + T::kKtLo, 0, W, W, ctid,
                           kConverters);
}

// What a dQ consumer computes of a tile: S, P, dP and dS (up to W 128),
// or past it S and P (consumer 0) or dP and dS (consumer 1).
enum DqRole { kAll = 0, kSP = 1, kDS = 2 };

// Consumer c of a dQ block, its role a template parameter (with both
// roles in one body, ptxas spilled at W 224-256): query rows [r_lo,
// r_lo + 64) of the block, dQ's columns [c0, c0 + kN).  `smem` is the
// block's shared memory (generic), `base` its address, `bars` its first
// mbarrier.
template <int W, int kRole>
__device__ __forceinline__ void dq_consume(const Params& p, uint8_t* smem,
                                           uint32_t base, uint32_t bars,
                                           int n_tiles, int kv_lo, int q0,
                                           int bi, int hi, int c,
                                           float* __restrict__ dq) {
  using T = DqTile<W>;
  constexpr int kKeys = T::kKeys, kStages = T::kStages;
  // the accumulator: all W columns, or split W / 2 from c W / 2
  constexpr int kN = T::kSplit ? W / 2 : W;
  // S's and dP's chunks unrolled 4 at a time at W 224-256 (all of them
  // spilled 4 bytes at W 256; 5 % slower at recurrentgemma_9b)
  constexpr int kUnroll = W > 192 ? 4 : 0;
  const uint32_t q_s = base, do_s = base + T::kQBytes;
  const uint32_t q_full = bars;
  const uint32_t ready0 = q_full + 8 + 8 * kStages;
  const uint32_t empty0 = ready0 + 8 * kStages;
  const int tid = threadIdx.x - 128 * c;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tg = lane % 4;
  const int r_lo = T::kSplit ? q0 : q0 + 64 * c;
  const int c0 = T::kSplit ? c * (W / 2) : 0;
  const uint32_t rows = (r_lo - q0) * 128;     // its rows in each chunk
  // Accumulator fragment (S, dP, dQ): element i lies in row
  // row0 + 8 ((i >> 1) & 1) and column 8 (i / 4) + 2 tg + (i & 1).
  const int row0 = r_lo + 16 * warp + gq;
  const float sc = p.scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    const size_t at = ((size_t)bi * p.h + hi) * p.tq + q;
    lse2[r] = q < p.tq ? p.lse[at] * kLog2e : INFINITY;
    dd[r] = q < p.tq ? p.dsum[at] : 0.f;
  }
  float acc[kN / 2], s_[kKeys / 2], dp[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t st = 2 * T::kQBytes + s * T::kStageBytes;   // offset
    const int k0 = kv_lo + it * kKeys;
    mbar_wait(ready0 + 8 * s, (it / kStages) & 1);
    if (any_live(p, r_lo, 64, k0, kKeys)) {
      // P (masked, in s_) and dS = P o (dP - D) (in dp).  Past W 128, where
      // both consumers take the block's rows, consumer 0 computes S and P
      // and consumer 1 dP and dS, each handed to the other through the
      // stage in the bytes of K_lo and V_lo (dead once the product that
      // reads them is done) behind named barriers 1 and 2.
      float2* const x_p = reinterpret_cast<float2*>(smem + st + T::kKlo) + tid;
      float2* const x_ds =
          reinterpret_cast<float2*>(smem + st + T::kVlo) + tid;
      if (kRole != kDS) {
        product3<W, kUnroll>(s_, q_s + rows, smem + rows, T::kQChunk,
                             base + st, base + st + T::kKlo, T::kKChunk,
                             warp, gq, tg);
        const bool edge = !all_live(p, r_lo, 64, k0, kKeys);
#pragma unroll
        for (int i = 0; i < kKeys / 2; i += 2) {
          const int r = (i >> 1) & 1;
          float p0 = ex2(fmaf(s_[i], sc, -lse2[r]));
          float p1 = ex2(fmaf(s_[i + 1], sc, -lse2[r]));
          if (edge) {
            const int key = k0 + 8 * (i / 4) + 2 * tg, q = row0 + 8 * r;
            if (!live_pair(p, q, key)) p0 = 0.f;
            if (!live_pair(p, q, key + 1)) p1 = 0.f;
          }
          s_[i] = p0;
          s_[i + 1] = p1;
          if (kRole == kSP) x_p[(i / 2) * 128] = make_float2(p0, p1);
        }
        if (kRole == kSP) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
      }
      if (kRole != kSP) {
        product3<W, kUnroll>(dp, do_s + rows, smem + T::kQBytes + rows,
                             T::kQChunk, base + st + T::kV,
                             base + st + T::kVlo, T::kKChunk, warp, gq, tg);
        if (kRole == kDS) asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < kKeys / 2; i += 2) {
          const int r = (i >> 1) & 1;
          if (kRole == kDS) {
            const float2 pp = x_p[(i / 2) * 128];
            s_[i] = pp.x;
            s_[i + 1] = pp.y;
          }
          dp[i] = s_[i] * (dp[i] - dd[r]);
          dp[i + 1] = s_[i + 1] * (dp[i + 1] - dd[r]);
          if (kRole == kDS) x_ds[(i / 2) * 128] = make_float2(dp[i], dp[i + 1]);
        }
        if (kRole == kDS) asm volatile("bar.arrive 2, 256;\n" ::: "memory");
      }
      if (kRole == kSP) {
        asm volatile("bar.sync 2, 256;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < kKeys / 2; i += 2) {
          const float2 d2 = x_ds[(i / 2) * 128];
          dp[i] = d2.x;
          dp[i + 1] = d2.y;
        }
      }
      // dS as the A fragments of dQ += dS Kt: k-step kk's (keys 8 kk ...
      // 8 kk + 7 in Kt's order) is (dS[4 kk], dS[4 kk + 2], dS[4 kk + 1],
      // dS[4 kk + 3]).
      uint32_t a_hi[kKeys / 8][4], a_lo[kKeys / 8][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          split_tf32(dp[4 * kk + 2 * r], a_hi[kk][r], a_lo[kk][r]);
          split_tf32(dp[4 * kk + 2 * r + 1], a_hi[kk][2 + r], a_lo[kk][2 + r]);
        }
      }
      product3_rs<kKeys, 32, kN / 2>(acc, a_hi, a_lo, base + st + T::kKt,
                                     base + st + T::kKtLo, c0, W);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // dq = scale dQ, fp32, its columns below hd, rows below tq.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    if (q >= p.tq) continue;
    float* const out = dq + (((size_t)bi * p.tq + q) * p.h + hi) * p.hd;
#pragma unroll
    for (int jj = 0; jj < kN / 8; ++jj) {
      const int col = c0 + 8 * jj + 2 * tg;
      if (col < p.hd)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(acc[4 * jj + 2 * r] * p.scale,
                        acc[4 * jj + 2 * r + 1] * p.scale);
    }
  }
}

// TMA maps over q, dO (boxes of kRows rows), k and v (boxes of kKeys).
template <int W>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, float* __restrict__ dq,
    const Params p) {
  using T = DqTile<W>;
  constexpr int kKeys = T::kKeys, kRows = T::kRows, kStages = T::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);       // generic view of base
  const uint32_t q_s = base;                 // [chunk][kRows rows][128 B]
  const uint32_t do_s = base + T::kQBytes;
  const uint32_t kv0 = base + 2 * T::kQBytes;   // [stage][K, V, lo, Kt]
  const uint32_t q_full = base + T::kBarriers;
  const uint32_t full0 = q_full + 8, ready0 = full0 + 8 * kStages;
  const uint32_t empty0 = ready0 + 8 * kStages;

  // Block: q tile (the slowest index, heaviest causal tiles first), then
  // batch and head.
  const int per_tile = p.b * p.h;
  const int n_qt = (p.tq + kRows - 1) / kRows;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / per_tile)) * kRows;
  const int bi = blockIdx.x % per_tile / p.h, hi = blockIdx.x % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q_last = min(q0 + kRows, p.tq) - 1;
  const int kv_hi = p.causal ? min(p.tkv, q_last + 1 + diag(p)) : p.tkv;
  const int kv_lo =
      (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / kKeys * kKeys;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kKeys - 1) / kKeys : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kConverters);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // Producer.
    const int ptid = threadIdx.x - 128 * kConsumers;
    if (ptid == 0) {
      mbar_expect_tx(q_full, 2 * T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(q_s + c * T::kQChunk, &map_q, q_full, 32 * c, hi, q0, bi);
        tma_load(do_s + c * T::kQChunk, &map_do, q_full, 32 * c, hi, q0, bi);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = full0 + 8 * s;
        const uint32_t k_dst = kv0 + s * T::kStageBytes;
        const int k0 = kv_lo + it * kKeys;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::kKBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(k_dst + c * T::kKChunk, &map_k, full, 32 * c, kvi, k0, bi);
          tma_load(k_dst + T::kV + c * T::kKChunk, &map_v, full, 32 * c, kvi,
                   k0, bi);
        }
      }
    } else if (ptid >= 128 - kConverters) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        convert_dq<W>(smem + 2 * T::kQBytes + s * T::kStageBytes,
                      ptid - (128 - kConverters));
        release(ready0 + 8 * s);
      }
    }
    return;
  }

  if constexpr (!T::kSplit)
    dq_consume<W, kAll>(p, smem, base, q_full, n_tiles, kv_lo, q0, bi, hi,
                        wg, dq);
  else if (wg == 0)
    dq_consume<W, kSP>(p, smem, base, q_full, n_tiles, kv_lo, q0, bi, hi, 0,
                       dq);
  else
    dq_consume<W, kDS>(p, smem, base, q_full, n_tiles, kv_lo, q0, bi, hi, 1,
                       dq);
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

template <class K>
cudaError_t allow_smem(K kern, uint32_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The four launches at width W.
template <int W>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* parts,
           const Params& p, cudaStream_t stream) {
  using KV = DkdvTile<W>;
  using DQ = DqTile<W>;
  constexpr auto kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  int err = 0;
  // dK / dV: Q and dO in tiles of kQ rows, K and V of the block's 64 keys.
  if (!err) err = make_map(&mq, kF32, 4, q, p.b, p.tq, p.h, p.hd, 32, KV::kQ);
  if (!err)
    err = make_map(&mdo, kF32, 4, dout, p.b, p.tq, p.h, p.hd, 32, KV::kQ);
  if (!err) err = make_map(&mk, kF32, 4, k, p.b, p.tkv, p.kvh, p.hd, 32, 64);
  if (!err) err = make_map(&mv, kF32, 4, v, p.b, p.tkv, p.kvh, p.hd, 32, 64);
  if (err) return err;
  cudaError_t e;
  if ((e = allow_smem(attn_bwd_dkdv_kernel<W>, KV::kSmem)) ||
      (e = allow_smem(attn_bwd_dq_kernel<W>, DQ::kSmem)))
    return (int)e;
  if ((e = launch_prep<float>(o, dout, const_cast<float*>(p.dsum), p.b, p.tq,
                              p.h, p.hd, p.fault, stream)))
    return (int)e;
  const int n_kt = (p.tkv + 63) / 64;
  attn_bwd_dkdv_kernel<W>
      <<<n_kt * p.b * p.kvh * p.splits, kThreads, KV::kSmem, stream>>>(
          mq, mdo, mk, mv, parts, p);
  if ((e = cudaGetLastError())) return (int)e;
  if ((e = launch_dkdv_sum<float>(parts, dk, dv,
                                  (long)p.b * p.tkv * p.kvh * p.hd, p.splits,
                                  p.scale, stream)))
    return (int)e;
  // dQ: Q and dO in tiles of the block's rows, K and V of kKeys keys.
  if (!err)
    err = make_map(&mq, kF32, 4, q, p.b, p.tq, p.h, p.hd, 32, DQ::kRows);
  if (!err)
    err = make_map(&mdo, kF32, 4, dout, p.b, p.tq, p.h, p.hd, 32, DQ::kRows);
  if (!err)
    err = make_map(&mk, kF32, 4, k, p.b, p.tkv, p.kvh, p.hd, 32, DQ::kKeys);
  if (!err)
    err = make_map(&mv, kF32, 4, v, p.b, p.tkv, p.kvh, p.hd, 32, DQ::kKeys);
  if (err) return err;
  const int n_qt = (p.tq + DQ::kRows - 1) / DQ::kRows;
  attn_bwd_dq_kernel<W><<<n_qt * p.b * p.h, kThreads, DQ::kSmem, stream>>>(
      mq, mdo, mk, mv, static_cast<float*>(dq), p);
  return (int)cudaGetLastError();
}

// The launches at the smallest width W >= hd of the list.
template <int W, int... Wider>
int launch_padded(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv,
                  float* parts, const Params& p, cudaStream_t stream) {
  if (p.hd <= W)
    return launch<W>(q, k, v, o, dout, dq, dk, dv, parts, p, stream);
  if constexpr (sizeof...(Wider) > 0)
    return launch_padded<Wider...>(q, k, v, o, dout, dq, dk, dv, parts, p,
                                   stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, o, dout, dq [b, tq, h, hd]; k, v, dk, dv [b, tkv, kvh, hd], all
// contiguous fp32 aligned to 16 bytes, hd in 4, 8, ... 256 (the wrapper
// pads any other hd); lse the forward's fp32 [b, h, tq]; dsum fp32
// [b, h, tq] and parts fp32 [2, splits, b, tkv, kvh, hd] scratch; splits
// divides h / kvh.  Launches on `stream` of `device` and returns the
// cudaError_t of the launches (0 = queued).  `fault` plants a fault for a
// check (0 in use).
int flash_attention_bwd_tf32x3(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dq, void* dk, void* dv,
                               void* dsum, void* parts, int b, int tq,
                               int tkv, int h, int kvh, int hd, float scale,
                               int causal, int window, int splits, int fault,
                               int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || tkv <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh || hd < 4 || hd > 256 || hd % 4 || splits <= 0 ||
      (h / kvh) % splits)
    return (int)cudaErrorInvalidValue;
  const Params p{b, tq, tkv, h, kvh, hd, scale, causal, window, splits,
                 fault, static_cast<const float*>(lse),
                 static_cast<const float*>(dsum)};
  return launch_padded<TF32_WIDTHS>(q, k, v, o, dout, dq, dk, dv,
                                    static_cast<float*>(parts), p,
                                    static_cast<cudaStream_t>(stream));
}

const char* flash_attention_bwd_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
