// Hand-written Hopper (sm_90a) forward attention on the tensor cores, fp32
// through three TF32 products (src/repro_torch/kernels/flash_attention.py::
// flash_attention).
//
//   flash_attention_tf32x3_kernel   replaces src/repro/kernels/
//                                   flash_attention.py::flash_attention_tpu
//                                   for fp32 at every head dim 1-256
//
// q [b, tq, h, hd], k and v [b, tkv, kvh, hd] fp32 (the model's layout, read
// directly) -> o [b, tq, h, hd] fp32.  Query head i reads kv head
// i / (h / kvh).  Masks: causal (key <= query), sliding window
// (key > query - window) and the ragged end of the keys (key < tkv).  The
// softmax statistics are fp32: the running max starts at the finite
// NEG_INF = -1e30, a masked score is -inf and contributes p = 0, and the
// output is O / max(l, 1e-30), so a row with no live key gives zeros here
// (the wrapper then gives such rows the Pallas kernel's value).  Where the
// caller passes an `lse` buffer (training: the backward,
// flash_attention_bwd_tf32x3.cu, takes P = exp(scale S - LSE) from it), the
// epilogue also stores each row's log-sum-exp of the scaled scores,
// ln 2 m + ln l, fp32 [b, h, tq], in a template instance of its own;
// inference launches the instance without it.  bf16 goes to
// flash_attention_wgmma.cu.  The plain PyTorch version is
// flash_attention.py::flash_attention_plain.
//
// What bounds it on an H100: operations.  At glm4_9b's widths (h = 32,
// kvh = 2, hd = 128, t = 1000, causal) the live score and value products
// are 8.2e9 FLOP; on the CUDA cores (67 TFLOP/s) that is 122 us, on the
// TF32 tensor cores (495 TFLOP/s) 17 us for one pass.  One TF32 pass keeps
// 11 bits of each operand (about 5e-4 of each product), which misses the
// fp32 tolerance of 1e-4 + 1e-4 |want|.  So both products run as 3xTF32:
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, with x_hi = x with its low 13
// mantissa bits cleared (what a TF32 operand keeps) and x_lo = x - x_hi
// (exact in fp32); the dropped a_lo b_lo is under 2^-22 of the product.
// Three passes make the bound 3 x operations / 495 TFLOP/s (50 us there).
//
// Design.  One block per (128 query rows, head, batch), three warpgroups:
// two consumers of 64 query rows each, then a producer (past W 128, below,
// 64 rows shared by both consumers).  The producer
// fills Q once, then K and V tiles into a ring of kStages stages (per
// stage a "full" mbarrier for the TMA bytes, a "ready" one for the
// converted tiles and an "empty" one), and its last three warps, the
// converters, prepare each stage for both consumers: K_lo = K - K_hi, and
// V transposed, as Vt and Vt_lo.  The producer's first thread loads the
// tiles with TMA; the converters wait on full.  Every product then runs
// on wgmma (m64nNk8 .tf32, fp32 accumulators):
//   - S = Q_hi K + Q_hi K_lo + Q_lo K: Q and K K-major in shared memory as
//     TMA writes them (128-byte swizzle, 32 fp32 columns a row), the tensor
//     core reading Q's and K's top 19 bits (their hi terms); Q_lo as the A
//     operand of the register form, taken from Q once per kv tile (a
//     fragment held for the whole kernel would cost 64 registers at
//     hd = 128 and spill).
//   - O += P_hi Vt + P_hi Vt_lo + P_lo Vt: wgmma's .tf32 form takes B
//     K-major only, and V is stored with hd contiguous (MN-major for P V),
//     so the producer writes V transposed (keys contiguous).  The S
//     accumulator's registers are the A fragment of P once the k index
//     t of each 8 keys stands for key 2t and t + 4 for key 2t + 1 (the
//     accumulator holds keys 2t, 2t + 1 where the A fragment wants t,
//     t + 4); Vt stores its keys in that order.
//   - The online softmax in registers, each row reduced over the 4 threads
//     that share it; masks only on tiles that cross the causal diagonal, the
//     window edge or the ragged end; a tile masked for all of a consumer's
//     rows is skipped.  The block visits the kv tiles live for some of its
//     rows (the Pallas kernel's block skip).
// A first form ran P V as mma.sync m16n8k8 .tf32 with V's fragments read
// from shared memory as stored and split in registers, kept Q_lo in
// registers, and had each consumer write its own K_lo between two
// barriers; it was right, spilled at hd = 128 and was 1.03-1.22x slower
// (PERF.md §6).  The kernel is built for padded widths W (TF32_WIDTHS) and
// runs a head dim hd, a multiple of 4, at the smallest W >= hd: Q's, K's
// and V's columns hd..W-1 are zeros in shared memory (TMA's out-of-bounds
// fill), so K_lo's are too and so are Vt's rows past hd; Q K^T runs W / 8
// k-steps, P Vt W columns, and the epilogue stores only the columns below
// hd.  A tensor map's strides are multiples of 16 bytes, so the wrapper
// zero-pads any other hd to the next multiple of 4 and passes the scale of
// the real one.  Tiles: 32 keys at W 80-128 (W 128: Q 64 KB + 2 stages of
// K, V, K_lo, Vt, Vt_lo, 80 KB), 64 keys below.  TMA maps are 4-D (hd,
// heads, t, b), so rows past t read as zeros and no tile reads the next
// batch's rows.  Blocks run head-major with the heaviest causal q tiles
// first.
//
// Past W 128 (W 160, 192, 224, 256) that shape does not fit: Q alone is
// 128 KB at W 256, a consumer's O 128 registers a thread, and Q_lo for
// every k-step another 128.  So a block takes 64 query rows, and its two
// consumers split O by columns: consumer c holds O's columns
// [c W / 2, (c + 1) W / 2) (W / 4 registers a thread) and runs P V on that
// half of Vt, a contiguous range of its rows.  S = Q K^T needs the whole
// W: each consumer runs half the k8 steps (in each 32-column chunk, the
// two at bytes [64 c, 64 c + 64) of the row, so the two run the same code
// at addresses 64 c apart: one copy of the loop, every other offset an
// immediate; a range of steps a consumer spilled at W 256), writes its
// 64 x 16 fp32 partial into the stage's V (dead once the converters have
// released `ready`), meets the other at a named barrier and adds the
// other's partial to its own; fp32 addition commutes, so both hold the
// same S, m and l, bit for bit, and run the same softmax.  No product is
// computed twice (1.12-1.23x faster than each consumer computing the whole
// S, 1.5x the products, PERF.md §6).  Q_hi K and Q_hi K_lo are one
// m64n32k8: each chunk of K is followed by the same chunk of K_lo, so one
// B operand of 32 rows holds both; Q_lo K is an m64n16k8.  Both take A
// from registers, Q_hi and Q_lo split from one read of Q a step, in
// groups of 2 steps with two groups' fragments in flight (4-6 % faster
// than Q_hi as A in shared memory, which reads Q twice a step).  Tiles of
// 16 keys: Q 40 / 48 / 56 / 64 KB and stages of 50 / 60 / 70 / 80 KB,
// three stages at W 160 and two above (W 256: 225 KB of the 227); Vt's
// rows are then 64 bytes, in the 64-byte swizzle.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the .so needs no -lcuda
#include <cuda_runtime.h>

namespace {

#include "tma_wgmma.cuh"
#include "wgmma_tf32.cuh"
#include "tf32_convert.cuh"

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kConverters = 96;      // producer threads preparing the stages
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The widths the kernel is built for, each padded width W a template
// instance: a call at head dim hd runs at the smallest W >= hd
// (flash_attention.py::TF32_WIDTHS; W / hd <= 1.25 from hd 64 up).
#define TF32_WIDTHS 16, 32, 64, 80, 96, 112, 128, 160, 192, 224, 256


template <int W>
struct Tile {
  // Past W 128 a block's two consumers share its 64 query rows and split O
  // by columns; up to 128 each takes 64 of its 128 rows and all of O.
  static constexpr bool kSplit = W > 128;
  static constexpr int kTileQ = kSplit ? 64 : 64 * kConsumers;  // q rows
  static constexpr int kHdp = (W + 31) / 32 * 32;   // width in shared memory
  static constexpr int kChunks = kHdp / 32;         // 32-column chunks
  static constexpr int kKeys = kSplit ? 16 : W > 64 ? 32 : 64;  // kv tile
  static constexpr int kWidth = W;
  static constexpr int kSteps = W / 8;              // k8 steps of Q K^T
  static constexpr int kAcc = kSplit ? W / 4 : W / 2;   // O registers
  static constexpr uint32_t kQChunk = kTileQ * 128;     // bytes
  static constexpr uint32_t kKvChunk = kKeys * 128;
  static constexpr uint32_t kQBytes = kQChunk * kChunks;
  static constexpr uint32_t kKvBytes = kKvChunk * kChunks;  // K, V or K_lo
  // A stage: K, V (the producer's loads), K_lo, Vt, Vt_lo (converted).
  // Split, each chunk of K is followed by the same chunk of K_lo (one
  // B operand of 2 kKeys rows holds both), then V; else K, V, K_lo.
  static constexpr uint32_t kKStride = kSplit ? 2 * kKvChunk : kKvChunk;
  static constexpr uint32_t kKlo = kSplit ? kKvChunk : 2 * kKvBytes;
  static constexpr uint32_t kV = kSplit ? 2 * kKvBytes : kKvBytes;
  // Vt / Vt_lo: [key chunk][W rows][32 keys] (128-byte swizzle), split
  // [W rows][16 keys] (rows of 64 bytes, 64-byte swizzle)
  static constexpr uint32_t kVtChunk = W * 128;
  static constexpr uint32_t kVtBytes =
      kSplit ? W * 64 : kVtChunk * (kKeys / 32);
  static constexpr uint32_t kVt = 3 * kKvBytes;
  static constexpr uint32_t kVtLo = kVt + kVtBytes;
  static constexpr uint32_t kStageBytes = kVtLo + kVtBytes;
  static constexpr int kStages =
      kQBytes + 3 * kStageBytes + 2048 <= 232448 ? 3 : 2;   // ring depth
  static constexpr uint32_t kBarriers = kQBytes + kStages * kStageBytes;
  // + 1024 to align the base to the swizzle's 1024-byte pattern
  static constexpr uint32_t kSmem = 1024 + kBarriers + 8 * (1 + 3 * kStages);
  static_assert(kSmem <= 232448, "shared memory of one block");
  // split: the two consumers' S partials in the stage's V, dead once read
  static_assert(!kSplit || kKvBytes >= kConsumers * 128 * 32, "exchange");
};

// A stage for both consumers, by converter thread `ctid` of kConverters:
// K_lo = K - K_hi, and V transposed (keys contiguous, each 8 in the order
// 0 2 4 6 1 3 5 7) as Vt and Vt_lo.  Vt's rows past hd are V's zero
// columns, so P Vt's columns past hd are 0 (they are not stored either).
template <class T>
__device__ __forceinline__ void convert_stage(uint8_t* st, int ctid) {
  constexpr int kUnits = T::kKvChunk / 16;        // 16-byte units a chunk
  for (int e = ctid; e < (int)(T::kKvBytes / 16); e += kConverters) {
    const uint32_t off = (e / kUnits) * T::kKStride + (e % kUnits) * 16;
    const float4 x = *reinterpret_cast<const float4*>(st + off);
    *reinterpret_cast<float4*>(st + T::kKlo + off) =
        make_float4(x.x - tf32_hi(x.x), x.y - tf32_hi(x.y),
                    x.z - tf32_hi(x.z), x.w - tf32_hi(x.w));
  }
  transpose_tile<T::kKeys>(st + T::kV, st + T::kVt, st + T::kVtLo, 0,
                           T::kWidth, T::kWidth, ctid, kConverters);
}

// A split block's S partial, by a consumer thread: s_hi = Q_hi [K; K_lo]
// (an m64n32k8 a step over the stage's K chunks, each followed by its
// K_lo: columns 0-15 keys, 16-31 their lo terms), s_lo = Q_lo K
// (m64n16k8), Q_hi and Q_lo register fragments split from one read of Q.
// Its k8 steps: in each 32-column chunk, the two at bytes [colb, colb +
// 64) of the 128-byte row, colb = 64 c for consumer c, so that the
// consumers' addresses differ by colb alone.  Q is read in groups of 2
// steps, two groups' fragments in flight.  Returns with every product
// complete.
template <class T>
__device__ __forceinline__ void score_steps(float (&s_hi)[16],
                                            float (&s_lo)[8],
                                            const uint8_t* q_gen,
                                            uint32_t st, int colb, int warp,
                                            int gq, int tg) {
  constexpr int kPer = 2;                       // steps a chunk
  constexpr int kCount = T::kChunks * kPer;
  constexpr int kGroup = 2;
  // Q fragment x of a step: rows gq + 8 (x & 1), columns tg + 4 (x >> 1)
  // of its 8, in the 128-byte swizzle (row r's 16-byte unit u at u ^ r % 8)
  const uint8_t* const q_row = q_gen + (16 * warp + gq) * 128 + 4 * tg;
  uint32_t q_hi[2][kGroup][4], q_lo[2][kGroup][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) s_hi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s_lo[i] = 0.f;
  keep(s_hi);
  keep(s_lo);
#pragma unroll
  for (int j0 = 0; j0 < kCount; j0 += kGroup) {
    const int buf = (j0 / kGroup) % 2;
    if (j0 >= 2 * kGroup) wgmma_wait<1>();   // buf's last group is done
#pragma unroll
    for (int j = j0; j < j0 + kGroup && j < kCount; ++j) {
      const int chunk = j / kPer, sub = j % kPer;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int unit = colb / 16 + 2 * sub + (x >> 1);
        const float v = *reinterpret_cast<const float*>(
            q_row + chunk * T::kQChunk + 8 * 128 * (x & 1) +
            ((unit ^ gq) << 4));
        split_tf32(v, q_hi[buf][j - j0][x], q_lo[buf][j - j0][x]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = j0; j < j0 + kGroup && j < kCount; ++j) {
      const int chunk = j / kPer, sub = j % kPer;
      const uint32_t piece = colb + 32 * sub;
      const uint64_t b =
          smem_desc(st + chunk * T::kKStride + piece, 16, 1024);
      wgmma_rs(s_hi, q_hi[buf][j - j0], b, j > 0);
      wgmma_rs(s_lo, q_lo[buf][j - j0], b, j > 0);
    }
    wgmma_commit();
  }
  wgmma_wait();
  keep(s_hi);
  keep(s_lo);
}

// hd <= W, hd % 4 == 0; TMA maps over q, k, v, which o shares the layout of;
// kLse: also each row's LSE into lse (an instance of its own, so that the
// inference path's code is the same as without it).
template <int W, bool kLse>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_tf32x3_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, float* __restrict__ o,
    float* __restrict__ lse, int tq, int tkv, int h, int kvh, int hd,
    float scale, int causal, int window) {
  using T = Tile<W>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
  constexpr int kTileQ = T::kTileQ;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);       // generic view of base
  const uint32_t q_s = base;                 // [chunk][kTileQ rows][128 B]
  const uint32_t kv_s = base + T::kQBytes;   // [stage][K, V, K_lo, Vt, Vt_lo]
  const uint32_t q_full = base + T::kBarriers;
  const uint32_t full0 = q_full + 8;                    // full[s]: + 8 s
  const uint32_t ready0 = full0 + 8 * kStages;          // ready[s]: + 8 s
  const uint32_t empty0 = ready0 + 8 * kStages;         // empty[s]: + 8 s

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
      // The loads.
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * T::kQChunk, &map_q, q_full, 32 * c, hi, q0, bi);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = full0 + 8 * s;
        const uint32_t k_dst = kv_s + s * T::kStageBytes;
        const int k0 = kv_lo + it * kKeys;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::kKvBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(k_dst + c * T::kKStride, &map_k, full, 32 * c, kvi, k0,
                   bi);
          tma_load(k_dst + T::kV + c * T::kKvChunk, &map_v, full, 32 * c,
                   kvi, k0, bi);
        }
      }
    } else if (ptid >= 128 - kConverters) {
      // The converters.
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        convert_stage<T>(smem + T::kQBytes + s * T::kStageBytes,
                         ptid - (128 - kConverters));
        release(ready0 + 8 * s);
      }
    }
    return;
  }

  // Consumer g: query rows [r_lo, r_lo + 64) of the block; split, all the
  // block's rows and O's columns [c0, c0 + W / 2).
  const int g = wg;
  const int tid = threadIdx.x - 128 * g;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tg = lane % 4;   // fragment row group, thread in it
  const int r_lo = T::kSplit ? q0 : q0 + 64 * g, r_hi = r_lo + 63;
  const int c0 = T::kSplit ? g * (W / 2) : 0;
  // Accumulator fragment (S and O): element i lies in row
  // row0 + 8 ((i >> 1) & 1) and column 8 (i / 4) + 2 tg + (i & 1).
  const int row0 = r_lo + 16 * warp + gq;
  const uint32_t q_wg = q_s + (r_lo - q0) * 128;  // its rows in each Q chunk
  const uint8_t* const q_gen = smem + (r_lo - q0) * 128;
  const float sc = scale * kLog2e;

  float acc[T::kAcc];
  float sco[kKeys / 2];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sco[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t st = kv_s + s * T::kStageBytes;
    const int k0 = kv_lo + it * kKeys;
    mbar_wait(ready0 + 8 * s, (it / kStages) & 1);
    const bool skip = k0 >= tkv || (causal && k0 > r_hi) ||
                      (window > 0 && k0 + kKeys - 1 <= r_lo - window);
    if (!skip) {
      if constexpr (T::kSplit) {
        // S = Q_hi K + Q_hi K_lo + Q_lo K over this consumer's half of the
        // k8 steps, then the other consumer's partial added, passed through
        // the stage's V (dead since `ready`): both then hold the same S,
        // bit for bit.
        float s_hi[16], s_lo[8];
        score_steps<T>(s_hi, s_lo, q_gen, st, 64 * g, warp, gq, tg);
#pragma unroll
        for (int i = 0; i < 8; ++i) sco[i] = s_hi[i] + s_hi[i + 8] + s_lo[i];
        float4* const xch = reinterpret_cast<float4*>(
            smem + T::kQBytes + s * T::kStageBytes + T::kV);
        xch[(2 * g) * 128 + tid] = make_float4(sco[0], sco[1], sco[2],
                                               sco[3]);
        xch[(2 * g + 1) * 128 + tid] = make_float4(sco[4], sco[5], sco[6],
                                                   sco[7]);
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
        const float4 a = xch[(2 * (1 - g)) * 128 + tid];
        const float4 b = xch[(2 * (1 - g) + 1) * 128 + tid];
        sco[0] += a.x; sco[1] += a.y; sco[2] += a.z; sco[3] += a.w;
        sco[4] += b.x; sco[5] += b.y; sco[6] += b.z; sco[7] += b.w;
      } else {
        // Q_lo as the A fragments of the k8 steps: a0 (row gq, col tg), a1
        // (gq + 8, tg), a2 (gq, tg + 4), a3 (gq + 8, tg + 4).
        uint32_t q_lo[T::kSteps][4];
#pragma unroll
        for (int kk = 0; kk < T::kSteps; ++kk) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = *reinterpret_cast<const float*>(
                q_gen + swizzled(16 * warp + gq + 8 * (j & 1),
                                 4 * (8 * kk + tg + 4 * (j >> 1)),
                                 T::kQChunk));
            q_lo[kk][j] = __float_as_uint(x - tf32_hi(x));
          }
        }
        // S = Q_hi K + Q_hi K_lo + Q_lo K.
        keep(sco);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kSteps; ++kk) {
          const uint32_t off = (kk / 4) * T::kQChunk + (kk % 4) * 32;
          const uint32_t koff = (kk / 4) * T::kKvChunk + (kk % 4) * 32;
          const uint64_t a = smem_desc(q_wg + off, 16, 1024);
          const uint64_t b = smem_desc(st + koff, 16, 1024);
          wgmma_ss(sco, a, b, kk > 0);
          wgmma_ss(sco, a, smem_desc(st + T::kKlo + koff, 16, 1024), 1);
          wgmma_rs(sco, q_lo[kk], b, 1);
        }
        wgmma_commit();
        wgmma_wait();
        keep(sco);
      }

      const bool masked = k0 + kKeys > tkv ||
                          (causal && k0 + kKeys - 1 > r_lo) ||
                          (window > 0 && k0 <= r_hi - window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * tg + (i & 1);
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
      for (int i = 0; i < T::kAcc; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P_hi Vt + P_hi Vt_lo + P_lo Vt, 8 keys a step, over Vt's rows
      // [c0, c0 + kAcc / 2).  With k index t standing for key 2t and t + 4
      // for key 2t + 1 (Vt's order), the A fragment of step kk is (S[4kk],
      // S[4kk + 2], S[4kk + 1], S[4kk + 3]).
      uint32_t p_hi[kKeys / 8][4], p_lo[kKeys / 8][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
        split_tf32(sco[4 * kk], p_hi[kk][0], p_lo[kk][0]);
        split_tf32(sco[4 * kk + 2], p_hi[kk][1], p_lo[kk][1]);
        split_tf32(sco[4 * kk + 1], p_hi[kk][2], p_lo[kk][2]);
        split_tf32(sco[4 * kk + 3], p_hi[kk][3], p_lo[kk][3]);
      }
      keep(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
        uint64_t vt, vt_lo;
        if constexpr (T::kSplit) {
          const uint32_t off = c0 * 64 + kk * 32;
          vt = smem_desc(st + T::kVt + off, 16, 512, 2);
          vt_lo = smem_desc(st + T::kVtLo + off, 16, 512, 2);
        } else {
          const uint32_t off = (kk / 4) * T::kVtChunk + (kk % 4) * 32;
          vt = smem_desc(st + T::kVt + off, 16, 1024);
          vt_lo = smem_desc(st + T::kVtLo + off, 16, 1024);
        }
        wgmma_rs(acc, p_hi[kk], vt, 1);
        wgmma_rs(acc, p_hi[kk], vt_lo, 1);
        wgmma_rs(acc, p_lo[kk], vt, 1);
      }
      wgmma_commit();
      wgmma_wait();
      keep(acc);
    }
    // split: the exchange wrote the stage's V, which TMA writes next
    if constexpr (T::kSplit)
      release(empty0 + 8 * s);
    else
      mbar_arrive(empty0 + 8 * s);
  }

  // Epilogue: O / max(l, 1e-30), its columns below hd (a multiple of 4),
  // two fp32 columns a store, rows below tq.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  // Each row's log-sum-exp of the scaled scores, ln 2 m + ln l (m is in
  // log2 units; -inf on a row with no live key), where the caller asked
  // for it: the backward's P.  Split, both consumers hold the same m and
  // l, and the first writes it.
  if (kLse && tg == 0 && c0 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < tq)
        lse[((size_t)bi * h + hi) * tq + row] = m[r] * kLn2 + logf(l[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= tq) continue;
    float* const orow = o + (((size_t)bi * tq + row) * h + hi) * hd;
#pragma unroll
    for (int nt = 0; nt < T::kAcc / 4; ++nt) {
      const int c = c0 + 8 * nt + 2 * tg;
      if (c < hd)
        *reinterpret_cast<float2*>(orow + c) = make_float2(
            acc[4 * nt + 2 * r] * inv[r], acc[4 * nt + 2 * r + 1] * inv[r]);
    }
  }
}

// The LSE of a call with no keys: -inf on every row.
__global__ void fill_neg_inf(float* x, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = -INFINITY;
}

cudaError_t launch_neg_inf(float* x, size_t n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  fill_neg_inf<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, n);
  return cudaGetLastError();
}

template <int W>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int tq, int tkv, int h, int kvh, int hd, float scale,
           int causal, int window, cudaStream_t stream) {
  using T = Tile<W>;
  constexpr auto kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap map_q{}, map_k{}, map_v{};
  int err = make_map(&map_q, kF32, 4, q, b, tq, h, hd, 32, T::kTileQ);
  if (err == 0)
    err = make_map(&map_k, kF32, 4, k, b, tkv, kvh, hd, 32, T::kKeys);
  if (err == 0)
    err = make_map(&map_v, kF32, 4, v, b, tkv, kvh, hd, 32, T::kKeys);
  if (err != 0) return err;
  auto kern = lse != nullptr ? flash_attention_tf32x3_kernel<W, true>
                             : flash_attention_tf32x3_kernel<W, false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(h, (tq + T::kTileQ - 1) / T::kTileQ, b);
  kern<<<grid, kThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<float*>(o), lse, tq, tkv, h, kvh, hd,
      scale, causal, window);
  return (int)cudaGetLastError();
}

// The launch at the smallest width W >= hd of the list.
template <int W, int... Wider>
int launch_padded(const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int tq, int tkv, int h, int kvh, int hd,
                  float scale, int causal, int window, cudaStream_t stream) {
  if (hd <= W)
    return launch<W>(q, k, v, o, lse, b, tq, tkv, h, kvh, hd, scale, causal,
                     window, stream);
  if constexpr (sizeof...(Wider) > 0)
    return launch_padded<Wider...>(q, k, v, o, lse, b, tq, tkv, h, kvh, hd,
                                   scale, causal, window, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q[b, tq, h, hd], k and v[b, tkv, kvh, hd] fp32 -> o[b, tq, h, hd] fp32,
// for hd in 4, 8, ... 256 (the wrapper pads any other hd); h % kvh == 0
// and contiguous tensors aligned to 16 bytes (the wrapper checks).  Where
// `lse` is not null, also each row's log-sum-exp of the scaled scores,
// fp32 [b, h, tq] (-inf on a row with no live key).  Launches on `stream`
// of `device` and returns the cudaError_t of the launch (0 = queued).
int flash_attention_tf32x3(const void* q, const void* k, const void* v,
                           void* o, void* lse, int b, int tq, int tkv, int h,
                           int kvh, int hd, float scale, int causal,
                           int window, int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || h <= 0) return 0;
  if (hd < 4 || hd % 4) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (tkv <= 0) {
    cudaError_t err = cudaMemsetAsync(o, 0, (size_t)b * tq * h * hd * 4, s);
    if (err == cudaSuccess && lse != nullptr)
      err = launch_neg_inf(static_cast<float*>(lse), (size_t)b * h * tq, s);
    return (int)err;
  }
  return launch_padded<TF32_WIDTHS>(q, k, v, o, static_cast<float*>(lse), b,
                                    tq, tkv, h, kvh, hd, scale, causal,
                                    window, s);
}

const char* flash_attention_tf32x3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
