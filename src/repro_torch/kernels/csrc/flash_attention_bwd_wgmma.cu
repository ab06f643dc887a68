// Hand-written Hopper (sm_90a) backward of attention on the tensor cores,
// bf16 (src/repro_torch/kernels/flash_attention.py::flash_attention_bwd):
// the gradients dq, dk and dv of the forward that flash_attention_wgmma.cu
// computes.  fp32 goes to flash_attention_bwd.cu (the CUDA cores).
//
// It replaces no TPU kernel: the JAX package's Pallas attention
// (src/repro/kernels/flash_attention.py::flash_attention_tpu) is forward
// only, and XLA differentiates the plain pair-list attention on the
// reference's training path.  Its plain PyTorch twin is
// flash_attention.py::flash_attention_bwd_plain.
//
// With S = Q K^T, P = exp(scale S - LSE), LSE each row's log-sum-exp that
// the forward kernel wrote (so S is not recomputed to find it), four
// launches:
//   attn_bwd_prep        D = rowsum(dO o O), fp32 [b, h, tq]
//                        (flash_attention_bwd_prep.cuh)
//   attn_bwd_dkdv_kernel one block per (kv tile, kv head, split of its GQA
//                        group, batch): over the split's query heads and
//                        their live q tiles, dV += P^T dO and
//                        dK += dS^T Q with dS = P o (dP - D), as fp32
//                        partials a split
//   attn_bwd_dkdv_sum    dk = scale * the partials' sum, dv the sum, bf16
//                        (flash_attention_bwd_prep.cuh)
//   attn_bwd_dq_kernel   one block per (q tile, head, batch): over the live
//                        kv tiles, dQ += dS K; dq = scale dQ, bf16
// No atomics: every sum is taken in one order, so a call gives the same
// bits on every run.  Masks: causal (key <= query), a sliding window
// (key > query - window), ragged tq and tkv.  GQA: query head i reads kv
// head i / (h / kvh).  A row with no live key has no gradient: the wrapper
// raises before the launch.
//
// What bounds it on an H100: operations.  At glm4_9b's widths (b 2, t 4096,
// h 32, kvh 2, hd 128, causal) the live pairs need 5 products of hd-long
// rows (S, dP, dV, dK, dQ): 0.69 TFLOP, 0.70 ms at the 989 TFLOP/s bf16
// tensor-core rate, against ~0.3 GB moved (q, k, v, o, dO and the LSE read
// once, dq, dk, dv written once: 0.09 ms at 3.35 TB/s).  So every product
// runs on wgmma (bf16 in, fp32 accumulators) with tiles loaded by TMA into
// a ring of stages, as in the forward kernel.  Keeping dQ out of atomics
// costs S and dP twice (7 products a live pair, not 5).
//
// Design of the two wgmma kernels: three warpgroups a block, a producer
// and two consumers, each consumer 64 rows of wgmma's M.  ptxas gives every
// thread of a 384-thread block 168 registers whatever the consumers'
// setmaxnreg asks for (PERF.md §6), so no consumer holds more than one
// accumulator of 64 x 128 (64 registers a thread) beside its tiles.
//   dK/dV: keys are M (the FlashAttention-3 arrangement), 64 a block.  The
//     producer's first thread loads the block's K and V once and then, for
//     each query head of the split and each live 64-row q tile, Q and dO
//     into a ring of stages; its second warp writes the tile's LSE (in log2
//     units, +inf past tq, so P = 0 there) and D into the stage.  The two
//     consumers share the keys and split the work by product: the dV
//     consumer computes S^T = K Q^T, P^T = ex2(S^T scale log2e - LSE
//     log2e) (masked), hands P^T to the other through the stage (fp32, an
//     mbarrier), and accumulates dV += P^T dO; the dK consumer computes
//     dP^T = V dO^T, dS^T = P^T o (dP^T - D) and dK += dS^T Q.  S^T and dP^T
//     are wgmma m64n64k16 with all operands K-major in shared memory as TMA
//     writes them (128-byte swizzle); P^T and dS^T, packed to bf16 in the
//     registers of the accumulator they came from, are already the layout
//     of wgmma's register A operand, and dO and Q are the MN-major B
//     operand (the transpose bit).  The accumulators stay in registers for
//     the whole block and are written once, as fp32 partials: splitting a
//     GQA group over several blocks (`splits`, the most that keeps the grid
//     within four waves of the card) gives causal blocks of unequal work
//     more to balance; the grid runs the heaviest kv tiles first.  Past
//     W 128 each consumer makes two passes over the items, columns
//     [0, 128) and then [128, W) of its accumulator (S^T and dP^T twice).
//     A first form gave each consumer 64 of 128 keys and both
//     accumulators (dK + dV: 128 registers, S^T and dP^T 64 more) and
//     spilled 256-1372 bytes at W 80-256.
//   dQ: queries are M.  The producer loads the block's Q and dO once and
//     the live kv tiles of 64 keys into a ring; a consumer reads its rows'
//     LSE and D once, computes S = Q K^T and dP = dO V^T, P and dS as
//     above, and dQ += dS K with K the MN-major B operand.  Up to W 128
//     each consumer takes 64 of the block's 128 rows; past it both take its
//     64 rows and split dQ's columns, [0, 128) and [128, W) (S and dP
//     twice).  The epilogue stages dQ through Q's rows and writes it in
//     16-byte pieces.  The grid runs the heaviest causal q tiles first.
// Masks are applied only on tiles that cross the causal diagonal, the
// window edge or a ragged end; a tile with no live pair for a consumer's
// rows is skipped.  Widths: the kernel is built for the forward's padded
// widths W (WGMMA_WIDTHS) and runs head dim hd, a multiple of 8, at the
// smallest W >= hd (columns hd..W-1 zeros in shared memory, TMA's
// out-of-bounds fill; only columns below hd stored); the wrapper zero-pads
// any other hd and passes the scale of the real one.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the .so needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#include "tma_wgmma.cuh"
#include "wgmma_bf16.cuh"
#include "flash_attention_bwd_prep.cuh"

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kQ = 64;              // dK/dV: query rows of a stage
constexpr int kKv = 64;             // dQ: keys of a stage
constexpr int kStages = 2;          // ring depth of both kernels
constexpr float kLog2e = 1.4426950408889634f;

// The widths the kernel is built for, the forward's
// (flash_attention.py::WGMMA_WIDTHS).
#define WGMMA_WIDTHS 16, 32, 64, 80, 96, 112, 128, 160, 192, 224, 256

// The shape of width W shared by the two kernels.
template <int W>
struct Width {
  static constexpr int kHdp = (W + 63) / 64 * 64;   // width in shared memory
  static constexpr int kChunks = kHdp / 64;         // 64-column chunks
  static constexpr int kSteps = W / 16;             // k16 steps over W
  // Past W 128 an accumulator of W columns does not fit a thread's
  // registers: it is cut in two, columns [0, 128) and [128, W).
  static constexpr bool kSplit = W > 128;
  static constexpr int kN0 = kSplit ? 128 : W;
  static constexpr int kN1 = kSplit ? W - 128 : W;
};

// dK / dV: a block's 64 keys, stages of kQ query rows: Q, dO, P^T (fp32,
// the dV consumer's for the dK one) and their LSE and D.
template <int W>
struct DkdvTile : Width<W> {
  using B = Width<W>;
  static constexpr uint32_t kKChunk = 64 * 128;          // bytes
  static constexpr uint32_t kKBytes = kKChunk * B::kChunks;    // K or V
  static constexpr uint32_t kQChunk = kQ * 128;
  static constexpr uint32_t kQBytes = kQChunk * B::kChunks;    // Q or dO
  static constexpr uint32_t kPBytes = 64 * kQ * 4;
  static constexpr uint32_t kStageBytes = 2 * kQBytes + kPBytes;
  static constexpr uint32_t kStats = 2 * kKBytes + kStages * kStageBytes;
  static constexpr uint32_t kBarriers = kStats + kStages * 2 * kQ * 4;
  // kv_full, then full, empty and p_full of each stage
  static constexpr uint32_t kSmem = 1024 + kBarriers + 8 * (1 + 3 * kStages);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// dQ: a block's kRows query rows (64 shared by both consumers past W 128),
// stages of kKv keys: K and V.
template <int W>
struct DqTile : Width<W> {
  using B = Width<W>;
  static constexpr int kRows = B::kSplit ? 64 : 64 * kConsumers;
  static constexpr uint32_t kQChunk = kRows * 128;       // bytes
  static constexpr uint32_t kQBytes = kQChunk * B::kChunks;    // Q or dO
  static constexpr uint32_t kKChunk = kKv * 128;
  static constexpr uint32_t kKBytes = kKChunk * B::kChunks;    // K or V
  static constexpr uint32_t kStageBytes = 2 * kKBytes;
  static constexpr uint32_t kBarriers = 2 * kQBytes + kStages * kStageBytes;
  static constexpr uint32_t kSmem = 1024 + kBarriers + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

struct Params {
  int b, tq, tkv, h, kvh, hd;  // hd: the launch's, a multiple of 8, <= W
  float scale;
  int causal, window, splits, fault;
  const float* lse;            // [b, h, tq], natural log units of scale S
  const float* dsum;           // D [b, h, tq]
};

// The causal diagonal's offset: key <= query + diag (1 under the fault).
__device__ __forceinline__ int diag(const Params& p) {
  return p.fault == kCausalOffByOne ? 1 : 0;
}

__device__ __forceinline__ bool live_pair(const Params& p, int q, int key) {
  bool ok = q < p.tq && key < p.tkv;
  if (p.causal) ok = ok && key <= q + diag(p);
  if (p.window > 0) ok = ok && key > q - p.window;
  return ok;
}

// Whether queries [q0, q0 + nq) and keys [k0, k0 + nk) hold a live pair.
__device__ __forceinline__ bool any_live(const Params& p, int q0, int nq,
                                         int k0, int nk) {
  if (q0 >= p.tq || k0 >= p.tkv) return false;
  if (p.causal && k0 > q0 + nq - 1 + diag(p)) return false;
  if (p.window > 0 && k0 + nk - 1 <= q0 - p.window) return false;
  return true;
}

// Whether every pair of the tile is live (no mask needed).
__device__ __forceinline__ bool all_live(const Params& p, int q0, int nq,
                                         int k0, int nk) {
  if (q0 + nq > p.tq || k0 + nk > p.tkv) return false;
  if (p.causal && k0 + nk - 1 > q0 + diag(p)) return false;
  if (p.window > 0 && k0 <= q0 + nq - 1 - p.window) return false;
  return true;
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// The two consumers of a dK/dV block share its 64 keys and each q tile:
// the dV consumer computes S^T and P^T, hands P^T to the dK consumer
// through the stage, and accumulates dV; the dK consumer computes dP^T,
// dS^T from that P^T, and accumulates dK.  Each holds one accumulator of
// 64 x N and one 64 x kQ tile, well within a thread's registers, and no
// product is computed twice.
enum Role { kDv = 0, kDk = 1 };

// What a consumer of a dK/dV block needs of one item (a q tile of one
// head), and the three steps it takes on it.
template <int W, int kRole>
struct DkdvItem {
  using T = DkdvTile<W>;
  uint32_t b_src;        // the first product's B: Q (dV) or dO (dK)
  uint32_t acc_src;      // the accumulator product's B: dO (dV) or Q (dK)
  float2* pt;            // P^T: float2 j of thread t at (j * 128 + t) * 8 B
  const float* stats;    // LSE (log2 units) and D of the tile's rows
  int qa;                // the tile's first query row

  __device__ __forceinline__ DkdvItem(uint8_t* smem, uint32_t base, int s,
                                      int qa_, int tid)
      : qa(qa_) {
    const uint32_t stage = 2 * T::kKBytes + s * T::kStageBytes;  // offset
    b_src = base + stage + (kRole == kDv ? 0 : T::kQBytes);
    acc_src = base + stage + (kRole == kDv ? T::kQBytes : 0);
    pt = reinterpret_cast<float2*>(smem + stage + 2 * T::kQBytes) + tid;
    stats = reinterpret_cast<const float*>(smem + T::kStats) + s * 2 * kQ;
  }

  // S^T = K Q^T (dV) or dP^T = V dO^T (dK) issued into x (zeroed first, so
  // that the last tile's values need not live across the loop); committed,
  // not waited for.
  __device__ __forceinline__ void first(float (&x)[kQ / 2],
                                        uint32_t a_src) const {
#pragma unroll
    for (int i = 0; i < kQ / 2; ++i) x[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk)
      wgmma_ss(x,
               smem_desc(a_src + (kk / 4) * T::kKChunk + (kk % 4) * 32, 16,
                         1024),
               smem_desc(b_src + (kk / 4) * T::kQChunk + (kk % 4) * 32, 16,
                         1024),
               kk > 0);
    wgmma_commit();
  }

  // The accumulator product's A fragments from x, as bf16: the fragment of
  // queries [16 kk, 16 kk + 16) is k-step kk's.  dV: P^T (masked on edge
  // tiles), also stored to pt for the dK consumer; dK: dS^T from pt.
  __device__ __forceinline__ void frags(const Params& p,
                                        const float (&x)[kQ / 2],
                                        uint32_t (&a)[kQ / 16][4], int k0,
                                        int key0, int col0, float sc) const {
    const bool edge = kRole == kDv && !all_live(p, qa, kQ, k0, 64);
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 8 * kk + 2 * j;
        const int cq = 8 * (i / 4) + col0;            // query - qa
        if (kRole == kDv) {
          const float2 l2 = *reinterpret_cast<const float2*>(stats + cq);
          float p0 = ex2(fmaf(x[i], sc, -l2.x));
          float p1 = ex2(fmaf(x[i + 1], sc, -l2.y));
          if (edge) {
            const int key = key0 + 8 * ((i >> 1) & 1);
            if (!live_pair(p, qa + cq, key)) p0 = 0.f;
            if (!live_pair(p, qa + cq + 1, key)) p1 = 0.f;
          }
          pt[(i / 2) * 128] = make_float2(p0, p1);
          a[kk][j] = pack_bf16(p0, p1);
        } else {
          const float2 d2 = *reinterpret_cast<const float2*>(stats + kQ + cq);
          const float2 pp = pt[(i / 2) * 128];
          a[kk][j] = pack_bf16(pp.x * (x[i] - d2.x), pp.y * (x[i + 1] - d2.y));
        }
      }
    }
  }

  // dV += P^T dO or dK += dS^T Q, on the accumulator's N columns from
  // chunk `chunk0`; committed, not waited for.
  template <int N>
  __device__ __forceinline__ void second(float (&acc)[N / 2],
                                         const uint32_t (&a)[kQ / 16][4],
                                         int chunk0) const {
    keep(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_rs(acc, a[kk],
               smem_desc(acc_src + chunk0 * T::kQChunk + kk * 16 * 128,
                         T::kQChunk, 1024),
               1);
    wgmma_commit();
  }
};

// One pass of consumer `role` over items [it0, it0 + n) of the block: the
// accumulator's N columns from 64-column chunk `chunk0` on, written as the
// split's fp32 partials at the end.  `smem` is the block's shared memory
// (generic), `base` its address, `bars` its first mbarrier.  (A pipelined
// form, item it's first product issued before item it - 1's accumulator
// product over three stages, was 15 % slower; three stages alone changed
// nothing: PERF.md §6.)
template <int W, int N, int kRole>
__device__ __forceinline__ void dkdv_pass(
    const Params& p, uint8_t* smem, uint32_t base, uint32_t bars, int it0,
    int n, int n_q, int t_lo, int k0, int chunk0, int tid, int bi, int kvi,
    int split, float* __restrict__ parts) {
  using Item = DkdvItem<W, kRole>;
  const uint32_t full0 = bars + 8, empty0 = full0 + 8 * kStages;
  const uint32_t p_full0 = empty0 + 8 * kStages;
  const uint32_t a_src = base + (kRole == kDv ? 0 : DkdvTile<W>::kKBytes);
  const int warp = tid / 32, lane = tid % 32;
  // Accumulator fragment: element i of an m64nN accumulator lies in row
  // key0 + 8 ((i >> 1) & 1) and column 8 (i / 4) + col0 + (i & 1).
  const int key0 = k0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float sc = p.scale * kLog2e;
  float acc[N / 2], x[kQ / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  for (int it = it0; it < it0 + n; ++it) {
    const int s = it % kStages;
    const Item item(smem, base, s, (t_lo + (it - it0) % n_q) * kQ, tid);
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    const bool live = any_live(p, item.qa, kQ, k0, 64);
    uint32_t a[kQ / 16][4];
    if (live) {
      item.first(x, a_src);
      wgmma_wait();
      keep(x);
    }
    // The P^T hand-over: the dV consumer arrives on every item, live or
    // not, once P^T is stored; the dK consumer waits on every item.
    if (kRole == kDk) mbar_wait(p_full0 + 8 * s, (it / kStages) & 1);
    if (live) item.frags(p, x, a, k0, key0, col0, sc);
    if (kRole == kDv) mbar_arrive(p_full0 + 8 * s);
    if (live) {
      item.template second<N>(acc, a, chunk0);
      wgmma_wait();
      keep(acc);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  // The split's partials, fp32 [2, splits, b, tkv, kvh, hd]: dK, then dV.
  const size_t size = (size_t)p.b * p.tkv * p.kvh * p.hd;
  float* const out =
      parts + ((kRole == kDk ? 0 : (size_t)p.splits) + split) * size;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int key = key0 + 8 * ((i >> 1) & 1);
    const int col = 64 * chunk0 + 8 * (i / 4) + col0;
    if (key < p.tkv && col < p.hd)
      *reinterpret_cast<float2*>(
          out + (((size_t)bi * p.tkv + key) * p.kvh + kvi) * p.hd + col) =
          make_float2(acc[i], acc[i + 1]);
  }
}

// Consumer `role`'s passes: one over all of W, or two past W 128 (columns
// [0, 128), then [128, W)), each over all the block's items.
template <int W, int kRole>
__device__ __forceinline__ void dkdv_consume(
    const Params& p, uint8_t* smem, uint32_t base, uint32_t bars,
    int n_items, int n_q, int t_lo, int k0, int tid, int bi, int kvi,
    int split, float* __restrict__ parts) {
  using T = DkdvTile<W>;
  dkdv_pass<W, T::kN0, kRole>(p, smem, base, bars, 0, n_items, n_q, t_lo,
                              k0, 0, tid, bi, kvi, split, parts);
  if constexpr (T::kSplit)
    dkdv_pass<W, T::kN1, kRole>(p, smem, base, bars, n_items, n_items, n_q,
                                t_lo, k0, 2, tid, bi, kvi, split, parts);
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
  constexpr int kPasses = T::kSplit ? 2 : 1;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);       // generic view of base
  const uint32_t k_s = base;                   // [chunk][64 rows][128 B]
  const uint32_t v_s = base + T::kKBytes;
  const uint32_t stage0 = base + 2 * T::kKBytes;  // [stage][Q, dO, P^T]
  const uint32_t bars = base + T::kBarriers;   // kv_full, then per stage
  const uint32_t kv_full = bars;
  const uint32_t full0 = bars + 8, empty0 = full0 + 8 * kStages;
  const uint32_t p_full0 = empty0 + 8 * kStages;

  // Block: kv tile j (the slowest index: heaviest causal tiles first), then
  // batch, kv head and split.
  const int per_tile = p.b * p.kvh * p.splits;
  const int j = blockIdx.x / per_tile;
  int r = blockIdx.x % per_tile;
  const int bi = r / (p.kvh * p.splits);
  r %= p.kvh * p.splits;
  const int kvi = r / p.splits, split = r % p.splits;
  const int g = p.h / p.kvh, gs = g / p.splits;
  const int head0 = kvi * g + split * gs;
  const int n_heads = p.fault == kOneHead ? (split == 0 ? 1 : 0) : gs;
  const int k0 = j * 64;
  // The q tiles live for some key of the block: [t_lo, t_lo + n_q); an
  // item is one of them for one head of the split, in each pass.
  const int q_lo = p.causal ? max(0, k0 - diag(p)) : 0;
  const int q_end = p.window > 0 ? min(p.tq, k0 + 63 + p.window) : p.tq;
  const int t_lo = q_lo / kQ;
  const int n_q = q_end > q_lo ? (q_end + kQ - 1) / kQ - t_lo : 0;
  const int n_items = n_heads * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);     // TMA's thread + the stats warp
      mbar_init(empty0 + 8 * s, kConsumers * 128);
      mbar_init(p_full0 + 8 * s, 128);      // the dV consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::kKBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(k_s + c * T::kKChunk, &map_k, kv_full, 64 * c, kvi, k0, bi);
        tma_load(v_s + c * T::kKChunk, &map_v, kv_full, 64 * c, kvi, k0, bi);
      }
      for (int it = 0; it < kPasses * n_items; ++it) {
        const int s = it % kStages, rest = it % n_items;
        const uint32_t full = full0 + 8 * s;
        const uint32_t q_dst = stage0 + s * T::kStageBytes;
        const int head = head0 + rest / n_q, q0 = (t_lo + rest % n_q) * kQ;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * T::kQBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(q_dst + c * T::kQChunk, &map_q, full, 64 * c, head, q0, bi);
          tma_load(q_dst + T::kQBytes + c * T::kQChunk, &map_do, full, 64 * c,
                   head, q0, bi);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      // The stats warp: each stage's LSE in log2 units (+inf past tq) and D.
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < kPasses * n_items; ++it) {
        const int s = it % kStages, rest = it % n_items;
        const int head = head0 + rest / n_q, q0 = (t_lo + rest % n_q) * kQ;
        const size_t row = ((size_t)bi * p.h + head) * p.tq;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        float* const st = reinterpret_cast<float*>(smem + T::kStats) +
                          s * 2 * kQ;
        for (int rr = lane; rr < kQ; rr += 32) {
          const int q = q0 + rr;
          st[rr] = q < p.tq ? p.lse[row + q] * kLog2e : INFINITY;
          st[kQ + rr] = q < p.tq ? p.dsum[row + q] : 0.f;
        }
        mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x - 128 * wg;
    mbar_wait(kv_full, 0);
    if (wg == 1)
      dkdv_consume<W, kDv>(p, smem, base, bars, n_items, n_q, t_lo, k0, tid,
                           bi, kvi, split, parts);
    else
      dkdv_consume<W, kDk>(p, smem, base, bars, n_items, n_q, t_lo, k0, tid,
                           bi, kvi, split, parts);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Consumer c of a dQ block: N accumulator columns from chunk `chunk0` on,
// over the query rows [r_lo, r_lo + 64) whose Q and dO rows start at q_wg
// and do_wg in each chunk.
template <int W, int N>
__device__ __forceinline__ void dq_consume(
    const Params& p, uint32_t q_wg, uint32_t do_wg, uint32_t kv0,
    uint32_t q_full, uint32_t full0, uint32_t empty0, int n_tiles, int kv_lo,
    int r_lo, int chunk0, int tid, int bi, int hi, float (&acc)[N / 2]) {
  using T = DqTile<W>;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = r_lo + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float sc = p.scale * kLog2e;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + 8 * r;
    const size_t at = ((size_t)bi * p.h + hi) * p.tq + q;
    lse2[r] = q < p.tq ? p.lse[at] * kLog2e : INFINITY;
    dd[r] = q < p.tq ? p.dsum[at] : 0.f;
  }
  float s_[kKv / 2], dp[kKv / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t k_src = kv0 + s * T::kStageBytes;
    const uint32_t v_src = k_src + T::kKBytes;
    const int k0 = kv_lo + it * kKv;
    mbar_wait(full0 + 8 * s, (it / kStages) & 1);
    if (any_live(p, r_lo, 64, k0, kKv)) {
      // S = Q K^T and dP = dO V^T (zeroed first, as in dK / dV).
#pragma unroll
      for (int i = 0; i < kKv / 2; ++i) s_[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        const uint32_t qoff = (kk / 4) * T::kQChunk + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * T::kKChunk + (kk % 4) * 32;
        wgmma_ss(s_, smem_desc(q_wg + qoff, 16, 1024),
                 smem_desc(k_src + koff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < T::kSteps; ++kk) {
        const uint32_t qoff = (kk / 4) * T::kQChunk + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * T::kKChunk + (kk % 4) * 32;
        wgmma_ss(dp, smem_desc(do_wg + qoff, 16, 1024),
                 smem_desc(v_src + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      keep(s_);
      keep(dp);

      const bool edge = !all_live(p, r_lo, 64, k0, kKv);
      uint32_t dsf[kKv / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const int r = (i >> 1) & 1;
          float p0 = ex2(fmaf(s_[i], sc, -lse2[r]));
          float p1 = ex2(fmaf(s_[i + 1], sc, -lse2[r]));
          if (edge) {
            const int key = k0 + 8 * (i / 4) + col0, q = row0 + 8 * r;
            if (!live_pair(p, q, key)) p0 = 0.f;
            if (!live_pair(p, q, key + 1)) p1 = 0.f;
          }
          dsf[kk][j] = pack_bf16(p0 * (dp[i] - dd[r]), p1 * (dp[i + 1] - dd[r]));
        }
      }

      // dQ += dS K.
      keep(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk)
        wgmma_rs(acc, dsf[kk],
                 smem_desc(k_src + chunk0 * T::kKChunk + kk * 16 * 128,
                           T::kKChunk, 1024),
                 1);
      wgmma_commit();
      wgmma_wait();
      keep(acc);
    }
    mbar_arrive(empty0 + 8 * s);
  }
}

// Consumer c's dQ columns (scale dQ, bf16) into the staged tile `stage`
// (rows relative to its base, the swizzle's layout).
template <int W, int N>
__device__ __forceinline__ void dq_stage(uint8_t* stage, int srow0,
                                         int chunk0, int lane, float scale,
                                         const float (&acc)[N / 2]) {
  using T = DqTile<W>;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = srow0 + 8 * r;
      *reinterpret_cast<uint32_t*>(
          stage + swizzled(row, 128 * chunk0 + 16 * j + 4 * (lane % 4),
                           T::kQChunk)) =
          pack_bf16(acc[4 * j + 2 * r] * scale,
                    acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// TMA maps over q, dO (boxes of kRows rows), k and v (boxes of kKv).
template <int W>
__global__ void __launch_bounds__(kThreads, 1) attn_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    __nv_bfloat16* __restrict__ dq, const Params p) {
  using T = DqTile<W>;
  constexpr int kTileQ = T::kRows;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);       // generic view of base
  const uint32_t q_s = base;                 // [chunk][kTileQ rows][128 B]
  const uint32_t do_s = base + T::kQBytes;
  const uint32_t kv0 = base + 2 * T::kQBytes;  // [stage][K, V][chunk][kKv]
  const uint32_t q_full = base + T::kBarriers;
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  // Block: q tile (the slowest index, heaviest causal tiles first), then
  // batch and head.
  const int per_tile = p.b * p.h;
  const int n_qt = (p.tq + kTileQ - 1) / kTileQ;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / per_tile)) * kTileQ;
  const int bi = blockIdx.x % per_tile / p.h, hi = blockIdx.x % p.h;
  const int kvi = hi / (p.h / p.kvh);
  const int q_last = min(q0 + kTileQ, p.tq) - 1;
  const int kv_hi = p.causal ? min(p.tkv, q_last + 1 + diag(p)) : p.tkv;
  const int kv_lo =
      (p.window > 0 ? max(0, q0 - p.window + 1) : 0) / kKv * kKv;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kKv - 1) / kKv : 0;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load(q_s + c * T::kQChunk, &map_q, q_full, 64 * c, hi, q0, bi);
        tma_load(do_s + c * T::kQChunk, &map_do, q_full, 64 * c, hi, q0, bi);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = full0 + 8 * s;
        const uint32_t k_dst = kv0 + s * T::kStageBytes;
        const int k0 = kv_lo + it * kKv;
        mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full, T::kStageBytes);
        for (int c = 0; c < T::kChunks; ++c) {
          tma_load(k_dst + c * T::kKChunk, &map_k, full, 64 * c, kvi, k0, bi);
          tma_load(k_dst + T::kKBytes + c * T::kKChunk, &map_v, full, 64 * c,
                   kvi, k0, bi);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int lane = tid % 32;
    auto* const out = reinterpret_cast<uint8_t*>(dq);
    if (T::kSplit) {
      // Both consumers take the block's 64 rows, consumer c the columns
      // from chunk 2 c on; the tile is staged in Q once both are done
      // reading it, each then writes 32 of its rows.
      const int srow0 = 16 * (tid / 32) + lane / 4;
      if (c == 0) {
        float acc[T::kN0 / 2];
        dq_consume<W, T::kN0>(p, q_s, do_s, kv0, q_full, full0, empty0,
                              n_tiles, kv_lo, q0, 0, tid, bi, hi, acc);
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        dq_stage<W, T::kN0>(smem, srow0, 0, lane, p.scale, acc);
      } else {
        float acc[T::kN1 / 2];
        dq_consume<W, T::kN1>(p, q_s, do_s, kv0, q_full, full0, empty0,
                              n_tiles, kv_lo, q0, 2, tid, bi, hi, acc);
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        dq_stage<W, T::kN1>(smem, srow0, 2, lane, p.scale, acc);
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      store_rows(out, smem + 32 * c * 128, T::kQChunk, p.tq, p.h, p.hd / 8,
                 bi, hi, q0 + 32 * c, 32, tid);
    } else {
      float acc[W / 2];
      const uint32_t rows = c * 64 * 128;     // its rows in each chunk
      dq_consume<W, W>(p, q_s + rows, do_s + rows, kv0, q_full, full0, empty0,
                       n_tiles, kv_lo, q0 + 64 * c, 0, tid, bi, hi, acc);
      // Its own Q rows, which only it read, stage its dQ.
      uint8_t* const stage = smem + rows;
      dq_stage<W, W>(stage, 16 * (tid / 32) + lane / 4, 0, lane, p.scale,
                     acc);
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      store_rows(out, stage, T::kQChunk, p.tq, p.h, p.hd / 8, bi, hi,
                 q0 + 64 * c, 64, tid);
    }
  }
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
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq{}, mdo{}, mk{}, mv{};
  int err = 0;
  // dK / dV: Q and dO in tiles of kQ rows, K and V of the block's 64 keys.
  if (!err) err = make_map(&mq, kBf16, 2, q, p.b, p.tq, p.h, p.hd, 64, kQ);
  if (!err)
    err = make_map(&mdo, kBf16, 2, dout, p.b, p.tq, p.h, p.hd, 64, kQ);
  if (!err)
    err = make_map(&mk, kBf16, 2, k, p.b, p.tkv, p.kvh, p.hd, 64, 64);
  if (!err)
    err = make_map(&mv, kBf16, 2, v, p.b, p.tkv, p.kvh, p.hd, 64, 64);
  if (err) return err;
  cudaError_t e;
  if ((e = allow_smem(attn_bwd_dkdv_kernel<W>, KV::kSmem)) ||
      (e = allow_smem(attn_bwd_dq_kernel<W>, DQ::kSmem)))
    return (int)e;
  if ((e = launch_prep<__nv_bfloat16>(o, dout, const_cast<float*>(p.dsum),
                                      p.b, p.tq, p.h, p.hd, p.fault, stream)))
    return (int)e;
  const int n_kt = (p.tkv + 63) / 64;
  attn_bwd_dkdv_kernel<W>
      <<<n_kt * p.b * p.kvh * p.splits, kThreads, KV::kSmem, stream>>>(
          mq, mdo, mk, mv, parts, p);
  if ((e = cudaGetLastError())) return (int)e;
  if ((e = launch_dkdv_sum<__nv_bfloat16>(
           parts, dk, dv, (long)p.b * p.tkv * p.kvh * p.hd, p.splits,
           p.scale, stream)))
    return (int)e;
  // dQ: Q and dO in tiles of the block's rows, K and V of kKv keys.
  if (!err)
    err = make_map(&mq, kBf16, 2, q, p.b, p.tq, p.h, p.hd, 64, DQ::kRows);
  if (!err)
    err = make_map(&mdo, kBf16, 2, dout, p.b, p.tq, p.h, p.hd, 64, DQ::kRows);
  if (!err) err = make_map(&mk, kBf16, 2, k, p.b, p.tkv, p.kvh, p.hd, 64, kKv);
  if (!err) err = make_map(&mv, kBf16, 2, v, p.b, p.tkv, p.kvh, p.hd, 64, kKv);
  if (err) return err;
  const int n_qt = (p.tq + DQ::kRows - 1) / DQ::kRows;
  attn_bwd_dq_kernel<W><<<n_qt * p.b * p.h, kThreads, DQ::kSmem, stream>>>(
      mq, mdo, mk, mv, static_cast<__nv_bfloat16*>(dq), p);
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
// contiguous bf16 aligned to 16 bytes, hd in 8, 16, ... 256 (the wrapper
// pads any other hd); lse the forward's fp32 [b, h, tq]; dsum fp32
// [b, h, tq] and parts fp32 [2, splits, b, tkv, kvh, hd] scratch; splits
// divides h / kvh.  Launches on `stream` of `device` and returns the
// cudaError_t of the launches (0 = queued).  `fault` plants a fault for a
// check (0 in use).
int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* dsum, void* parts, int b, int tq, int tkv,
                              int h, int kvh, int hd, float scale, int causal,
                              int window, int splits, int fault, int device,
                              void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || tkv <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh || hd < 8 || hd > 256 || hd % 8 || splits <= 0 ||
      (h / kvh) % splits)
    return (int)cudaErrorInvalidValue;
  const Params p{b, tq, tkv, h, kvh, hd, scale, causal, window, splits,
                 fault, static_cast<const float*>(lse),
                 static_cast<const float*>(dsum)};
  return launch_padded<WGMMA_WIDTHS>(q, k, v, o, dout, dq, dk, dv,
                                     static_cast<float*>(parts), p,
                                     static_cast<cudaStream_t>(stream));
}

const char* flash_attention_bwd_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
