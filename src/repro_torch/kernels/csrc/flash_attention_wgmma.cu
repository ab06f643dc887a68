// Hand-written Hopper (sm_90a) forward attention on the tensor cores, bf16
// (src/repro_torch/kernels/flash_attention.py::flash_attention).
//
//   flash_attention_wgmma_kernel   replaces src/repro/kernels/
//                                  flash_attention.py::flash_attention_tpu
//                                  for bf16 at every head dim 1-256
//
// q [b, tq, h, hd], k and v [b, tkv, kvh, hd] bf16 (the model's layout, read
// directly) -> o [b, tq, h, hd] bf16.  Query head i reads kv head
// i / (h / kvh).  Masks: causal (key <= query), sliding window
// (key > query - window) and the ragged end of the keys (key < tkv).  The
// softmax statistics are fp32: the running max starts at the finite
// NEG_INF = -1e30, a masked score is -inf and contributes p = 0, and the
// output is O / max(l, 1e-30), so a row with no live key gives zeros here
// (the wrapper then gives such rows the Pallas kernel's value).  Where the
// caller passes an `lse` buffer (training: the backward,
// flash_attention_bwd_wgmma.cu, takes P = exp(scale S - LSE) from it
// instead of recomputing S to find it), the epilogue also stores each
// row's log-sum-exp of the scaled scores, ln 2 m + ln l from the online
// softmax's log2-unit max m and sum l, fp32 [b, h, tq]; inference passes a
// null pointer and stores nothing more.  fp32 goes to
// flash_attention_tf32x3.cu.  The plain PyTorch version is
// flash_attention.py::flash_attention_plain.
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
//   - a producer, whose first thread fills Q once and K and V tiles into a
//     ring of kStages stages with TMA, each stage with a "full" and an
//     "empty" mbarrier; the warpgroup gives its registers up (setmaxnreg);
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
// kernel's block skip).  The kernel is built for padded widths W
// (WGMMA_WIDTHS) and runs a head dim hd, a multiple of 8, at the smallest
// W >= hd: the columns hd..W-1 of Q, K and V are zeros in shared memory
// (TMA's out-of-bounds fill), Q K^T runs W / 16 k-steps and P V W columns,
// and the epilogue stores only the columns below hd; the softmax scale is
// the caller's.  A tensor map's strides are multiples of 16 bytes, so the
// wrapper zero-pads any other hd to the next multiple of 8 and passes the
// scale of the real one (1 / sqrt(hd)).  Shared memory holds 64-column
// chunks (128 bytes a row, the swizzle's width): Q [chunks][128 rows], each
// stage K and V [chunks][kKeys rows].  Tiles: 128 keys at W <= 128 (Q 32 KB
// + 2 stages of 64 KB), 64 keys above (W 256: Q 64 KB + 2 stages of 64 KB);
// m64nWk16 reads the last 64-column chunk of V in part where W is no
// multiple of 64.  TMA maps are 4-D (hd, heads, t, b), so rows past t read
// as zeros and no tile reads the next batch's rows.  The epilogue stages O
// through the consumer's own Q rows and writes the rows below tq in 16-byte
// pieces.  Blocks run head-major with the heaviest causal q tiles first.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums only: the .so needs no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#include "tma_wgmma.cuh"
#include "wgmma_bf16.cuh"

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileQ = 64 * kConsumers;            // query rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The widths the kernel is built for, each padded width W a template
// instance: a call at head dim hd runs at the smallest W >= hd
// (flash_attention.py::WGMMA_WIDTHS; W / hd <= 1.25 from hd 64 up).
#define WGMMA_WIDTHS 16, 32, 64, 80, 96, 112, 128, 160, 192, 224, 256

// The tiles of width W.
template <int W>
struct Tile {
  static constexpr int kHdp = (W + 63) / 64 * 64;   // width in shared memory
  static constexpr int kChunks = kHdp / 64;         // 64-column chunks
  static constexpr int kKeys = kHdp > 128 ? 64 : 128;   // keys per kv tile
  static constexpr int kStages = 2;                 // K/V ring depth
  static constexpr int kSteps = W / 16;             // k16 steps of Q K^T
  static constexpr uint32_t kQChunk = kTileQ * 128;     // bytes
  static constexpr uint32_t kKvChunk = kKeys * 128;
  static constexpr uint32_t kQBytes = kQChunk * kChunks;
  static constexpr uint32_t kKvBytes = kKvChunk * kChunks;  // K (or V)
  static constexpr uint32_t kStageBytes = 2 * kKvBytes;
  static constexpr uint32_t kBarriers = kQBytes + kStages * kStageBytes;
  // + 1024 to align the base to the swizzle's 1024-byte pattern
  static constexpr uint32_t kSmem = 1024 + kBarriers + 8 * (1 + 2 * kStages);
  static_assert(kSmem <= 232448, "shared memory of one block");
};

// hd <= W, hd % 8 == 0; TMA maps over q, k, v, which o shares the layout of;
// kLse: also each row's LSE into lse (an instance of its own, so that the
// inference path's code is the same as without it).
template <int W, bool kLse>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int tq, int tkv, int h, int kvh, int hd,
    float scale, int causal, int window) {
  using T = Tile<W>;
  constexpr int kKeys = T::kKeys;
  constexpr int kStages = T::kStages;
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

    float acc[W / 2];
    float sco[kKeys / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
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
        for (int i = 0; i < W / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
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
    // rows (16-byte units swizzled by row, as TMA lays them), then its
    // columns below hd written in 16-byte pieces to the rows below tq.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    // Each row's log-sum-exp of the scaled scores, ln 2 m + ln l (m is in
    // log2 units), where the caller asked for it: the backward's P.
    if (kLse && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < tq)
          lse[((size_t)bi * h + hi) * tq + row] = m[r] * kLn2 + logf(l[r]);
      }
    }
    uint8_t* const stage = smem + g * 64 * 128;   // its rows in each chunk
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + lane / 4 + 8 * r;
        *reinterpret_cast<uint32_t*>(
            stage + swizzled(row, 16 * j + 4 * (lane % 4), T::kQChunk)) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r],
                      acc[4 * j + 2 * r + 1] * inv[r]);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
    auto* const ob = reinterpret_cast<uint8_t*>(o);
    // Up to W 128 a second copy stores hd == W, the row's length known at
    // compile time: 1-5 % faster at W 64 / 80 / 96 / 128, but 10 % slower
    // at W 224, whose spills grow (PERF.md §6)
    if (W <= 128 && hd == W)
      store_rows(ob, stage, T::kQChunk, tq, h, W / 8, bi, hi, r_lo, 64, tid);
    else
      store_rows(ob, stage, T::kQChunk, tq, h, hd / 8, bi, hi, r_lo, 64, tid);
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
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_q{}, map_k{}, map_v{};
  int err = make_map(&map_q, kBf16, 2, q, b, tq, h, hd, 64, kTileQ);
  if (err == 0)
    err = make_map(&map_k, kBf16, 2, k, b, tkv, kvh, hd, 64, T::kKeys);
  if (err == 0)
    err = make_map(&map_v, kBf16, 2, v, b, tkv, kvh, hd, 64, T::kKeys);
  if (err != 0) return err;
  auto kern = lse != nullptr ? flash_attention_wgmma_kernel<W, true>
                             : flash_attention_wgmma_kernel<W, false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(h, (tq + kTileQ - 1) / kTileQ, b);
  kern<<<grid, kThreads, T::kSmem, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), lse, tq, tkv, h,
      kvh, hd, scale, causal, window);
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

// q[b, tq, h, hd], k and v[b, tkv, kvh, hd] bf16 -> o[b, tq, h, hd] bf16,
// for hd in 8, 16, ... 256 (the wrapper pads any other hd); h % kvh == 0
// and contiguous tensors aligned to 16 bytes (the wrapper checks).  Where
// `lse` is not null, also each row's log-sum-exp of the scaled scores,
// fp32 [b, h, tq] (-inf on a row with no live key).  Launches on `stream`
// of `device` and returns the cudaError_t of the launch (0 = queued).
int flash_attention_wgmma(const void* q, const void* k, const void* v,
                          void* o, void* lse, int b, int tq, int tkv, int h,
                          int kvh, int hd, float scale, int causal,
                          int window, int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || h <= 0) return 0;
  if (hd < 8 || hd % 8) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (tkv <= 0) {
    cudaError_t err = cudaMemsetAsync(o, 0, (size_t)b * tq * h * hd * 2, s);
    if (err == cudaSuccess && lse != nullptr)
      err = launch_neg_inf(static_cast<float*>(lse), (size_t)b * h * tq, s);
    return (int)err;
  }
  return launch_padded<WGMMA_WIDTHS>(q, k, v, o, static_cast<float*>(lse), b,
                                     tq, tkv, h, kvh, hd, scale, causal,
                                     window, s);
}

const char* flash_attention_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
