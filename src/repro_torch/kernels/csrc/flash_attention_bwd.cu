// Hand-written Hopper (sm_90a) kernels for the fp32 backward of attention
// (src/repro_torch/kernels/flash_attention.py::flash_attention_bwd): the
// gradients dq, dk and dv of the forward that flash_attention_tf32x3.cu
// computes.  bf16 goes to flash_attention_bwd_wgmma.cu (the tensor cores,
// from the LSE its forward kernel writes).
//
// It replaces no TPU kernel: the JAX package's Pallas attention
// (src/repro/kernels/flash_attention.py::flash_attention_tpu) is forward
// only and lies on no training path; XLA differentiates the plain pair-list
// attention there.  The port's training sends attention on the card
// through the forward kernels, whose output carries no autograd graph, so
// the backward is a kernel of its own (`FlashAttention`, an
// autograd.Function).  Its plain PyTorch twin is
// flash_attention.py::flash_attention_bwd_plain.
//
// The FlashAttention-2 backward, with S = scale * Q K^T, P = exp(S - LSE):
//   attn_bwd_stats  one block per (b, head, q tile): each row's
//                   log-sum-exp over its live keys (recomputed: the fp32
//                   forward kernel writes no LSE) and D = rowsum(dO o O)
//   attn_bwd_dkdv   one block per (b, kv head, kv tile): over the group's
//                   g query heads and their live q tiles, dV += P^T dO,
//                   dS = P o (dO V^T - D), dK += scale dS^T Q; dK and dV
//                   written once, the GQA sum inside the block (no atomics,
//                   deterministic)
//   attn_bwd_dq     one block per (b, head, q tile): over the live kv
//                   tiles, dQ += scale dS K
// Masks: causal (key <= query), a sliding window (key > query - window),
// ragged tq and tkv; whole tiles that no live pair touches are skipped.
// GQA: query head i reads kv head i / (h / kvh).  hd 1-256, run at the
// padded width HD = 32, 64, 128 or 256 (zero columns past hd).  fp32
// inputs, arithmetic and outputs.  A row with no live key has no gradient
// here: the wrapper raises before the launch.
//
// What bounds it on an H100: operations.  The backward does 2.5 times the
// forward's products (S and dP again, then dV, dK, dQ: 5 products of a
// live pair's hd-long rows against the forward's 2): 0.69 TFLOP a glm4_9b
// layer at b 2, t 4096, against ~0.29 GB moved in bf16 (q, k, v, o, dO
// and the LSE read once, dq, dk, dv written once in bf16): 0.69 ms at 989
// TFLOP/s bf16, 4.2 ms as 3xTF32 in fp32.  This version runs on the CUDA
// cores: tiles of 64 x 64 (32 x 32 past HD 128) in shared memory as fp32,
// each thread a 4 x 4 (2 x 2) block of S and dP and a 4 x HD/16 block of
// the accumulated gradient in registers, so a value read from shared
// memory serves several products.  3xTF32 on the tensor cores is later
// work.
//
// Written with SHARED_BLOCK_MEMORY, __syncthreads and warp shuffles only,
// so tests/cuda_emu/ compiles it with g++ for the CPU.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef SHARED_BLOCK_MEMORY
#define SHARED_BLOCK_MEMORY(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

constexpr int kThreads = 256;             // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;

// Faults a check can plant (`fault` of the entry point; 0 in use).
enum Fault { kNone = 0, kNoD = 1, kOneHead = 2, kCausalOffByOne = 3 };

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;                      // [b, h, tq] scratch
  int b, tq, tkv, h, kvh, hd;
  float scale;
  int causal, window, fault;
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

__device__ __forceinline__ bool live(const Args& a, int qp, int kp) {
  if (qp >= a.tq || kp >= a.tkv) return false;
  if (a.causal && kp > qp + (a.fault == kCausalOffByOne ? 1 : 0))
    return false;
  if (a.window > 0 && kp <= qp - a.window) return false;
  return true;
}

// Whether the tile of rows [q_lo, q_lo + nq) and keys [k_lo, k_lo + nk)
// may hold a live pair (the forward's block skip).
__device__ __forceinline__ bool tile_live(const Args& a, int q_lo, int nq,
                                          int k_lo, int nk) {
  if (a.causal &&
      k_lo > q_lo + nq - 1 + (a.fault == kCausalOffByOne ? 1 : 0))
    return false;
  if (a.window > 0 && k_lo + nk - 1 <= q_lo - a.window) return false;
  return true;
}

// Rows [row0, row0 + R) of head `head` of a [b, t, H, hd] tensor as fp32
// into s[R][HD + 1]; zeros past t and past hd.
template <class T, int R, int HD>
__device__ void load_tile(float* s, const void* base, int bi, int t, int H,
                          int head, int hd, int row0) {
  const T* p = static_cast<const T*>(base);
  for (int i = threadIdx.x; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, row = row0 + r;
    float x = 0.f;
    if (row < t && d < hd)
      x = to_f(p[(((size_t)bi * t + row) * H + head) * hd + d]);
    s[r * (HD + 1) + d] = x;
  }
}

// Each row's LSE and D of rows [q_lo, q_lo + R) of (bi, head), into
// shared memory (0 past tq).
__device__ void load_stats(float* slse, float* sd, const Args& a, int bi,
                           int head, int q_lo, int R) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const int qp = q_lo + r;
    const size_t at = ((size_t)bi * a.h + head) * a.tq + qp;
    slse[r] = qp < a.tq ? a.lse[at] : 0.f;
    sd[r] = qp < a.tq ? a.dsum[at] : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] B[tx + 16 j][d], over the first hd
// columns of two fp32 tiles of row stride HD + 1.
template <int NI, int NJ, int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[NI][NJ], const float* A,
                                         const float* B, int hd) {
  constexpr int LD = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int i = 0; i < NI; ++i)
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float x[NI], y[NJ];
    for (int i = 0; i < NI; ++i) x[i] = A[(ty + 16 * i) * LD + d];
    for (int j = 0; j < NJ; ++j) y[j] = B[(tx + 16 * j) * LD + d];
    for (int i = 0; i < NI; ++i)
      for (int j = 0; j < NJ; ++j) acc[i][j] += x[i] * y[j];
  }
}

template <class T, int BQ, int BK, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_stats(Args a) {
  constexpr int LD = HD + 1, NI = BQ / 16, NJ = BK / 16;
  SHARED_BLOCK_MEMORY(raw);
  float* sq = reinterpret_cast<float*>(raw);            // [BQ][LD]
  float* sk = sq + BQ * LD;                              // [BK][LD]
  const int q_lo = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const int kvhead = head / (a.h / a.kvh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, BQ, HD>(sq, a.q, bi, a.tq, a.h, head, a.hd, q_lo);
  float m[NI], l[NI];
  for (int i = 0; i < NI; ++i) m[i] = kNegInf, l[i] = 0.f;
  for (int k_lo = 0; k_lo < a.tkv; k_lo += BK) {
    if (!tile_live(a, q_lo, BQ, k_lo, BK)) continue;
    __syncthreads();                       // the last tile's reads are done
    load_tile<T, BK, HD>(sk, a.k, bi, a.tkv, a.kvh, kvhead, a.hd, k_lo);
    __syncthreads();
    float s[NI][NJ];
    dot_tile<NI, NJ, HD>(s, sq, sk, a.hd);
    for (int i = 0; i < NI; ++i) {
      const int qp = q_lo + ty + 16 * i;
      float mx = m[i];
      for (int j = 0; j < NJ; ++j) {
        s[i][j] *= a.scale;
        if (live(a, qp, k_lo + tx + 16 * j)) mx = fmaxf(mx, s[i][j]);
      }
      float sum = 0.f;
      for (int j = 0; j < NJ; ++j)
        if (live(a, qp, k_lo + tx + 16 * j)) sum += expf(s[i][j] - mx);
      l[i] = l[i] * expf(m[i] - mx) + sum;
      m[i] = mx;
    }
  }
  // merge the 16 threads of a row (a half warp)
  for (int i = 0; i < NI; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mx = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mx) + lo * expf(mo - mx);
      m[i] = mx;
    }
    const int qp = q_lo + ty + 16 * i;
    if (tx == 0 && qp < a.tq)
      a.lse[((size_t)bi * a.h + head) * a.tq + qp] = m[i] + logf(l[i]);
  }
  // D = rowsum(dO o O): a warp a row, lanes along hd
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int qp = q_lo + r;
    if (qp >= a.tq) break;                 // the same for the whole warp
    const size_t row = (((size_t)bi * a.tq + qp) * a.h + head) * a.hd;
    float acc = 0.f;
    for (int d = lane; d < a.hd; d += 32)
      acc += to_f(dout[row + d]) * to_f(o[row + d]);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      a.dsum[((size_t)bi * a.h + head) * a.tq + qp] =
          a.fault == kNoD ? 0.f : acc;
  }
}

// P and dS of the tile (rows q_lo.., keys k_lo..) into sp / sds
// [BQ][BK + 1], from S = sq sk^T and dP = sdo sv^T.
template <int BQ, int BK, int HD>
__device__ __forceinline__ void p_and_ds(const Args& a, const float* sq,
                                         const float* sdo, const float* sk,
                                         const float* sv, const float* slse,
                                         const float* sd, float* sp,
                                         float* sds, int q_lo, int k_lo) {
  constexpr int NI = BQ / 16, NJ = BK / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[NI][NJ], dp[NI][NJ];
  dot_tile<NI, NJ, HD>(s, sq, sk, a.hd);
  dot_tile<NI, NJ, HD>(dp, sdo, sv, a.hd);
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      const float p = live(a, q_lo + r, k_lo + c)
                          ? expf(s[i][j] * a.scale - slse[r])
                          : 0.f;
      if (sp) sp[r * (BK + 1) + c] = p;
      sds[r * (BK + 1) + c] = p * (dp[i][j] - sd[r]);
    }
  }
}

template <class T, int BQ, int BK, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(Args a) {
  constexpr int LD = HD + 1, RK = BK / 16, CD = HD / 16;
  SHARED_BLOCK_MEMORY(raw);
  float* sk = reinterpret_cast<float*>(raw);            // [BK][LD]
  float* sv = sk + BK * LD;                              // [BK][LD]
  float* sq = sv + BK * LD;                              // [BQ][LD]
  float* sdo = sq + BQ * LD;                             // [BQ][LD]
  float* sp = sdo + BQ * LD;                             // [BQ][BK + 1]
  float* sds = sp + BQ * (BK + 1);                       // [BQ][BK + 1]
  float* slse = sds + BQ * (BK + 1);                     // [BQ]
  float* sd = slse + BQ;                                 // [BQ]
  const int k_lo = blockIdx.x * BK, kvhead = blockIdx.y, bi = blockIdx.z;
  const int g = a.h / a.kvh;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, BK, HD>(sk, a.k, bi, a.tkv, a.kvh, kvhead, a.hd, k_lo);
  load_tile<T, BK, HD>(sv, a.v, bi, a.tkv, a.kvh, kvhead, a.hd, k_lo);
  float dk[RK][CD], dv[RK][CD];
  for (int r = 0; r < RK; ++r)
    for (int c = 0; c < CD; ++c) dk[r][c] = dv[r][c] = 0.f;
  const int heads = a.fault == kOneHead ? 1 : g;
  for (int hh = 0; hh < heads; ++hh) {
    const int head = kvhead * g + hh;
    for (int q_lo = 0; q_lo < a.tq; q_lo += BQ) {
      if (!tile_live(a, q_lo, BQ, k_lo, BK)) continue;
      __syncthreads();                     // the last tile's reads are done
      load_tile<T, BQ, HD>(sq, a.q, bi, a.tq, a.h, head, a.hd, q_lo);
      load_tile<T, BQ, HD>(sdo, a.dout, bi, a.tq, a.h, head, a.hd, q_lo);
      load_stats(slse, sd, a, bi, head, q_lo, BQ);
      __syncthreads();
      p_and_ds<BQ, BK, HD>(a, sq, sdo, sk, sv, slse, sd, sp, sds, q_lo,
                           k_lo);
      __syncthreads();
      // dV[kk][d] += P[q][kk] dO[q][d], dK[kk][d] += dS[q][kk] Q[q][d],
      // kk = ty + 16 r, d = tx + 16 c
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RK], dsv[RK], dov[CD], qv[CD];
        for (int r = 0; r < RK; ++r) {
          pv[r] = sp[qq * (BK + 1) + ty + 16 * r];
          dsv[r] = sds[qq * (BK + 1) + ty + 16 * r];
        }
        for (int c = 0; c < CD; ++c) {
          dov[c] = sdo[qq * LD + tx + 16 * c];
          qv[c] = sq[qq * LD + tx + 16 * c];
        }
        for (int r = 0; r < RK; ++r)
          for (int c = 0; c < CD; ++c) {
            dv[r][c] += pv[r] * dov[c];
            dk[r][c] += dsv[r] * qv[c];
          }
      }
    }
  }
  T* gdk = static_cast<T*>(a.dk);
  T* gdv = static_cast<T*>(a.dv);
  for (int r = 0; r < RK; ++r) {
    const int kp = k_lo + ty + 16 * r;
    if (kp >= a.tkv) continue;
    const size_t row = (((size_t)bi * a.tkv + kp) * a.kvh + kvhead) * a.hd;
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d >= a.hd) continue;
      gdk[row + d] = from_f<T>(dk[r][c] * a.scale);
      gdv[row + d] = from_f<T>(dv[r][c]);
    }
  }
}

template <class T, int BQ, int BK, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(Args a) {
  constexpr int LD = HD + 1, RQ = BQ / 16, CD = HD / 16;
  SHARED_BLOCK_MEMORY(raw);
  float* sq = reinterpret_cast<float*>(raw);            // [BQ][LD]
  float* sdo = sq + BQ * LD;                             // [BQ][LD]
  float* sk = sdo + BQ * LD;                             // [BK][LD]
  float* sv = sk + BK * LD;                              // [BK][LD]
  float* sds = sv + BK * LD;                             // [BQ][BK + 1]
  float* slse = sds + BQ * (BK + 1);                     // [BQ]
  float* sd = slse + BQ;                                 // [BQ]
  const int q_lo = blockIdx.x * BQ, head = blockIdx.y, bi = blockIdx.z;
  const int kvhead = head / (a.h / a.kvh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, BQ, HD>(sq, a.q, bi, a.tq, a.h, head, a.hd, q_lo);
  load_tile<T, BQ, HD>(sdo, a.dout, bi, a.tq, a.h, head, a.hd, q_lo);
  load_stats(slse, sd, a, bi, head, q_lo, BQ);
  float dq[RQ][CD];
  for (int r = 0; r < RQ; ++r)
    for (int c = 0; c < CD; ++c) dq[r][c] = 0.f;
  for (int k_lo = 0; k_lo < a.tkv; k_lo += BK) {
    if (!tile_live(a, q_lo, BQ, k_lo, BK)) continue;
    __syncthreads();                       // the last tile's reads are done
    load_tile<T, BK, HD>(sk, a.k, bi, a.tkv, a.kvh, kvhead, a.hd, k_lo);
    load_tile<T, BK, HD>(sv, a.v, bi, a.tkv, a.kvh, kvhead, a.hd, k_lo);
    __syncthreads();
    p_and_ds<BQ, BK, HD>(a, sq, sdo, sk, sv, slse, sd, nullptr, sds, q_lo,
                         k_lo);
    __syncthreads();
    // dQ[q][d] += dS[q][kk] K[kk][d], q = ty + 16 r, d = tx + 16 c
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ], kv[CD];
      for (int r = 0; r < RQ; ++r) dsv[r] = sds[(ty + 16 * r) * (BK + 1) + kk];
      for (int c = 0; c < CD; ++c) kv[c] = sk[kk * LD + tx + 16 * c];
      for (int r = 0; r < RQ; ++r)
        for (int c = 0; c < CD; ++c) dq[r][c] += dsv[r] * kv[c];
    }
  }
  T* gdq = static_cast<T*>(a.dq);
  for (int r = 0; r < RQ; ++r) {
    const int qp = q_lo + ty + 16 * r;
    if (qp >= a.tq) continue;
    const size_t row = (((size_t)bi * a.tq + qp) * a.h + head) * a.hd;
    for (int c = 0; c < CD; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) gdq[row + d] = from_f<T>(dq[r][c] * a.scale);
    }
  }
}

template <class K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The three launches at tiles BQ x BK and padded width HD.
template <class T, int BQ, int BK, int HD>
cudaError_t run(const Args& a, cudaStream_t stream) {
  constexpr size_t LD = HD + 1, F = sizeof(float);
  constexpr size_t s_stats = (BQ + BK) * LD * F;
  constexpr size_t s_dkdv =
      (2 * BK + 2 * BQ) * LD * F + 2 * BQ * (BK + 1) * F + 2 * BQ * F;
  constexpr size_t s_dq =
      (2 * BQ + 2 * BK) * LD * F + BQ * (BK + 1) * F + 2 * BQ * F;
  cudaError_t err;
  if ((err = allow_smem(attn_bwd_stats<T, BQ, BK, HD>, s_stats)) ||
      (err = allow_smem(attn_bwd_dkdv<T, BQ, BK, HD>, s_dkdv)) ||
      (err = allow_smem(attn_bwd_dq<T, BQ, BK, HD>, s_dq)))
    return err;
  const dim3 q_grid((a.tq + BQ - 1) / BQ, a.h, a.b);
  const dim3 k_grid((a.tkv + BK - 1) / BK, a.kvh, a.b);
  attn_bwd_stats<T, BQ, BK, HD><<<q_grid, kThreads, s_stats, stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  attn_bwd_dkdv<T, BQ, BK, HD><<<k_grid, kThreads, s_dkdv, stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  attn_bwd_dq<T, BQ, BK, HD><<<q_grid, kThreads, s_dq, stream>>>(a);
  return cudaGetLastError();
}

template <class T>
cudaError_t run_width(const Args& a, cudaStream_t stream) {
  if (a.hd <= 32) return run<T, 64, 64, 32>(a, stream);
  if (a.hd <= 64) return run<T, 64, 64, 64>(a, stream);
  if (a.hd <= 128) return run<T, 64, 64, 128>(a, stream);
  return run<T, 32, 32, 256>(a, stream);
}

}  // namespace

extern "C" {

// q, o, dout, dq [b, tq, h, hd]; k, v, dk, dv [b, tkv, kvh, hd], all
// contiguous fp32; lse, dsum fp32 [b, h, tq] scratch.
// Launches on `stream` of `device` and returns the cudaError_t of the
// launches (0 = queued).  `fault` plants a fault for a check (0 in use).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, void* lse, void* dsum, int b, int tq,
                        int tkv, int h, int kvh, int hd, float scale,
                        int causal, int window, int fault, int device,
                        void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || tkv <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh || hd < 1 || hd > 256)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, dq, dk, dv,
               static_cast<float*>(lse), static_cast<float*>(dsum),
               b, tq, tkv, h, kvh, hd, scale, causal, window, fault};
  return (int)run_width<float>(a, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
