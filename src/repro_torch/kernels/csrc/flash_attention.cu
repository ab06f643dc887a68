// Hand-written Hopper (sm_90a) forward attention with an online softmax
// (src/repro_torch/kernels/flash_attention.py::flash_attention).
//
//   flash_attention_kernel   replaces src/repro/kernels/flash_attention.py::
//                            flash_attention_tpu
//
// q [b, tq, h, hd], k and v [b, tkv, kvh, hd] (the model's layout, read
// directly), fp32 or bf16, hd <= 256 -> o [b, tq, h, hd] in q's type.  Query
// head i reads kv head i / (h / kvh) (contiguous GQA groups).  Masks: causal
// (key <= query), sliding window (key > query - window) and the ragged end
// of the keys (key < tkv); ragged ends of q and kv are masked here, with no
// padding copies.  Arithmetic is fp32: the running max starts at the finite
// NEG_INF = -1e30, masked scores contribute p = 0, and the output is
// acc / max(l, 1e-30), so a row with no live key gives zeros and never NaN.
// That departs from the Pallas kernel on purpose: it gives masked scores
// exp(0) terms while a row has seen no live key, so its rows with none hold
// a mean of masked v rows that depends on its tiling.
// The plain PyTorch version is flash_attention.py::flash_attention_plain.
//
// Design (simple and right; tensor cores, TMA and a fast design are later
// work).  One block of 8 warps per (64-query tile, head, batch); each warp
// owns 8 consecutive query rows.  The block stages its Q tile once, then
// walks the kv tiles of 32 keys that the causal and window masks leave
// live for the tile (the Pallas kernel's block skip), staging K and V in
// shared memory as fp32.  For a tile, lane j scores key j against the
// warp's 8 rows (Q read as broadcast float4s, K row j as float4s from a
// stride with an odd number of 16-byte pieces, so the lanes of a quarter
// warp hit distinct banks); a warp max gives each row's new running max;
// lane j's p values go to shared memory, and each lane then accumulates its
// hd / 32 output dims (dims lane, lane + 32, ...) over the 32 keys.  The
// running sum l is kept per lane and summed over the warp once at the end.
// A warp skips a tile that is masked for all its rows.
//
// What bounds it on an H100: operations.  At glm4_9b's widths (h = 32,
// kvh = 2, hd = 128, t = 4096, causal, bf16) the live score and value
// products are 1.37e11 FLOP, 139 us at the 989 TFLOP/s bf16 tensor-core
// rate, against 71 MB of HBM traffic (21 us at 3.35 TB/s).  This kernel
// runs them on the CUDA cores in fp32 (67 TFLOP/s peak), with about one
// shared-memory load per FMA, so it sits well above that bound; the
// tensor-core version (wgmma on bf16 tiles) is the redesign that closes
// the gap.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // warps per block
constexpr int kRows = 8;                    // query rows per warp
constexpr int kTileQ = kWarps * kRows;      // 64 query rows per block
constexpr int kTileK = 32;                  // keys per kv tile: one a lane
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory strides (in floats) for head dim hd.
struct Strides {
  int hq;   // Q rows: hd rounded up to 4 (zero-padded dims)
  int hk;   // K rows: hq, plus 4 if needed to make hk / 4 odd
  __host__ __device__ explicit Strides(int hd) {
    hq = (hd + 3) & ~3;
    hk = ((hq / 4) % 2 == 0) ? hq + 4 : hq;
  }
  __host__ __device__ size_t bytes(int hd) const {
    return sizeof(float) * ((size_t)kTileQ * hq + (size_t)kTileK * hk +
                            (size_t)kTileK * hd + (size_t)kWarps * kRows *
                                                      kTileK);
  }
};

// D = output dims per lane, ceil(hd / 32) rounded up to a power of two.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int tq, int tkv, int h,
    int kvh, int hd, float scale, int causal, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Strides st(hd);
  float* qs = smem;                                    // [kTileQ][hq]
  float* ks = qs + (size_t)kTileQ * st.hq;             // [kTileK][hk]
  float* vs = ks + (size_t)kTileK * st.hk;             // [kTileK][hd]
  float* ps = vs + (size_t)kTileK * hd;                // [kWarps][kRows][32]

  const int q0 = blockIdx.x * kTileQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvi = hi / (h / kvh);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_row = (size_t)h * hd;       // stride of a position in q / o
  const size_t kv_row = (size_t)kvh * hd;    // stride of a position in k / v
  const T* qb = q + (size_t)bi * tq * q_row + (size_t)hi * hd;
  const T* kb = k + (size_t)bi * tkv * kv_row + (size_t)kvi * hd;
  const T* vb = v + (size_t)bi * tkv * kv_row + (size_t)kvi * hd;

  // Q tile, zero outside [0, tq) x [0, hd).
  for (int e = threadIdx.x; e < kTileQ * st.hq; e += kThreads) {
    const int r = e / st.hq, d = e % st.hq;
    const int t = q0 + r;
    qs[e] = (t < tq && d < hd) ? to_f32(qb[(size_t)t * q_row + d]) : 0.f;
  }

  // Keys live for some row of the tile: [lo, hi).
  const int q_last = min(q0 + kTileQ, tq) - 1;
  int kv_hi = causal ? min(tkv, q_last + 1) : tkv;
  int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_lo = (kv_lo / kTileK) * kTileK;

  const int r0 = q0 + warp * kRows;          // the warp's first row
  float m[kRows], l[kRows], acc[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) acc[r][i] = 0.f;
  }
  const float* qw = qs + (size_t)warp * kRows * st.hq;
  float* pw = ps + (size_t)warp * kRows * kTileK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kTileK) {
    __syncthreads();                         // the last tile is consumed
    for (int e = threadIdx.x; e < kTileK * st.hq; e += kThreads) {
      const int j = e / st.hq, d = e % st.hq;
      const int t = k0 + j;
      const bool in = t < tkv && d < hd;
      ks[j * st.hk + d] = in ? to_f32(kb[(size_t)t * kv_row + d]) : 0.f;
      if (d < hd) vs[j * hd + d] = in ? to_f32(vb[(size_t)t * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // Skip a tile masked for all of the warp's rows (warp-uniform).
    const int r_last = r0 + kRows - 1;
    if (r0 >= tq) continue;
    if (causal && k0 > r_last) continue;
    if (window > 0 && k0 + kTileK - 1 <= r0 - window) continue;

    // Scores of key k0 + lane against the warp's rows.
    const int key = k0 + lane;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * st.hk);
    for (int d4 = 0; d4 < st.hq / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            reinterpret_cast<const float4*>(qw + (size_t)r * st.hq)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax, one row at a time.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = r0 + r;
      bool live = key < tkv;
      if (causal) live = live && key <= qpos;
      if (window > 0) live = live && key > qpos - window;
      const float sc = live ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float corr = expf(m[r] - m_new);
      const float p = live ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * corr + p;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[r][i] *= corr;
      m[r] = m_new;
      pw[r * kTileK + lane] = p;
    }
    __syncwarp();

    // acc[r][i] += sum_j p[r][j] * v[j][lane + 32 i].
    for (int j = 0; j < kTileK; j += 4) {
      float vv[4][D];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const int d = lane + 32 * i;
          vv[jj][i] = d < hd ? vs[(j + jj) * hd + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pw + r * kTileK + j);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          acc[r][i] = fmaf(pp.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(pp.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(pp.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(pp.w, vv[3][i], acc[r][i]);
        }
      }
    }
    __syncwarp();                            // p read before it is rewritten
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = r0 + r;
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    if (qpos >= tq) continue;
    T* orow = o + ((size_t)bi * tq + qpos) * q_row + (size_t)hi * hd;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) orow[d] = from_f32<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tkv, int h, int kvh, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t bytes = Strides(hd).bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kTileQ - 1) / kTileQ, h, b);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tkv, h, kvh, hd,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int tq, int tkv, int h, int kvh, int hd, float scale, int causal,
             int window, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, o, b, tq, tkv, h, kvh, hd, scale, causal,
                        window, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, o, b, tq, tkv, h, kvh, hd, scale, causal,
                        window, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, o, b, tq, tkv, h, kvh, hd, scale, causal,
                        window, stream);
  return launch<T, 8>(q, k, v, o, b, tq, tkv, h, kvh, hd, scale, causal,
                      window, stream);
}

}  // namespace

extern "C" {

// q[b, tq, h, hd], k and v[b, tkv, kvh, hd] -> o[b, tq, h, hd]; bf16 != 0
// selects __nv_bfloat16, else float.  hd in [1, 256], h % kvh == 0 (the
// wrapper checks).  Launches on `stream` of `device` and returns the
// cudaError_t of the launch (0 = queued).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int b, int tq, int tkv, int h, int kvh, int hd,
                    float scale, int causal, int window, int bf16,
                    int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b <= 0 || tq <= 0 || h <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, tq, tkv, h, kvh, hd,
                                        scale, causal, window, s)
              : dispatch<float>(q, k, v, o, b, tq, tkv, h, kvh, hd, scale,
                                causal, window, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
