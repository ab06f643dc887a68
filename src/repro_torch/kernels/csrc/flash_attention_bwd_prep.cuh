// The two passes of the bf16 attention backward (flash_attention_bwd_wgmma.cu,
// which includes this header into its anonymous namespace) that need no
// tensor core, written without PTX so that tests/cuda_emu/ compiles them
// with g++ (in fp32 and bf16):
//   attn_bwd_prep      D = rowsum(dO o O), fp32 [b, h, tq]: a warp a row of
//                      [b, tq, h, hd], 16-byte loads; memory-bound (O and
//                      dO read once)
//   attn_bwd_dkdv_sum  dk = scale * the sum of the dK/dV kernel's fp32
//                      partials over its splits of each GQA group, dv the
//                      sum, in T, splits added in order (deterministic)
// Needs <cuda_runtime.h> and <cuda_bf16.h> (or the emulator's) first.

// Faults a check can plant (`fault` of the entry point; 0 in use).
enum Fault { kNone = 0, kNoD = 1, kOneHead = 2, kCausalOffByOne = 3 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <class T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kPassThreads = 256;

// o, dout [b, tq, h, hd] contiguous, hd * sizeof(T) a multiple of 16 and
// both 16-byte aligned -> dsum [b, h, tq].
template <class T>
__global__ void __launch_bounds__(kPassThreads) attn_bwd_prep(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ dsum, int b, int tq, int h, int hd, int fault) {
  constexpr int kPer = 16 / sizeof(T);          // elements a 16-byte load
  const long row = ((long)blockIdx.x * kPassThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)b * tq * h) return;          // the whole warp
  const size_t base = (size_t)row * hd;
  float acc = 0.f;
  for (int u = lane; u < hd / kPer; u += 32) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + base + u * kPer);
    const uint4 y = *reinterpret_cast<const uint4*>(dout + base + u * kPer);
    const T* xs = reinterpret_cast<const T*>(&x);
    const T* ys = reinterpret_cast<const T*>(&y);
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc += to_float(xs[e]) * to_float(ys[e]);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int head = (int)(row % h);
    const long t = row / h % tq, bi = row / ((long)h * tq);
    dsum[((size_t)bi * h + head) * tq + t] = fault == kNoD ? 0.f : acc;
  }
}

// parts: dK's partials [splits, n] then dV's [splits, n], fp32.
template <class T>
__global__ void __launch_bounds__(kPassThreads) attn_bwd_dkdv_sum(
    const float* __restrict__ parts, T* __restrict__ dk, T* __restrict__ dv,
    long n, int splits, float scale) {
  const float* dv_parts = parts + (size_t)splits * n;
  for (long i = (long)blockIdx.x * kPassThreads + threadIdx.x; i < n;
       i += (long)gridDim.x * kPassThreads) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < splits; ++s) {
      a += parts[(size_t)s * n + i];
      c += dv_parts[(size_t)s * n + i];
    }
    dk[i] = from_float<T>(a * scale);
    dv[i] = from_float<T>(c);
  }
}

template <class T>
cudaError_t launch_prep(const void* o, const void* dout, float* dsum, int b,
                        int tq, int h, int hd, int fault,
                        cudaStream_t stream) {
  const long rows = (long)b * tq * h;
  if (rows == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((rows + kPassThreads / 32 - 1) /
                                     (kPassThreads / 32));
  attn_bwd_prep<T><<<blocks, kPassThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dsum, b, tq, h,
      hd, fault);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_dkdv_sum(const float* parts, void* dk, void* dv, long n,
                            int splits, float scale, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const long want = (n + kPassThreads - 1) / kPassThreads;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  attn_bwd_dkdv_sum<T><<<blocks, kPassThreads, 0, stream>>>(
      parts, static_cast<T*>(dk), static_cast<T*>(dv), n, splits, scale);
  return cudaGetLastError();
}
