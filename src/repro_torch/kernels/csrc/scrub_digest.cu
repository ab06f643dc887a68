// Hand-written Hopper (sm_90a) kernel for the integrity scrub
// (src/repro_torch/guard/scrub.py::cell_digest): the per-cell FNV-1a digest
// of a big-atomic table.
//
//   digest_rows_kernel   replaces src/repro/guard/scrub.py::_digest_pallas
//
// For cell i with logical row vals[i, 0..k) and version ver[i]:
//   h = 2166136261; for each word w: h = (h ^ w) * 16777619;
//   out[i] = (h ^ ver[i]) * 16777619
// all in uint32 with wraparound.  The tensors hold int32 bits; the kernel
// reads them as uint32_t.  The plain PyTorch version is
// kernels/scrub_digest.py::digest_rows_plain; the wrapper `digest_rows`
// validates the operands and launches this through a plain C interface
// (kernels/_build.py).
//
// What bounds it on an H100: bytes.  Unlike the engine-round and table
// kernels, which touch a few hundred KB of random rows, the digest streams
// the whole table once: at n = 2^22, k = 4 it reads 64 MiB of rows and
// 16 MiB of versions and writes 16 MiB of digests, about 100.7 MB, or
// 30 us at 3.35 TB/s -- the first bound among the port's kernels that is
// not below the launch latency.  The design keeps every byte moving once
// and coalesced: one thread per cell, the row read as 16-byte vectors
// where k % 4 == 0 (so neighbouring threads read neighbouring 16-byte
// pieces of consecutive rows), the chain in registers, one word written.
// The Pallas kernel's blocks of 8 rows and their padding do not carry over.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kOffset = 2166136261u;
constexpr uint32_t kPrime = 16777619u;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads) digest_rows_kernel(
    const uint32_t* __restrict__ vals, const uint32_t* __restrict__ ver,
    int n, int k, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h = kOffset;
  if (kVec4) {
    const uint4* row = reinterpret_cast<const uint4*>(vals + (size_t)i * k);
    for (int j = 0; j < k / 4; ++j) {
      const uint4 w = __ldg(row + j);
      h = (h ^ w.x) * kPrime;
      h = (h ^ w.y) * kPrime;
      h = (h ^ w.z) * kPrime;
      h = (h ^ w.w) * kPrime;
    }
  } else {
    const uint32_t* row = vals + (size_t)i * k;
    for (int j = 0; j < k; ++j) h = (h ^ __ldg(row + j)) * kPrime;
  }
  out[i] = (h ^ __ldg(ver + i)) * kPrime;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// vals[n, k], ver[n] -> out[n].  Launches on `stream` of `device` and
// returns the cudaError_t of the launch (0 = queued).
int digest_rows(const void* vals, const void* ver, int n, int k, void* out,
                int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  const auto* v = static_cast<const uint32_t*>(vals);
  auto kern = (k % 4 == 0 && aligned16(v)) ? digest_rows_kernel<true>
                                           : digest_rows_kernel<false>;
  kern<<<(n + kThreads - 1) / kThreads, kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
      v, static_cast<const uint32_t*>(ver), n, k,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

const char* scrub_digest_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
