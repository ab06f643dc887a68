// Hand-written Hopper (sm_90a) kernels for the fused big-atomic engine round.
//
// fast_round_kernel replaces src/repro/kernels/engine_round.py::
// fast_round_pallas (body _fast_kernel); the slow round (`SlowOp` over the
// segment replay kernels of segment_replay.cuh) replaces slow_round_pallas
// (body _slow_kernel).  Plain PyTorch versions of both sit
// in src/repro_torch/kernels/engine_round.py and core/engine.py; the wrappers
// there validate every operand, allocate the outputs and launch these
// functions through a plain C interface (built by kernels/_build.py).
//
// Words are 32-bit; the tensors hold int32 bits and the kernels read them as
// uint32_t.  A lane whose slot lies outside [0, n) is dead: zero outputs,
// success 0, no table access.
//
// What bounds them on an H100: memory.  A lane moves its op words (slot,
// kind, link version, expected, desired: 12 + 8k bytes), its outputs
// (8 + 4k bytes) and one random table row plus its version (4k + 4 bytes,
// one 32-byte sector each at k <= 8), written back only where it wrote.  At
// p = 16384 that is a few MB, under a microsecond at 3.35 TB/s, so launch
// latency and the host work around the round set the pace; in the slow
// round a long segment adds its 32-lane chunks, resolved one after another.
//
// Design, fast round: one thread per lane, the row in registers (at k = 4 a
// row is one 16-byte vector load).  No atomics: the host predicate
// guarantees that live writing lanes target distinct rows, and a read-only
// batch writes nothing.  The row and version are read before the
// conditional write-back.
//
// Design, slow round: lanes arrive sorted by (slot, lane).  The segment
// replay of `segment_replay.cuh`: a warp per 32-lane window (k = 1-8, 16),
// which loads and compares what does not depend on the running state in
// parallel and finds which lanes write as a fixed point over the warp's
// write mask; a segment that runs past its window stays with its warp,
// chunk by chunk.  Any other k
// keeps one thread per segment.  Segments touch distinct rows, so they run
// in parallel; each dirty row is written back once.  The Pallas kernel
// carried a segment's row across grid steps in VMEM, relying on the TPU
// grid running in order; here a segment never leaves its warp, so nothing
// carries between blocks.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "segment_replay.cuh"

namespace {

using replay::ld;
using replay::st;

constexpr int kLoad = 0, kStore = 1, kCas = 2, kLl = 4, kSc = 5,
              kValidate = 6;
constexpr int kThreads = 256;

__device__ __forceinline__ void dead_lane(int i, int k, uint32_t* val,
                                          uint32_t* verpt, int* ok) {
  for (int j = 0; j < k; ++j) val[(size_t)i * k + j] = 0u;
  verpt[i] = 0u;
  ok[i] = 0;
}

// ---------------------------------------------------------------------------
// Fast round: one thread per lane.
// ---------------------------------------------------------------------------

template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads) fast_round_kernel(
    uint32_t* __restrict__ data, uint32_t* __restrict__ version, int n,
    const int* __restrict__ slot, const int* __restrict__ kind,
    const uint32_t* __restrict__ link_ver,
    const uint32_t* __restrict__ expected,
    const uint32_t* __restrict__ desired, int p, uint32_t* __restrict__ wit,
    uint32_t* __restrict__ verpt, int* __restrict__ okw_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int s = slot[i];
  if (s < 0 || s >= n) {
    dead_lane(i, K, wit, verpt, okw_out);
    return;
  }
  const size_t ro = (size_t)s * K, lo = (size_t)i * K;
  uint32_t row[K], cmp[K];
  ld<K, VEC>(row, data + ro);
  const uint32_t v = version[s];
  ld<K, VEC>(cmp, expected + lo);
  bool match = true;
#pragma unroll
  for (int j = 0; j < K; ++j) match &= row[j] == cmp[j];
  const int kd = kind[i];
  const bool okw = kd == kStore || (kd == kCas && match) ||
                   (kd == kSc && link_ver[i] == v);
  st<K, VEC>(wit + lo, row);
  verpt[i] = v;
  okw_out[i] = okw ? 1 : 0;
  if (okw) {
    uint32_t des[K];
    ld<K, VEC>(des, desired + lo);
    st<K, VEC>(data + ro, des);
    version[s] = v + 2u;
  }
}

// Any k: the same, word by word from memory.
__global__ void __launch_bounds__(kThreads) fast_round_any(
    uint32_t* __restrict__ data, uint32_t* __restrict__ version, int n, int k,
    const int* __restrict__ slot, const int* __restrict__ kind,
    const uint32_t* __restrict__ link_ver,
    const uint32_t* __restrict__ expected,
    const uint32_t* __restrict__ desired, int p, uint32_t* __restrict__ wit,
    uint32_t* __restrict__ verpt, int* __restrict__ okw_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const int s = slot[i];
  if (s < 0 || s >= n) {
    dead_lane(i, k, wit, verpt, okw_out);
    return;
  }
  const size_t ro = (size_t)s * k, lo = (size_t)i * k;
  const uint32_t v = version[s];
  bool match = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t w = data[ro + j];
    wit[lo + j] = w;
    match &= w == expected[lo + j];
  }
  const int kd = kind[i];
  const bool okw = kd == kStore || (kd == kCas && match) ||
                   (kd == kSc && link_ver[i] == v);
  verpt[i] = v;
  okw_out[i] = okw ? 1 : 0;
  if (okw) {
    for (int j = 0; j < k; ++j) data[ro + j] = desired[lo + j];
    version[s] = v + 2u;
  }
}

// ---------------------------------------------------------------------------
// Slow round: the segment replay over the (slot, lane)-sorted lanes.
// ---------------------------------------------------------------------------

// Every in-table lane takes part; `aux` is its link version.
struct SlowOp {
  static constexpr bool kLink = true;
  uint32_t* data;
  uint32_t* version;
  int n;
  const int* slot;
  const int* kind;
  const uint32_t* link_ver;
  const uint32_t* expected;
  const uint32_t* desired;
  uint32_t* out;
  uint32_t* verpt;
  int* succ;

  __device__ bool in_table(int s) const { return s >= 0 && s < n; }
  __device__ uint32_t aux(int g) const { return link_ver[g]; }
  __device__ bool live(uint32_t) const { return true; }
  __device__ uint32_t flags(int kd) const {
    using namespace replay;
    switch (kd) {
      case kLoad:
      case kLl: return kSuccAlways;
      case kStore: return kWriteAlways | kSuccAlways;
      case kCas: return kWriteIfMatch | kSuccIfWrote;
      case kSc: return kWriteIfLink | kSuccIfWrote;
      case kValidate: return kSuccIfLink;
      default: return 0u;            // IDLE: reads, fails
    }
  }
  __device__ uint32_t ver(int s) const { return version[s]; }
  __device__ void set_ver(int s, uint32_t v) const { version[s] = v; }
  __device__ void out_meta(int g, uint32_t v, bool ok) const {
    verpt[g] = v;
    succ[g] = ok ? 1 : 0;
  }
};

// ---------------------------------------------------------------------------
// Host-side dispatch on k (compile-time row widths where it pays).
// ---------------------------------------------------------------------------

struct Args {
  uint32_t* data;
  uint32_t* version;
  int n, k;
  const int* slot;
  const int* kind;
  const uint32_t* link_ver;
  const uint32_t* expected;
  const uint32_t* desired;
  int p;
  uint32_t* val;
  uint32_t* verpt;
  int* ok;
};

bool aligned16(const Args& a) {
  auto al = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
  };
  return al(a.data) && al(a.expected) && al(a.desired) && al(a.val);
}

template <int K, bool VEC>
void launch_fast_fixed(const Args& a, dim3 grid, cudaStream_t st) {
  fast_round_kernel<K, VEC><<<grid, kThreads, 0, st>>>(
      a.data, a.version, a.n, a.slot, a.kind, a.link_ver, a.expected,
      a.desired, a.p, a.val, a.verpt, a.ok);
}

template <int K>
void launch_fast_k(const Args& a, dim3 grid, cudaStream_t st) {
  if constexpr (K % 4 == 0) {
    if (aligned16(a)) return launch_fast_fixed<K, true>(a, grid, st);
  }
  launch_fast_fixed<K, false>(a, grid, st);
}

void launch_fast(const Args& a, cudaStream_t st) {
  const dim3 grid((a.p + kThreads - 1) / kThreads);
  switch (a.k) {
    case 1: launch_fast_k<1>(a, grid, st); break;
    case 2: launch_fast_k<2>(a, grid, st); break;
    case 3: launch_fast_k<3>(a, grid, st); break;
    case 4: launch_fast_k<4>(a, grid, st); break;
    case 5: launch_fast_k<5>(a, grid, st); break;
    case 6: launch_fast_k<6>(a, grid, st); break;
    case 7: launch_fast_k<7>(a, grid, st); break;
    case 8: launch_fast_k<8>(a, grid, st); break;
    case 16: launch_fast_k<16>(a, grid, st); break;
    default:
      fast_round_any<<<grid, kThreads, 0, st>>>(
          a.data, a.version, a.n, a.k, a.slot, a.kind, a.link_ver,
          a.expected, a.desired, a.p, a.val, a.verpt, a.ok);
  }
}

void launch_slow(const Args& a, cudaStream_t st) {
  const SlowOp op{a.data, a.version, a.n, a.slot, a.kind, a.link_ver,
                  a.expected, a.desired, a.val, a.verpt, a.ok};
  replay::launch(op, a.p, a.k, aligned16(a), st);
}

template <bool SLOW>
int launch(const Args& a, int device, void* stream) {
  cudaGetLastError();  // clear any error left by an earlier call
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.p <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (SLOW)
    launch_slow(a, st);
  else
    launch_fast(a, st);
  return (int)cudaGetLastError();
}

Args make_args(void* data, void* version, int n, int k, const void* slot,
               const void* kind, const void* link_ver, const void* expected,
               const void* desired, int p, void* val, void* verpt, void* ok) {
  return Args{static_cast<uint32_t*>(data),
              static_cast<uint32_t*>(version),
              n,
              k,
              static_cast<const int*>(slot),
              static_cast<const int*>(kind),
              static_cast<const uint32_t*>(link_ver),
              static_cast<const uint32_t*>(expected),
              static_cast<const uint32_t*>(desired),
              p,
              static_cast<uint32_t*>(val),
              static_cast<uint32_t*>(verpt),
              static_cast<int*>(ok)};
}

}  // namespace

extern "C" {

// Both entry points: table (data[n, k], version[n]) updated in place; lane
// arrays of width p; outputs val[p, k], verpt[p], ok[p].  Launch on
// `stream` of `device`; returns the cudaError_t of the launch (0 = queued).
int fast_round(void* data, void* version, int n, int k, const void* slot,
               const void* kind, const void* link_ver, const void* expected,
               const void* desired, int p, void* val, void* verpt, void* ok,
               int device, void* stream) {
  return launch<false>(make_args(data, version, n, k, slot, kind, link_ver,
                                 expected, desired, p, val, verpt, ok),
                       device, stream);
}

int slow_round(void* data, void* version, int n, int k, const void* slot,
               const void* kind, const void* link_ver, const void* expected,
               const void* desired, int p, void* val, void* verpt, void* ok,
               int device, void* stream) {
  return launch<true>(make_args(data, version, n, k, slot, kind, link_ver,
                                expected, desired, p, val, verpt, ok),
                      device, stream);
}

const char* engine_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
