// Hand-written Hopper (sm_90a) kernels for the fused big-atomic engine round.
//
// fast_round_kernel replaces src/repro/kernels/engine_round.py::
// fast_round_pallas (body _fast_kernel); slow_round_kernel replaces
// slow_round_pallas (body _slow_kernel).  Plain PyTorch versions of both sit
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
// latency and the host work around the round set the pace.
//
// Design, fast round: one thread per lane, the row in registers (at k = 4 a
// row is one 16-byte vector load).  No atomics: the host predicate
// guarantees that live writing lanes target distinct rows, and a read-only
// batch writes nothing.  The row and version are read before the
// conditional write-back.
//
// Design, slow round: lanes arrive sorted by (slot, lane).  One thread per
// cell segment: the thread at a segment start loads the row once, walks its
// lanes in order with full LOAD/STORE/CAS/LL/SC/VALIDATE semantics and
// writes the row back once if any lane wrote.  Segments touch distinct rows,
// so they run in parallel.  The Pallas kernel carried a segment's row across
// grid steps in VMEM, relying on the TPU grid running in order; here a
// segment never leaves its thread, so nothing carries between blocks.  The
// worst case (every lane on one cell) is one thread replaying p ops.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLoad = 0, kStore = 1, kCas = 2, kLl = 4, kSc = 5,
              kValidate = 6;
constexpr int kThreads = 256;

// Load / store K words; VEC = 16-byte vectors (K % 4 == 0, aligned rows).
template <int K, bool VEC>
__device__ __forceinline__ void ld(uint32_t (&r)[K], const uint32_t* src) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = src[j];
  }
}

template <int K, bool VEC>
__device__ __forceinline__ void st(uint32_t* dst, const uint32_t (&r)[K]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) dst[j] = r[j];
  }
}

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
// Slow round: one thread per cell segment of the (slot, lane)-sorted lanes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool lane_success(int kd, bool link_ok, bool okw) {
  return kd == kLoad || kd == kStore || kd == kLl ||
         (kd == kValidate && link_ok) || ((kd == kCas || kd == kSc) && okw);
}

template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads) slow_round_kernel(
    uint32_t* __restrict__ data, uint32_t* __restrict__ version, int n,
    const int* __restrict__ s_slot, const int* __restrict__ s_kind,
    const uint32_t* __restrict__ s_link_ver,
    const uint32_t* __restrict__ s_expected,
    const uint32_t* __restrict__ s_desired, int p, uint32_t* __restrict__ val,
    uint32_t* __restrict__ verpt, int* __restrict__ succ) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p) return;
  const int s = s_slot[g];
  if (s < 0 || s >= n) {
    dead_lane(g, K, val, verpt, succ);
    return;
  }
  if (g > 0 && s_slot[g - 1] == s) return;  // not a segment start
  const size_t ro = (size_t)s * K;
  uint32_t row[K];
  ld<K, VEC>(row, data + ro);
  uint32_t v = version[s];
  bool dirty = false;
  for (int j = g; j < p && s_slot[j] == s; ++j) {
    const size_t lo = (size_t)j * K;
    uint32_t cmp[K];
    ld<K, VEC>(cmp, s_expected + lo);
    bool match = true;
#pragma unroll
    for (int w = 0; w < K; ++w) match &= row[w] == cmp[w];
    const int kd = s_kind[j];
    const bool link_ok = s_link_ver[j] == v;
    const bool okw = kd == kStore || (kd == kCas && match) ||
                     (kd == kSc && link_ok);
    st<K, VEC>(val + lo, row);
    verpt[j] = v;
    succ[j] = lane_success(kd, link_ok, okw) ? 1 : 0;
    if (okw) {
      ld<K, VEC>(row, s_desired + lo);
      v += 2u;
      dirty = true;
    }
  }
  if (dirty) {
    st<K, VEC>(data + ro, row);
    version[s] = v;
  }
}

// Any k: the segment's row is updated in place in memory, word by word.
__global__ void __launch_bounds__(kThreads) slow_round_any(
    uint32_t* __restrict__ data, uint32_t* __restrict__ version, int n, int k,
    const int* __restrict__ s_slot, const int* __restrict__ s_kind,
    const uint32_t* __restrict__ s_link_ver,
    const uint32_t* __restrict__ s_expected,
    const uint32_t* __restrict__ s_desired, int p, uint32_t* __restrict__ val,
    uint32_t* __restrict__ verpt, int* __restrict__ succ) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p) return;
  const int s = s_slot[g];
  if (s < 0 || s >= n) {
    dead_lane(g, k, val, verpt, succ);
    return;
  }
  if (g > 0 && s_slot[g - 1] == s) return;  // not a segment start
  uint32_t* row = data + (size_t)s * k;
  uint32_t v = version[s];
  for (int j = g; j < p && s_slot[j] == s; ++j) {
    const size_t lo = (size_t)j * k;
    bool match = true;
    for (int w = 0; w < k; ++w) {
      val[lo + w] = row[w];
      match &= row[w] == s_expected[lo + w];
    }
    const int kd = s_kind[j];
    const bool link_ok = s_link_ver[j] == v;
    const bool okw = kd == kStore || (kd == kCas && match) ||
                     (kd == kSc && link_ok);
    verpt[j] = v;
    succ[j] = lane_success(kd, link_ok, okw) ? 1 : 0;
    if (okw) {
      for (int w = 0; w < k; ++w) row[w] = s_desired[lo + w];
      v += 2u;
    }
  }
  version[s] = v;
}

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

template <bool SLOW, int K, bool VEC>
void launch_fixed(const Args& a, dim3 grid, cudaStream_t st) {
  auto kern = SLOW ? slow_round_kernel<K, VEC> : fast_round_kernel<K, VEC>;
  kern<<<grid, kThreads, 0, st>>>(a.data, a.version, a.n, a.slot, a.kind,
                                  a.link_ver, a.expected, a.desired, a.p,
                                  a.val, a.verpt, a.ok);
}

template <bool SLOW, int K>
void launch_k(const Args& a, dim3 grid, cudaStream_t st) {
  if constexpr (K % 4 == 0) {
    if (aligned16(a)) return launch_fixed<SLOW, K, true>(a, grid, st);
  }
  launch_fixed<SLOW, K, false>(a, grid, st);
}

template <bool SLOW>
int launch(const Args& a, int device, void* stream) {
  cudaGetLastError();  // clear any error left by an earlier call
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.p <= 0) return 0;
  const dim3 grid((a.p + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.k) {
    case 1: launch_k<SLOW, 1>(a, grid, st); break;
    case 2: launch_k<SLOW, 2>(a, grid, st); break;
    case 3: launch_k<SLOW, 3>(a, grid, st); break;
    case 4: launch_k<SLOW, 4>(a, grid, st); break;
    case 5: launch_k<SLOW, 5>(a, grid, st); break;
    case 6: launch_k<SLOW, 6>(a, grid, st); break;
    case 7: launch_k<SLOW, 7>(a, grid, st); break;
    case 8: launch_k<SLOW, 8>(a, grid, st); break;
    case 16: launch_k<SLOW, 16>(a, grid, st); break;
    default: {
      auto kern = SLOW ? slow_round_any : fast_round_any;
      kern<<<grid, kThreads, 0, st>>>(a.data, a.version, a.n, a.k, a.slot,
                                      a.kind, a.link_ver, a.expected,
                                      a.desired, a.p, a.val, a.verpt, a.ok);
    }
  }
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
