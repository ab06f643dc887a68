// Hand-written Hopper (sm_90a) kernels for the raw-table layer
// (src/repro_torch/kernels/ops.py): the tables are data[n, k] (k-word rows),
// meta[n, 2] (version, mark) and the CacheHash bucket array cells[m, cw].
//
//   seqlock_gather_kernel     replaces src/repro/kernels/seqlock_gather.py::
//                             seqlock_gather (validated k-word gather)
//   cas_apply_round_kernel    replaces src/repro/kernels/cas_apply.py::
//                             cas_apply_round (one STORE/CAS round)
//   cas_apply_rounds          (`RoundsOp` over the segment replay kernels of
//                             segment_replay.cuh) replaces the same kernel
//                             as driven R times by src/repro/kernels/ops.py::
//                             bigatomic_update_rounds: every round in one
//                             launch
//   llsc_commit_round_kernel  replaces src/repro/kernels/llsc_commit.py::
//                             llsc_commit_round (one SC commit round)
//   cachehash_probe_kernel    replaces src/repro/kernels/cachehash_probe.py::
//                             cachehash_probe (inlined first-link probe)
//
// Plain PyTorch versions of all five sit in src/repro_torch/kernels/ref.py;
// the wrappers (seqlock_gather.py, cas_apply.py, llsc_commit.py,
// cachehash_probe.py) validate every operand, allocate the outputs and
// launch these functions through a plain C interface (kernels/_build.py).
//
// Words are 32-bit; the tensors hold int32 bits and the kernels read them
// as uint32_t.  A lane whose row index lies outside the table is dead: zero
// outputs (a CacheHash probe reports an empty bucket with next = -1) and no
// table access.
//
// What bounds them on an H100: memory latency, then the launch.  Each lane
// reads one random row (16 bytes of data plus 8 of meta at k = 4, or one
// 28-byte bucket row), a few lane words, and writes its outputs; at
// p = 16384 lanes that is under 1 MB, a fraction of a microsecond at
// 3.35 TB/s.  The gathers of different lanes are independent, so the
// design is the simplest one that keeps them all in flight: one thread per
// lane, 128 threads a block (128 blocks at p = 16384, about one per SM), the
// row streamed through registers in 16-byte vectors where k % 4 == 0 and
// the pointers are 16-byte aligned, else word by word.
//
// The round kernels (cas_apply, llsc_commit) update the table in place.
// The Pallas kernels wrote every lane's row back, failed and dead lanes
// included, because a TPU has no conditional DMA, and serialised the dead
// lanes' writes to the shared dummy row n.  Here a lane writes only where
// it succeeded, so dead lanes (all on row n) only read it and never race.
// Every lane reads its row before any write of its own; live lanes target
// distinct rows other than n (the caller's contract), so no lane reads a row
// that another lane writes.
//
// cas_apply_rounds takes the op list of `bigatomic_update_rounds`: lanes
// sorted by slot, upd_rank[i] = op i's round.  A lane is live iff
// 0 <= upd_rank < rounds and 0 <= slot < n + 1; the caller's contract is
// that within a round the live slots are distinct, so within a segment
// (a run of equal slots) the live lanes' rounds rise in lane order.  The
// R rounds are then the same as replaying each segment's live lanes in
// lane order, which the segment replay does in one launch: a lane's
// witness is the row before its turn; STORE writes desired; CAS writes iff
// the row equals expected; any other kind reads its witness and fails;
// each write adds 2 to meta[s, 0] (wrapping), the mark is never touched;
// a dirty row is written back once; a lane never live gets success 0 and a
// zero witness.  What bounds it: as the rounds, one row read per segment
// and the lane words, under a microsecond at p = 16384; a hot cell adds
// its walk, a few instructions per op.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "segment_replay.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStore = 1, kCas = 2;
constexpr uint32_t kFull = 1u;

// Row access in units of V words: V = 4 is one 16-byte vector.
template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = uint32_t;
  __device__ static bool eq(T a, T b) { return a == b; }
  __device__ static T zero() { return 0u; }
};
template <>
struct Vec<4> {
  using T = uint4;
  __device__ static bool eq(T a, T b) {
    return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
  }
  __device__ static T zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------------------
// seqlock_gather: vals[i] = data[idx[i]]; ok[i] = version even && mark == 0.
// ---------------------------------------------------------------------------

template <int V>
__global__ void __launch_bounds__(kThreads) seqlock_gather_kernel(
    const uint32_t* __restrict__ data, const uint32_t* __restrict__ meta,
    int n, int k, const int* __restrict__ idx, int q,
    uint32_t* __restrict__ vals, int* __restrict__ ok) {
  using T = typename Vec<V>::T;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int s = idx[i];
  const int kv = k / V;
  T* out = reinterpret_cast<T*>(vals + (size_t)i * k);
  if (s < 0 || s >= n) {
    for (int j = 0; j < kv; ++j) out[j] = Vec<V>::zero();
    ok[i] = 0;
    return;
  }
  const T* row = reinterpret_cast<const T*>(data + (size_t)s * k);
  const uint32_t ver = meta[2 * (size_t)s], mark = meta[2 * (size_t)s + 1];
  for (int j = 0; j < kv; ++j) out[j] = row[j];
  ok[i] = ((ver & 1u) == 0u && mark == 0u) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The two commit rounds: gather the row as the witness, decide, and write
// desired + version + 2 where the lane succeeded.
//   CAS round:  ok = kind in {STORE, CAS} && (STORE || row == expected)
//   SC round:   ok = live != 0 && meta[s, 0] == link_ver
// ---------------------------------------------------------------------------

template <int V, bool SC>
__device__ __forceinline__ void commit_lane(
    int i, uint32_t* __restrict__ data, uint32_t* __restrict__ meta, int n1,
    int k, const int* __restrict__ slot, const int* __restrict__ lane_flag,
    const uint32_t* __restrict__ operand, const uint32_t* __restrict__ desired,
    int* __restrict__ succ, uint32_t* __restrict__ wit) {
  using T = typename Vec<V>::T;
  const int s = slot[i];
  const int kv = k / V;
  T* w = reinterpret_cast<T*>(wit + (size_t)i * k);
  if (s < 0 || s >= n1) {
    for (int j = 0; j < kv; ++j) w[j] = Vec<V>::zero();
    succ[i] = 0;
    return;
  }
  T* row = reinterpret_cast<T*>(data + (size_t)s * k);
  const int flag = lane_flag[i];
  bool ok;
  if constexpr (SC) {
    // operand = link_ver[p]; flag = live
    for (int j = 0; j < kv; ++j) w[j] = row[j];
    ok = flag != 0 && meta[2 * (size_t)s] == operand[i];
  } else {
    // operand = expected[p, k]; flag = kind
    const T* exp = reinterpret_cast<const T*>(operand + (size_t)i * k);
    bool match = true;
    for (int j = 0; j < kv; ++j) {
      const T r = row[j];
      w[j] = r;
      match &= Vec<V>::eq(r, exp[j]);
    }
    ok = flag == kStore || (flag == kCas && match);
  }
  succ[i] = ok ? 1 : 0;
  if (ok) {
    const T* des = reinterpret_cast<const T*>(desired + (size_t)i * k);
    for (int j = 0; j < kv; ++j) row[j] = des[j];
    meta[2 * (size_t)s] += 2u;  // wraps modulo 2^32; the mark is untouched
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads) cas_apply_round_kernel(
    uint32_t* __restrict__ data, uint32_t* __restrict__ meta, int n1, int k,
    const int* __restrict__ slot, const int* __restrict__ kind,
    const uint32_t* __restrict__ expected,
    const uint32_t* __restrict__ desired, int p, int* __restrict__ succ,
    uint32_t* __restrict__ wit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p)
    commit_lane<V, false>(i, data, meta, n1, k, slot, kind, expected, desired,
                          succ, wit);
}

template <int V>
__global__ void __launch_bounds__(kThreads) llsc_commit_round_kernel(
    uint32_t* __restrict__ data, uint32_t* __restrict__ meta, int n1, int k,
    const int* __restrict__ slot, const int* __restrict__ live,
    const uint32_t* __restrict__ link_ver,
    const uint32_t* __restrict__ desired, int p, int* __restrict__ succ,
    uint32_t* __restrict__ wit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < p)
    commit_lane<V, true>(i, data, meta, n1, k, slot, live, link_ver, desired,
                         succ, wit);
}

// ---------------------------------------------------------------------------
// cas_apply_rounds: the segment replay; `aux` is a lane's round.
// ---------------------------------------------------------------------------

struct RoundsOp {
  static constexpr bool kLink = false;
  uint32_t* data;
  uint32_t* meta;
  int n1;
  const int* slot;
  const int* kind;
  const int* rank;
  int rounds;
  const uint32_t* expected;
  const uint32_t* desired;
  uint32_t* out;
  int* succ;

  __device__ bool taken() const { return true; }
  __device__ bool in_table(int s) const { return s >= 0 && s < n1; }
  __device__ uint32_t aux(int g) const { return (uint32_t)rank[g]; }
  __device__ bool live(uint32_t r) const {
    return (int)r >= 0 && (int)r < rounds;
  }
  __device__ uint32_t flags(int kd) const {
    using namespace replay;
    if (kd == kStore) return kWriteAlways | kSuccIfWrote;
    if (kd == kCas) return kWriteIfMatch | kSuccIfWrote;
    return kSuccIfWrote;              // reads its witness and fails
  }
  __device__ uint32_t ver(int s) const { return meta[2 * (size_t)s]; }
  __device__ void set_ver(int s, uint32_t v) const {
    meta[2 * (size_t)s] = v;          // the mark is untouched
  }
  __device__ void out_meta(int g, uint32_t, bool ok) const {
    succ[g] = ok ? 1 : 0;
  }
};

// ---------------------------------------------------------------------------
// cachehash_probe: one bucket row [key kw | value vw | next | flags | ...]
// per query.  hit = flags == FULL && key == query; empty = flags != FULL;
// value = the inlined value; next = the next word as int32 (-1 ends).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) cachehash_probe_kernel(
    const uint32_t* __restrict__ cells, int m, int cw,
    const int* __restrict__ bucket_idx, const uint32_t* __restrict__ query,
    int q, int kw, int vw, int* __restrict__ hit, int* __restrict__ empty,
    uint32_t* __restrict__ value, int* __restrict__ next) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int b = bucket_idx[i];
  uint32_t* val = value + (size_t)i * vw;
  if (b < 0 || b >= m) {
    for (int j = 0; j < vw; ++j) val[j] = 0u;
    hit[i] = 0;
    empty[i] = 1;
    next[i] = -1;
    return;
  }
  const uint32_t* row = cells + (size_t)b * cw;
  const uint32_t* key = query + (size_t)i * kw;
  const bool full = row[kw + vw + 1] == kFull;
  bool match = full;
  for (int j = 0; j < kw; ++j) match &= row[j] == key[j];
  for (int j = 0; j < vw; ++j) val[j] = row[kw + j];
  hit[i] = match ? 1 : 0;
  empty[i] = full ? 0 : 1;
  next[i] = static_cast<int>(row[kw + vw]);
}

// Clear any error left by an earlier call and select the device.
cudaError_t begin(int device) {
  cudaGetLastError();
  return cudaSetDevice(device);
}

dim3 grid_for(int lanes) { return dim3((lanes + kThreads - 1) / kThreads); }

template <bool SC>
int commit_round(void* data, void* meta, int n1, int k, const void* slot,
                 const void* lane_flag, const void* operand,
                 const void* desired, int p, void* succ, void* wit, int device,
                 void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  if (p <= 0) return 0;
  auto* d = static_cast<uint32_t*>(data);
  auto* w = static_cast<uint32_t*>(wit);
  const auto* des = static_cast<const uint32_t*>(desired);
  const auto* opd = static_cast<const uint32_t*>(operand);
  // The CAS round reads `expected` rows as vectors too; the SC round's
  // operand is one word per lane.
  const bool vec = k % 4 == 0 && aligned16(d) && aligned16(w) &&
                   aligned16(des) && (SC || aligned16(opd));
  auto kern = SC ? (vec ? llsc_commit_round_kernel<4>
                        : llsc_commit_round_kernel<1>)
                : (vec ? cas_apply_round_kernel<4> : cas_apply_round_kernel<1>);
  kern<<<grid_for(p), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<uint32_t*>(meta), n1, k, static_cast<const int*>(slot),
      static_cast<const int*>(lane_flag), opd, des, p,
      static_cast<int*>(succ), w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` of `device` and returns the
// cudaError_t of the launch (0 = queued).

// data[n, k], meta[n, 2]; idx[q] -> vals[q, k], ok[q].
int seqlock_gather(const void* data, const void* meta, int n, int k,
                   const void* idx, int q, void* vals, void* ok, int device,
                   void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= 0) return 0;
  const auto* d = static_cast<const uint32_t*>(data);
  auto* v = static_cast<uint32_t*>(vals);
  auto kern = (k % 4 == 0 && aligned16(d) && aligned16(v))
                  ? seqlock_gather_kernel<4>
                  : seqlock_gather_kernel<1>;
  kern<<<grid_for(q), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, static_cast<const uint32_t*>(meta), n, k,
      static_cast<const int*>(idx), q, v, static_cast<int*>(ok));
  return (int)cudaGetLastError();
}

// data[n1, k], meta[n1, 2] updated in place (row n1 - 1 is the dummy);
// slot[p], kind[p], expected[p, k], desired[p, k] -> succ[p], wit[p, k].
int cas_apply_round(void* data, void* meta, int n1, int k, const void* slot,
                    const void* kind, const void* expected,
                    const void* desired, int p, void* succ, void* wit,
                    int device, void* stream) {
  return commit_round<false>(data, meta, n1, k, slot, kind, expected, desired,
                             p, succ, wit, device, stream);
}

// All `rounds` rounds of sorted lanes in one launch: data[n1, k],
// meta[n1, 2] updated in place; slot[p], kind[p], expected[p, k],
// desired[p, k], rank[p] -> succ[p], wit[p, k].
int cas_apply_rounds(void* data, void* meta, int n1, int k, const void* slot,
                     const void* kind, const void* expected,
                     const void* desired, const void* rank, int rounds,
                     int p, void* succ, void* wit, int device,
                     void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  if (p <= 0) return 0;
  const RoundsOp op{static_cast<uint32_t*>(data),
                    static_cast<uint32_t*>(meta),
                    n1,
                    static_cast<const int*>(slot),
                    static_cast<const int*>(kind),
                    static_cast<const int*>(rank),
                    rounds,
                    static_cast<const uint32_t*>(expected),
                    static_cast<const uint32_t*>(desired),
                    static_cast<uint32_t*>(wit),
                    static_cast<int*>(succ)};
  const bool vec = aligned16(data) && aligned16(expected) &&
                   aligned16(desired) && aligned16(wit);
  replay::launch(op, p, k, vec, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// As cas_apply_round, with live[p] and link_ver[p] for kind and expected.
int llsc_commit_round(void* data, void* meta, int n1, int k, const void* slot,
                      const void* live, const void* link_ver,
                      const void* desired, int p, void* succ, void* wit,
                      int device, void* stream) {
  return commit_round<true>(data, meta, n1, k, slot, live, link_ver, desired,
                            p, succ, wit, device, stream);
}

// cells[m, cw]; bucket_idx[q], query[q, kw] -> hit[q], empty[q],
// value[q, vw], next[q].
int cachehash_probe(const void* cells, int m, int cw, const void* bucket_idx,
                    const void* query, int q, int kw, int vw, void* hit,
                    void* empty, void* value, void* next, int device,
                    void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= 0) return 0;
  cachehash_probe_kernel<<<grid_for(q), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cells), m, cw,
      static_cast<const int*>(bucket_idx), static_cast<const uint32_t*>(query),
      q, kw, vw, static_cast<int*>(hit), static_cast<int*>(empty),
      static_cast<uint32_t*>(value), static_cast<int*>(next));
  return (int)cudaGetLastError();
}

const char* table_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
