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
//   cachehash_kernel          <KW, VW, false> replaces src/repro/kernels/
//                             cachehash_probe.py::cachehash_probe (inlined
//                             first-link probe); <KW, VW, true> is the whole
//                             of src/repro/kernels/ops.py::cachehash_find
//                             (hash, probe, chain walk) in one launch
//
// Plain PyTorch versions of all six sit in src/repro_torch/kernels/ref.py;
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
// the pointers are 16-byte aligned, else word by word.  A lane's time is
// its chain of dependent memory trips, so every load that does not depend
// on an earlier one is issued with the first: the commit rounds take two
// trips (the lane's words with its slot, then the row with its version),
// the probe two (the key with the bucket index, then the whole row), the
// find one for the key, one for the bucket row and one a chain step.  The
// CacheHash kernel is instantiated for the (kw, vw) the port uses, so a
// row's words are loaded as one batch; any other shape runs at run-time
// widths.
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
// One memory trip after the index: nvcc issues the row's loads and the
// meta pair together, before the first store.  Fixed row widths, an
// 8-byte meta load, `__ldg` / `__stcs` and a select for dead lanes were
// no faster on an H100 (PERF.md §6).
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

// A lane holds up to 16 words of each row it needs in registers (kHeld
// vectors of V words); the words of a wider row past those are read where
// they are used.
template <int V>
constexpr int kHeld = 16 / V;

// Two memory trips a lane: first the slot with every lane word that
// depends only on i (the flag, link_ver or the expected row, the desired
// row), then the row with its version, together.  The stores follow the
// test.
template <int V, bool SC>
__device__ __forceinline__ void commit_lane(
    int i, uint32_t* __restrict__ data, uint32_t* __restrict__ meta, int n1,
    int k, const int* __restrict__ slot, const int* __restrict__ lane_flag,
    const uint32_t* __restrict__ operand, const uint32_t* __restrict__ desired,
    int* __restrict__ succ, uint32_t* __restrict__ wit) {
  using T = typename Vec<V>::T;
  constexpr int H = kHeld<V>;
  const int kv = k / V;
  // trip 1: operand = link_ver[p], flag = live (SC); operand =
  // expected[p, k], flag = kind (CAS)
  const int s = slot[i];
  const int flag = lane_flag[i];
  const uint32_t link = SC ? operand[i] : 0u;
  const T* des = reinterpret_cast<const T*>(desired + (size_t)i * k);
  const T* exp = reinterpret_cast<const T*>(operand + (size_t)i * k);
  T d[H], e[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    if (j < kv) {
      d[j] = des[j];
      if constexpr (!SC) e[j] = exp[j];
    }
  T* w = reinterpret_cast<T*>(wit + (size_t)i * k);
  if (s < 0 || s >= n1) {
    for (int j = 0; j < kv; ++j) w[j] = Vec<V>::zero();
    succ[i] = 0;
    return;
  }
  // trip 2: the row and its version
  T* row = reinterpret_cast<T*>(data + (size_t)s * k);
  const uint32_t ver = meta[2 * (size_t)s];
  T r[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    if (j < kv) r[j] = row[j];
  bool match = true;
#pragma unroll
  for (int j = 0; j < H; ++j)
    if (j < kv) {
      w[j] = r[j];
      if constexpr (!SC) match &= Vec<V>::eq(r[j], e[j]);
    }
  for (int j = H; j < kv; ++j) {             // a row wider than 16 words
    const T x = row[j];
    w[j] = x;
    if constexpr (!SC) match &= Vec<V>::eq(x, exp[j]);
  }
  const bool ok = SC ? flag != 0 && ver == link
                     : flag == kStore || (flag == kCas && match);
  succ[i] = ok ? 1 : 0;
  if (ok) {
#pragma unroll
    for (int j = 0; j < H; ++j)
      if (j < kv) row[j] = d[j];
    for (int j = H; j < kv; ++j) row[j] = des[j];
    meta[2 * (size_t)s] = ver + 2u;  // wraps modulo 2^32; the mark is untouched
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
// CacheHash: bucket rows and chain nodes [key kw | value vw | next | flags |
// ...], cw words each.
//   probe (FIND = false): the bucket index given; hit = flags == FULL &&
//     key == query; empty = flags != FULL; value = the inlined value; next
//     = the next word as int32 (-1 ends).  A bucket outside [0, m) is a
//     dead lane: hit 0, empty 1, zero value, next -1.
//   find (FIND = true): ops.cachehash_find in one thread.  The key hashed
//     in registers (ops.hash_keys), the bucket probed as above, then the
//     chain walked for at most max_chain steps: a node is
//     pool[min(cur, c - 1)] (the plain version's clamped gather), a step
//     hits on the key alone, and the walk ends on a hit or a next < 0.
//     found = a hit anywhere; value = the hit's value, else the bucket's
//     inlined value.
// ---------------------------------------------------------------------------

constexpr uint32_t kGolden = 0x9E3779B1u;

struct HashArgs {
  const uint32_t* cells;
  int m, cw;
  const uint32_t* pool;          // find: c chain nodes of cw words
  int c, max_chain;
  const int* bucket_idx;         // probe
  const uint32_t* query;
  int q, kw, vw;
  int* hit;                      // probe
  int* empty;
  int* next;
  bool* found;                   // find
  uint32_t* value;
};

// The lane's key.  With the widths as template arguments (KW > 0) its words
// sit in registers; at run-time widths (KW = 0) each is read where it is
// used.
template <int KW>
struct Key {
  uint32_t w[KW];
  __device__ explicit Key(const uint32_t* p) {
#pragma unroll
    for (int j = 0; j < KW; ++j) w[j] = p[j];
  }
  __device__ uint32_t operator[](int j) const { return w[j]; }
};
template <>
struct Key<0> {
  const uint32_t* p;
  __device__ explicit Key(const uint32_t* q) : p(q) {}
  __device__ uint32_t operator[](int j) const { return p[j]; }
};

// A row the lane reads.  With the widths known, all KW + VW + 2 words are
// loaded before the first is used, one batch of independent loads: a row
// across a 32-byte sector costs one memory trip, not two.
template <int KW, int VW>
struct Row {
  uint32_t w[KW + VW + 2];
  __device__ Row(const uint32_t* p, int, int) {
#pragma unroll
    for (int j = 0; j < KW + VW + 2; ++j) w[j] = p[j];
  }
  __device__ bool holds(const Key<KW>& key) const {
    bool eq = true;
#pragma unroll
    for (int j = 0; j < KW; ++j) eq &= w[j] == key[j];
    return eq;
  }
  // r's words where `yes`, a select and not a branch: nvcc sinks the loads
  // a branch guards behind the compare, one more trip
  __device__ void take(const Row& r, bool yes) {
#pragma unroll
    for (int j = 0; j < KW + VW + 2; ++j) w[j] = yes ? r.w[j] : w[j];
  }
  __device__ uint32_t value(int j) const { return w[KW + j]; }
  __device__ int next() const { return static_cast<int>(w[KW + VW]); }
  __device__ uint32_t flags() const { return w[KW + VW + 1]; }
};
template <int VW>
struct Row<0, VW> {
  const uint32_t* p;
  int kw, vw;
  __device__ Row(const uint32_t* r, int kw_, int vw_)
      : p(r), kw(kw_), vw(vw_) {}
  __device__ bool holds(const Key<0>& key) const {
    bool eq = true;
    for (int j = 0; j < kw; ++j) eq &= p[j] == key[j];
    return eq;
  }
  __device__ void take(const Row& r, bool yes) { p = yes ? r.p : p; }
  __device__ uint32_t value(int j) const { return p[kw + j]; }
  __device__ int next() const { return static_cast<int>(p[kw + vw]); }
  __device__ uint32_t flags() const { return p[kw + vw + 1]; }
};

template <int KW, int VW, bool FIND>
__global__ void __launch_bounds__(kThreads) cachehash_kernel(
    const HashArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.q) return;
  const int kw = KW ? KW : a.kw, vw = KW ? VW : a.vw;
  // the lane's own words first: its key, and the probe's bucket index
  const Key<KW> key(a.query + (size_t)i * kw);
  int b;
  if constexpr (FIND) {
    uint32_t h = 0u;
    for (int j = 0; j < kw; ++j) {
      h = (h ^ key[j]) * kGolden;
      h ^= h >> 15;
    }
    b = static_cast<int>(h % static_cast<uint32_t>(a.m));
  } else {
    b = a.bucket_idx[i];
  }
  uint32_t* val = a.value + (size_t)i * vw;
  if (!FIND && (b < 0 || b >= a.m)) {
    for (int j = 0; j < vw; ++j) val[j] = 0u;
    a.hit[i] = 0;
    a.empty[i] = 1;
    a.next[i] = -1;
    return;
  }
  const Row<KW, VW> row(a.cells + (size_t)b * a.cw, kw, vw);
  // `&`, not `&&`: with `&&` nvcc loads the key words only once the flags
  // word is in, a third trip
  const bool full = row.flags() == kFull;
  bool hit = full & row.holds(key);
  if constexpr (!FIND) {
    for (int j = 0; j < vw; ++j) val[j] = row.value(j);
    a.hit[i] = hit ? 1 : 0;
    a.empty[i] = full ? 0 : 1;
    a.next[i] = row.next();
  } else {
    Row<KW, VW> src = row;           // the row the value comes from
    int cur = row.next();
    if (full && !hit && cur >= 0) {
      for (int t = 0; t < a.max_chain; ++t) {  // a dependent trip a step
        const Row<KW, VW> node(a.pool + (size_t)min(cur, a.c - 1) * a.cw, kw,
                               vw);
        const bool step_hit = node.holds(key);
        src.take(node, step_hit);
        if (step_hit) {
          hit = true;
          break;
        }
        cur = node.next();
        if (cur < 0) break;
      }
    }
    for (int j = 0; j < vw; ++j) val[j] = src.value(j);
    a.found[i] = hit;
  }
}

// Clear any error left by an earlier call and select the device.
cudaError_t begin(int device) {
  cudaGetLastError();
  return cudaSetDevice(device);
}

dim3 grid_for(int lanes) { return dim3((lanes + kThreads - 1) / kThreads); }

// The kernel for (kw, vw): one of each shape the port uses, the run-time
// widths for any other.
template <bool FIND>
int launch_hash(const HashArgs& a, cudaStream_t stream) {
  using Kernel = void (*)(const HashArgs);
  static const struct {
    int kw, vw;
    Kernel kern;
  } kShapes[] = {{1, 1, cachehash_kernel<1, 1, FIND>},
                 {2, 2, cachehash_kernel<2, 2, FIND>},
                 {4, 2, cachehash_kernel<4, 2, FIND>},
                 {1, 3, cachehash_kernel<1, 3, FIND>}};
  Kernel kern = cachehash_kernel<0, 0, FIND>;
  for (const auto& shape : kShapes)
    if (shape.kw == a.kw && shape.vw == a.vw) kern = shape.kern;
  kern<<<grid_for(a.q), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

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
  HashArgs a{};
  a.cells = static_cast<const uint32_t*>(cells);
  a.m = m;
  a.cw = cw;
  a.bucket_idx = static_cast<const int*>(bucket_idx);
  a.query = static_cast<const uint32_t*>(query);
  a.q = q;
  a.kw = kw;
  a.vw = vw;
  a.hit = static_cast<int*>(hit);
  a.empty = static_cast<int*>(empty);
  a.next = static_cast<int*>(next);
  a.value = static_cast<uint32_t*>(value);
  return launch_hash<false>(a, static_cast<cudaStream_t>(stream));
}

// cells[m, cw], chain_pool[c, cw]; query[q, kw] -> found[q] (bool),
// value[q, vw]: the whole lookup, chains walked for at most max_chain
// steps.  An empty table (m = 0), or an empty pool with max_chain > 0, is
// an invalid value (the wrapper raises first, as the plain version does).
int cachehash_find(const void* cells, int m, int cw, const void* chain_pool,
                   int c, const void* query, int q, int kw, int vw,
                   int max_chain, void* found, void* value, int device,
                   void* stream) {
  cudaError_t err = begin(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= 0) return 0;
  if (m <= 0 || (c <= 0 && max_chain > 0)) return (int)cudaErrorInvalidValue;
  HashArgs a{};
  a.cells = static_cast<const uint32_t*>(cells);
  a.m = m;
  a.cw = cw;
  a.pool = static_cast<const uint32_t*>(chain_pool);
  a.c = c;
  a.max_chain = max_chain;
  a.query = static_cast<const uint32_t*>(query);
  a.q = q;
  a.kw = kw;
  a.vw = vw;
  a.found = static_cast<bool*>(found);
  a.value = static_cast<uint32_t*>(value);
  return launch_hash<true>(a, static_cast<cudaStream_t>(stream));
}

const char* table_ops_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
