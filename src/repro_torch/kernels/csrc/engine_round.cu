// Hand-written Hopper (sm_90a) kernels for the fused big-atomic engine round.
//
// fast_round_kernel replaces src/repro/kernels/engine_round.py::
// fast_round_pallas (body _fast_kernel) and the host-side assembly of its
// results (_assemble_fast); the slow round (`SlowOp` over the segment
// replay kernels of segment_replay.cuh) replaces slow_round_pallas (body
// _slow_kernel); round_prologue_kernel replaces the host code before both
// (fast_path_ok and its n-sized count array, the gathers into the sorted
// order); round_epilogue_kernel the host code after both (engine.rebuild,
// stats_on_sorted) and the layouts' whole-table diff of the versions.
// Plain PyTorch versions of all four sit in
// src/repro_torch/kernels/engine_round.py and core/engine.py; the wrappers
// there validate every operand, allocate the outputs and launch these
// functions through a plain C interface (built by kernels/_build.py).
//
// The branch is taken on the device: every round launches all four
// kernels; the prologue writes the predicate `fast`, which nothing reads
// back, and each kernel after it returns at once when its branch is not
// taken.  So a round is a fixed sequence of launches with no host sync,
// which a CUDA graph can capture.
//
// Words are 32-bit; the tensors hold int32 bits and the kernels read them as
// uint32_t.  A lane whose slot lies outside [0, n) is dead: zero outputs,
// success 0, no table access.
//
// What bounds them on an H100: memory.  A lane moves its op words (slot,
// kind, expected, desired, its link: 16 + 12k bytes), its outputs (value,
// success, the new link, okw: ~14 + 8k bytes) and one random table row plus
// its version (4k + 4 bytes, one 32-byte sector each at k <= 8), written
// back only where it wrote.  At p = 16384 that is a few MB, a microsecond
// or two at 3.35 TB/s, so the launch and the host work around the round
// set the pace; in the slow round a long segment adds its 32-lane chunks,
// resolved one after another; in the epilogue, the one block that walks
// the whole sorted order.
//
// Design, prologue: one thread per sorted lane gathers its lane's operands
// into the sorted order and finds the predicate's three facts; a block ORs
// them (__syncthreads_or), one atomic a block meets the others, and the
// last block to finish decodes them into the flag.
//
// Design, fast round: one thread per lane, the row in registers (at k = 4 a
// row is one 16-byte vector load).  No atomics: the predicate guarantees
// that live writing lanes target distinct rows, and a read-only batch
// writes nothing.  The row and version are read before the conditional
// write-back.  The lane's link version is computed from its link in
// registers, and its results and new link are written in lane order, so no
// PyTorch operation follows it.
//
// Design, slow round: lanes arrive sorted by (slot, lane).  The segment
// replay of `segment_replay.cuh`: a warp per 32-lane window (k = 1-8, 16),
// which loads and compares what does not depend on the running state in
// parallel and finds which lanes write as a fixed point over the warp's
// write mask; a segment that runs past its window stays with its warp,
// chunk by chunk.  Any other k keeps one thread per segment.  Segments
// touch distinct rows, so they run in parallel; each dirty row is written
// back once.  The Pallas kernel carried a segment's row across grid steps
// in VMEM, relying on the TPU grid running in order; here a segment never
// leaves its warp, so nothing carries between blocks.
//
// Design, epilogue: one launch: ceil(p / 1024) lane blocks, then one scan
// block (1024 threads) per tile of 2048 sorted lanes.  A lane block (slow
// branch only) puts each sorted lane's replay outputs back at its lane
// (order[i]) with its new link.  A scan block stages its tile in shared
// memory with coalesced loads, summarises each thread's two lanes (the
// updates since the segment's start, the loads since the last write, the
// dirty cells), scans the summaries over the block, and meets the tiles
// before it by a decoupled look-back (it publishes its aggregate at once
// and combines the published ones back to the first inclusive prefix, so
// the tiles wait on each other for a few L2 round trips, not in a chain).
// That gives every lane its running state: the stats follow, and each
// dirty cell's rank, so the dirty cells come out in ascending slot order.
// A cell is dirty where a lane wrote it, known at its segment's first lane
// from the fast round's okw or the version the replay moved.  The stats
// meet by atomics, and the last scan block to finish writes them and pads
// the list.  (One block walking all 16384 lanes staged 8192 at a time
// took 25 us on the H100, bound by one SM's instruction rate; these
// blocks take 14-23 us, a chain of global round trips and fences.)

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "segment_replay.cuh"

namespace {

using replay::ld;
using replay::st;

constexpr int kLoad = 0, kStore = 1, kCas = 2, kIdle = 3, kLl = 4, kSc = 5,
              kValidate = 6;
constexpr int kThreads = 256;
constexpr int kEpilogueThreads = 1024;

// ---------------------------------------------------------------------------
// Prologue: the predicate and the replay's sorted lane operands.
// ---------------------------------------------------------------------------

struct PrologueArgs {
  int n, k, p;
  const int64_t* order;
  const int* s_slot;
  const int* slot;
  const int* kind;
  const uint32_t* expected;
  const uint32_t* desired;
  const int* c_slot;
  const uint32_t* c_ver;
  const bool* c_linked;
  int* s_kind;
  uint32_t* s_link_ver;
  uint32_t* s_expected;
  uint32_t* s_desired;
  int* scratch;      // [predicate bits, blocks done], zero on entry
  bool* fast;
  bool vec;          // rows of k % 4 == 0 words, 16-byte aligned
};

constexpr int kOutOfRange = 1, kWrites = 2, kDup = 4;

__device__ __forceinline__ void copy_row(uint32_t* dst, const uint32_t* src,
                                         int k, bool vec) {
  if (vec) {
    for (int q = 0; q < k / 4; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          reinterpret_cast<const uint4*>(src)[q];
  } else {
    for (int w = 0; w < k; ++w) dst[w] = src[w];
  }
}

// A thread per sorted lane i: gathers lane order[i]'s kind, link version
// (odd-poisoned unless its link names its cell) and rows, and finds the
// predicate's three facts: an active lane outside [0, n), a write, two
// equal adjacent sorted slots below n.  Each block ORs its facts into
// scratch[0] with one atomic; the last block to count itself done in
// scratch[1] decodes them into *fast (the threadfence pattern), so the
// flag is written by one launch with no host involvement.
__global__ void __launch_bounds__(kThreads) round_prologue_kernel(
    PrologueArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int bits = 0;
  if (i < a.p) {
    const int j = (int)a.order[i];
    const int kd = a.kind[j], s = a.slot[j];
    a.s_kind[i] = kd;
    const bool linked = a.c_linked[j] && a.c_slot[j] == s;
    a.s_link_ver[i] = linked ? a.c_ver[j] : 1u;
    copy_row(a.s_expected + (size_t)i * a.k, a.expected + (size_t)j * a.k,
             a.k, a.vec);
    copy_row(a.s_desired + (size_t)i * a.k, a.desired + (size_t)j * a.k,
             a.k, a.vec);
    if (kd != kIdle && (s < 0 || s >= a.n)) bits |= kOutOfRange;
    if (kd == kStore || kd == kCas || kd == kSc) bits |= kWrites;
    const int ss = a.s_slot[i];
    if (i > 0 && ss < a.n && a.s_slot[i - 1] == ss) bits |= kDup;
  }
  const int block_bits = (__syncthreads_or(bits & kOutOfRange) ? kOutOfRange
                                                               : 0) |
                         (__syncthreads_or(bits & kWrites) ? kWrites : 0) |
                         (__syncthreads_or(bits & kDup) ? kDup : 0);
  if (threadIdx.x == 0) {
    if (block_bits) atomicOr(&a.scratch[0], block_bits);
    __threadfence();
    if (atomicAdd(&a.scratch[1], 1) == (int)gridDim.x - 1) {
      const int all = atomicOr(&a.scratch[0], 0);
      *a.fast = !(all & kOutOfRange) && !((all & kWrites) && (all & kDup));
    }
  }
}

// ---------------------------------------------------------------------------
// Fast round: one thread per lane.
// ---------------------------------------------------------------------------

struct FastArgs {
  const bool* fast;
  uint32_t* data;
  uint32_t* version;
  int n, k;
  const int* slot;
  const int* kind;
  const uint32_t* expected;
  const uint32_t* desired;
  const int* c_slot;
  const uint32_t* c_ver;
  const uint32_t* c_val;
  const bool* c_linked;
  int p;
  uint32_t* value;
  bool* success;
  int* o_slot;
  uint32_t* o_ver;
  uint32_t* o_val;
  bool* o_linked;
  int* okw;
};

// What a lane of the fast round decides from its row's version `v`, its
// row's match with `expected`, and its link.
struct FastLane {
  bool okw, success, is_ll;
  uint32_t v;
};

__device__ __forceinline__ FastLane fast_lane(const FastArgs& a, int i, int s,
                                              int kd, bool live, uint32_t v,
                                              bool match) {
  const bool linked = a.c_linked[i] && a.c_slot[i] == s;
  const uint32_t link_ver = linked ? a.c_ver[i] : 1u;  // odd: never matches
  FastLane f;
  f.v = v;
  f.okw = live && (kd == kStore || (kd == kCas && match) ||
                   (kd == kSc && link_ver == v));
  if (kd == kLoad || kd == kLl || kd == kStore)
    f.success = true;
  else if (kd == kValidate)
    f.success = link_ver == v;
  else
    f.success = (kd == kCas || kd == kSc) && f.okw;
  f.is_ll = kd == kLl;
  return f;
}

__device__ __forceinline__ void fast_meta(const FastArgs& a, int i, int s,
                                          int kd, const FastLane& f) {
  a.success[i] = f.success;
  a.o_slot[i] = f.is_ll ? s : a.c_slot[i];
  a.o_ver[i] = f.is_ll ? f.v : a.c_ver[i];
  a.o_linked[i] = f.is_ll || (kd != kSc && a.c_linked[i]);
  a.okw[i] = f.okw ? 1 : 0;
}

template <int K, bool VEC>
__global__ void __launch_bounds__(kThreads) fast_round_kernel(FastArgs a) {
  if (!*a.fast) return;                        // the slow branch runs
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.p) return;
  const int s = a.slot[i], kd = a.kind[i];
  const bool live = kd != kIdle && s >= 0 && s < a.n;
  const size_t ro = (size_t)s * K, lo = (size_t)i * K;
  uint32_t row[K], cmp[K];
  uint32_t v = 0u;
  if (live) {
    ld<K, VEC>(row, a.data + ro);
    v = a.version[s];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) row[j] = 0u;
  }
  ld<K, VEC>(cmp, a.expected + lo);
  bool match = true;
#pragma unroll
  for (int j = 0; j < K; ++j) match &= row[j] == cmp[j];
  const FastLane f = fast_lane(a, i, s, kd, live, v, match);
  st<K, VEC>(a.value + lo, row);
  if (!f.is_ll) ld<K, VEC>(row, a.c_val + lo);
  st<K, VEC>(a.o_val + lo, row);
  fast_meta(a, i, s, kd, f);
  if (f.okw) {
    uint32_t des[K];
    ld<K, VEC>(des, a.desired + lo);
    st<K, VEC>(a.data + ro, des);
    a.version[s] = v + 2u;
  }
}

// Any k: the same, word by word from memory.
__global__ void __launch_bounds__(kThreads) fast_round_any(FastArgs a) {
  if (!*a.fast) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.p) return;
  const int s = a.slot[i], kd = a.kind[i], k = a.k;
  const bool live = kd != kIdle && s >= 0 && s < a.n;
  const size_t ro = (size_t)s * k, lo = (size_t)i * k;
  const uint32_t v = live ? a.version[s] : 0u;
  bool match = true;
  for (int j = 0; j < k; ++j) {
    const uint32_t w = live ? a.data[ro + j] : 0u;
    a.value[lo + j] = w;
    match &= w == a.expected[lo + j];
  }
  const FastLane f = fast_lane(a, i, s, kd, live, v, match);
  for (int j = 0; j < k; ++j)
    a.o_val[lo + j] = f.is_ll ? a.value[lo + j] : a.c_val[lo + j];
  fast_meta(a, i, s, kd, f);
  if (f.okw) {
    for (int j = 0; j < k; ++j) a.data[ro + j] = a.desired[lo + j];
    a.version[s] = v + 2u;
  }
}

// ---------------------------------------------------------------------------
// Slow round: the segment replay over the (slot, lane)-sorted lanes.
// ---------------------------------------------------------------------------

// Every in-table lane takes part; `aux` is its link version.
struct SlowOp {
  static constexpr bool kLink = true;
  const bool* fast;        // null: always run
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

  __device__ bool taken() const { return fast == nullptr || !*fast; }
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
// Epilogue: results back in lane order (slow branch), stats and the
// dirty-slot list (both branches).
// ---------------------------------------------------------------------------

struct EpilogueArgs {
  const bool* fast;
  int n, k, p;
  const int64_t* order;
  const int* s_slot;
  const int* s_kind;
  const uint32_t* val_s;
  const uint32_t* verpt_s;
  const int* succ_s;
  const uint32_t* version;    // the table's versions after the round
  const int* c_slot;
  const uint32_t* c_ver;
  const uint32_t* c_val;
  const bool* c_linked;
  uint32_t* value;
  bool* success;
  int* o_slot;
  uint32_t* o_ver;
  uint32_t* o_val;
  bool* o_linked;
  const int* okw;
  int* stats;
  int* dirty;
  int* scratch;               // kScratchHead + kRecord * tiles, zeroed
  int lane_blocks;            // blocks before the first scan block
};

// One sorted lane as the stats read it (`engine.stats_on_sorted`).
struct Lane {
  int slot;
  bool upd;        // STORE / CAS, or SC on a cell of the table
  bool read;       // LOAD / LL
  bool wrote;      // STORE / CAS, or a successful SC
  bool cas_fail;   // a CAS, or SC on a cell, that failed
  bool valcas, sc;
  bool start;      // first lane of its segment
  bool reset;      // start, or the lane before wrote
  bool dirty;      // first lane of the segment of a cell the batch wrote
};

// The sorted lanes a scan block holds in shared memory: 2 a thread.  Each
// lane's slot, and its kind (bits 0-3), success (bit 4) and whether it
// starts the segment of a cell the batch wrote (bit 5); entry 0 is the lane
// before the tile.
constexpr int kPerThread = 2;
constexpr int kTile = kEpilogueThreads * kPerThread;
constexpr int kSucc = 16, kDirty = 32;

struct Tile {
  int slot[kTile + 1];
  uint8_t bits[kTile + 1];
};

__device__ __forceinline__ uint8_t lane_bits(const EpilogueArgs& a, bool fast,
                                             int i) {
  const int kind = a.s_kind[i], s = a.s_slot[i];
  const int kd = kind >= 0 && kind < 15 ? kind : 15;   // 15: no kind
  const bool succ = fast ? a.okw[a.order[i]] != 0 : a.succ_s[i] != 0;
  // A cell is dirty iff a lane wrote it: on the fast branch, where a
  // written cell has one lane, that lane's okw; on the slow one, its
  // version moved (it only grows, by 2 a write).  Both equal
  // `engine.dirty_slots`'s "a successful STORE/CAS/SC in the segment".
  bool dirty = false;
  if (s >= 0 && s < a.n && (i == 0 || a.s_slot[i - 1] != s))
    dirty = fast ? succ && (kd == kStore || kd == kCas || kd == kSc)
                 : a.version[s] != a.verpt_s[i];
  return (uint8_t)(kd | (succ ? kSucc : 0) | (dirty ? kDirty : 0));
}

__device__ __forceinline__ bool lane_wrote(int n, int bits, int s) {
  const int kd = bits & 15;
  return kd == kStore || kd == kCas || (kd == kSc && s < n && (bits & kSucc));
}

// Load the sorted lanes [base, base + kTile) (those below p) into `t`.
__device__ void load_tile(const EpilogueArgs& a, bool fast, int base,
                          Tile& t) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = r * kEpilogueThreads + (int)threadIdx.x, i = base + j;
    if (i < a.p) {
      t.slot[j + 1] = a.s_slot[i];
      t.bits[j + 1] = lane_bits(a, fast, i);
    }
  }
  if (threadIdx.x == 0 && base > 0) {
    t.slot[0] = a.s_slot[base - 1];
    t.bits[0] = lane_bits(a, fast, base - 1);
  }
  __syncthreads();
}

// Calls f(lane) for this thread's run of the tile, in order.
template <class F>
__device__ __forceinline__ void walk(const EpilogueArgs& a, const Tile& t,
                                     int base, F&& f) {
  const int n = a.n;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = kPerThread * (int)threadIdx.x + r + 1, i = base + j - 1;
    if (i >= a.p) return;
    const int s = t.slot[j], bits = t.bits[j], kd = bits & 15;
    const bool succ = (bits & kSucc) != 0;
    Lane l;
    l.slot = s;
    l.valcas = kd == kStore || kd == kCas;
    l.sc = kd == kSc && s < n;
    l.upd = l.valcas || l.sc;
    l.read = kd == kLoad || kd == kLl;
    l.wrote = l.valcas || (l.sc && succ);
    l.cas_fail = (kd == kCas || l.sc) && !succ;
    l.start = i == 0 || t.slot[j - 1] != s;
    l.reset = l.start || lane_wrote(n, t.bits[j - 1], t.slot[j - 1]);
    l.dirty = (bits & kDirty) != 0;
    f(l);
  }
}

// A run of sorted lanes, summarised for the scans: whether it holds a
// segment start (hs) and a reset (hh), the updates since its last segment
// start (u) and the loads since its last reset (r), or since its own start
// if it has none; and its dirty cells (d).
struct Seg {
  uint32_t hs, u, hh, r, d;

  __device__ static Seg identity() { return Seg{0u, 0u, 0u, 0u, 0u}; }
  __device__ Seg shfl_up(unsigned delta) const {
    using replay::kFull;
    return Seg{__shfl_up_sync(kFull, hs, delta),
               __shfl_up_sync(kFull, u, delta),
               __shfl_up_sync(kFull, hh, delta),
               __shfl_up_sync(kFull, r, delta),
               __shfl_up_sync(kFull, d, delta)};
  }
  __device__ Seg shfl(int src) const {
    using replay::kFull;
    return Seg{__shfl_sync(kFull, hs, src), __shfl_sync(kFull, u, src),
               __shfl_sync(kFull, hh, src), __shfl_sync(kFull, r, src),
               __shfl_sync(kFull, d, src)};
  }
  // this run, then `b`
  __device__ Seg then(const Seg& b) const {
    return Seg{hs | b.hs, b.hs ? b.u : u + b.u, hh | b.hh,
               b.hh ? b.r : r + b.r, d + b.d};
  }
};

// Exclusive scan of one Seg a thread over the block (threads in order);
// `*total` gets the whole block's.  `tmp` is 32 Segs of shared memory;
// every thread of the block must call it.
__device__ Seg block_scan(Seg x, Seg* tmp, Seg* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  Seg inc = x;
  for (unsigned d = 1; d < 32; d <<= 1) {
    const Seg up = inc.shfl_up(d);
    if (lane >= (int)d) inc = up.then(inc);
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Seg t = lane < warps ? tmp[lane] : Seg::identity();
    for (unsigned d = 1; d < 32; d <<= 1) {
      const Seg up = t.shfl_up(d);
      if (lane >= (int)d) t = up.then(t);
    }
    tmp[lane] = t;
  }
  __syncthreads();
  Seg excl = inc.shfl_up(1);
  if (lane == 0) excl = Seg::identity();
  const Seg out = warp > 0 ? tmp[warp - 1].then(excl) : excl;
  *total = tmp[warps - 1];
  __syncthreads();                  // before tmp is used again
  return out;
}

// The epilogue's scratch: the next tile to take, the scan blocks done, the
// stats' sums, then a record a tile for the look-back: its flag (1: its
// aggregate is there, 2: its inclusive prefix too) and the two Segs.
constexpr int kNextTile = 0, kDone = 1, kSums = 2, kScratchHead = 16;
constexpr int kRecord = 16, kAggregate = 1, kInclusive = 6;
enum { kRmax, kRaced, kUpdates, kLoads, kCasFail, kFlags, kDirtyCells };

__device__ __forceinline__ void put_seg(int* rec, const Seg& s) {
  rec[0] = (int)s.hs;
  rec[1] = (int)s.u;
  rec[2] = (int)s.hh;
  rec[3] = (int)s.r;
  rec[4] = (int)s.d;
}

__device__ __forceinline__ Seg get_seg(const volatile int* rec) {
  return Seg{(uint32_t)rec[0], (uint32_t)rec[1], (uint32_t)rec[2],
             (uint32_t)rec[3], (uint32_t)rec[4]};
}

// Warp 0 of tile `tile`: publish its aggregate, look back over the tiles
// before it (decoupled look-back, 32 tiles a step, one a lane) for its
// exclusive prefix, publish its inclusive prefix, and return the exclusive
// one (to every lane).
__device__ Seg look_back(const EpilogueArgs& a, int tile, const Seg& agg) {
  using replay::kFull;
  const int lane = threadIdx.x & 31;
  volatile int* rec = a.scratch + kScratchHead + kRecord * tile;
  if (lane == 0) {
    put_seg((int*)rec + kAggregate, agg);
    __threadfence();
    rec[0] = 1;
  }
  Seg before = Seg::identity();
  for (int top = tile - 1; top >= 0; top -= 32) {
    const int t = top - lane;           // lane 0: the nearest tile
    int flag = 2;                       // past tile 0: an empty inclusive
    Seg v = Seg::identity();
    if (t >= 0) {
      const volatile int* prev = a.scratch + kScratchHead + kRecord * t;
      while ((flag = prev[0]) == 0) {
      }
      __threadfence();
      v = get_seg(prev + (flag == 2 ? kInclusive : kAggregate));
    }
    const unsigned inclusive = __ballot_sync(kFull, flag == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    // the tiles from lane `stop` (farthest) down to lane 0, in order
    Seg x = v.shfl(lane <= stop ? stop - lane : lane);
    if (lane > stop) x = Seg::identity();
    for (unsigned d = 1; d < 32; d <<= 1) {
      const Seg up = x.shfl_up(d);
      if (lane >= (int)d) x = up.then(x);
    }
    before = x.shfl(stop).then(before);
    if (inclusive) break;
  }
  if (lane == 0) {
    put_seg((int*)rec + kInclusive, before.then(agg));
    __threadfence();
    rec[0] = 2;
  }
  return before;
}

// A scan block: one tile of the sorted order (kTile lanes, taken in the
// order the blocks start, so every tile it waits on is held by a block
// already running).  Its stats go to the sums by atomics; the last scan
// block to finish writes the stats and pads the dirty list with n.
__device__ void epilogue_scan(const EpilogueArgs& a, bool fast) {
  __shared__ Tile tile;
  __shared__ Seg seg_tmp[32];
  __shared__ Seg prefix;
  __shared__ int tile_id, last;
  __shared__ uint32_t sums[7];
  const int n = a.n;
  if (threadIdx.x == 0) tile_id = atomicAdd(&a.scratch[kNextTile], 1);
  if (threadIdx.x < 7) sums[threadIdx.x] = 0u;
  __syncthreads();
  const int base = tile_id * kTile;
  load_tile(a, fast, base, tile);

  // This thread's run, summarised; the block's scan; the look-back.
  Seg run = Seg::identity();
  walk(a, tile, base, [&](const Lane& l) {
    if (l.start) {
      run.hs = 1u;
      run.u = 0u;
    }
    if (l.reset) {
      run.hh = 1u;
      run.r = 0u;
    }
    run.u += l.upd;
    run.r += l.read;
    run.d += l.dirty;
  });
  Seg tile_total;
  const Seg mine = block_scan(run, seg_tmp, &tile_total);
  if (threadIdx.x < 32) {
    const Seg b = look_back(a, tile_id, tile_total);
    if (threadIdx.x == 0) prefix = b;
  }
  __syncthreads();

  // The running state lane by lane: the stats, and the dirty cells in
  // ascending slot order.
  const Seg before = prefix.then(mine);
  uint32_t u = before.u, r = before.r, rmax = 0u, raced = 0u, updates = 0u,
           loads = 0u, cas_fail = 0u, flags = 0u;
  int at = (int)before.d;
  walk(a, tile, base, [&](const Lane& l) {
    if (l.start) u = 0u;
    if (l.reset) r = 0u;
    u += l.upd;
    if (l.upd && u > rmax) rmax = u;       // the lane's write rank + 1
    if (l.wrote) raced += r;               // the loads since the last reset
    r += l.read;
    updates += l.wrote;
    loads += l.read;
    cas_fail += l.cas_fail;
    flags |= (l.valcas ? 1u : 0u) | (l.sc ? 2u : 0u);
    if (l.dirty) a.dirty[at++] = l.slot;
  });
  // the warp's sums first: one shared-memory atomic a warp, not a thread
  for (unsigned d = 16; d > 0; d >>= 1) {
    using replay::kFull;
    const uint32_t m = __shfl_down_sync(kFull, rmax, d);
    rmax = m > rmax ? m : rmax;
    raced += __shfl_down_sync(kFull, raced, d);
    updates += __shfl_down_sync(kFull, updates, d);
    loads += __shfl_down_sync(kFull, loads, d);
    cas_fail += __shfl_down_sync(kFull, cas_fail, d);
    flags |= __shfl_down_sync(kFull, flags, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&sums[kRmax], rmax);
    atomicAdd(&sums[kRaced], raced);
    atomicAdd(&sums[kUpdates], updates);
    atomicAdd(&sums[kLoads], loads);
    atomicAdd(&sums[kCasFail], cas_fail);
    atomicOr(&sums[kFlags], flags);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int* g = a.scratch + kSums;
    atomicMax(&g[kRmax], (int)sums[kRmax]);
    atomicAdd(&g[kRaced], (int)sums[kRaced]);
    atomicAdd(&g[kUpdates], (int)sums[kUpdates]);
    atomicAdd(&g[kLoads], (int)sums[kLoads]);
    atomicAdd(&g[kCasFail], (int)sums[kCasFail]);
    atomicOr(&g[kFlags], (int)sums[kFlags]);
    atomicAdd(&g[kDirtyCells], (int)tile_total.d);
    __threadfence();
    const int scan_blocks = (int)gridDim.x - a.lane_blocks;
    last = atomicAdd(&a.scratch[kDone], 1) == scan_blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  const volatile int* g = a.scratch + kSums;
  const int dirty_cells = g[kDirtyCells];
  for (int q = dirty_cells + threadIdx.x; q < a.p; q += blockDim.x)
    a.dirty[q] = n;
  if (threadIdx.x == 0) {
    const int fl = g[kFlags];
    a.stats[0] = (fl & 1) ? g[kRmax] : ((fl & 2) ? 1 : 0);
    a.stats[1] = g[kUpdates];
    a.stats[2] = g[kLoads];
    a.stats[3] = g[kCasFail];
    a.stats[4] = g[kRaced];
    a.stats[5] = dirty_cells;
  }
}

__global__ void __launch_bounds__(kEpilogueThreads) round_epilogue_kernel(
    EpilogueArgs a) {
  const bool fast = *a.fast;
  if ((int)blockIdx.x >= a.lane_blocks) {
    epilogue_scan(a, fast);
    return;
  }
  if (fast) return;                 // the fast round wrote the lanes
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.p) return;
  const int j = (int)a.order[i];
  const int kd = a.s_kind[i], s = a.s_slot[i];
  const bool is_ll = kd == kLl && s < a.n;
  const size_t si = (size_t)i * a.k, sj = (size_t)j * a.k;
  for (int w = 0; w < a.k; ++w) {
    const uint32_t x = a.val_s[si + w];
    a.value[sj + w] = kd != kIdle ? x : 0u;
    a.o_val[sj + w] = is_ll ? x : a.c_val[sj + w];
  }
  a.success[j] = a.succ_s[i] != 0;
  a.o_slot[j] = is_ll ? s : a.c_slot[j];
  a.o_ver[j] = is_ll ? a.verpt_s[i] : a.c_ver[j];
  a.o_linked[j] = is_ll || (kd != kSc && a.c_linked[j]);
}

// ---------------------------------------------------------------------------
// Host-side dispatch on k (compile-time row widths where it pays).
// ---------------------------------------------------------------------------

bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15u) == 0;
}

template <int K>
void launch_fast_k(const FastArgs& a, dim3 grid, cudaStream_t st) {
  if constexpr (K % 4 == 0) {
    if (aligned16(a.data) && aligned16(a.expected) && aligned16(a.desired) &&
        aligned16(a.c_val) && aligned16(a.value) && aligned16(a.o_val)) {
      fast_round_kernel<K, true><<<grid, kThreads, 0, st>>>(a);
      return;
    }
  }
  fast_round_kernel<K, false><<<grid, kThreads, 0, st>>>(a);
}

void launch_fast(const FastArgs& a, cudaStream_t st) {
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
    default: fast_round_any<<<grid, kThreads, 0, st>>>(a);
  }
}

// Common prologue of the entry points: clear any error left by an earlier
// call and select the device.
int begin(int device) {
  cudaGetLastError();
  return (int)cudaSetDevice(device);
}

}  // namespace

extern "C" {

// The sorted order (order int64[p], s_slot) and the batch (slot, kind,
// expected, desired, the links c_*) in; the replay's sorted operands
// (s_kind, s_link_ver, s_expected, s_desired) and the predicate *fast out.
// scratch: int32[2] of zeros.
int round_prologue(int n, int k, int p, const void* order, const void* s_slot,
                   const void* slot, const void* kind, const void* expected,
                   const void* desired, const void* c_slot,
                   const void* c_ver, const void* c_linked, void* s_kind,
                   void* s_link_ver, void* s_expected, void* s_desired,
                   void* scratch, void* fast, int device, void* stream) {
  int err = begin(device);
  if (err != 0) return err;
  const bool vec = k % 4 == 0 && aligned16(expected) && aligned16(desired) &&
                   aligned16(s_expected) && aligned16(s_desired);
  const PrologueArgs a{n,
                       k,
                       p,
                       static_cast<const int64_t*>(order),
                       static_cast<const int*>(s_slot),
                       static_cast<const int*>(slot),
                       static_cast<const int*>(kind),
                       static_cast<const uint32_t*>(expected),
                       static_cast<const uint32_t*>(desired),
                       static_cast<const int*>(c_slot),
                       static_cast<const uint32_t*>(c_ver),
                       static_cast<const bool*>(c_linked),
                       static_cast<int*>(s_kind),
                       static_cast<uint32_t*>(s_link_ver),
                       static_cast<uint32_t*>(s_expected),
                       static_cast<uint32_t*>(s_desired),
                       static_cast<int*>(scratch),
                       static_cast<bool*>(fast),
                       vec};
  const dim3 grid(p > 0 ? (p + kThreads - 1) / kThreads : 1);
  round_prologue_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Table (data[n, k], version[n]) updated in place where the fast branch is
// taken; lane arrays of width p; the lane's link (c_*) in, its results and
// new link (value, success, o_*, okw) out.  Launch on `stream` of
// `device`; returns the cudaError_t of the launch (0 = queued).
int fast_round(const void* fast, void* data, void* version, int n, int k,
               const void* slot, const void* kind, const void* expected,
               const void* desired, const void* c_slot, const void* c_ver,
               const void* c_val, const void* c_linked, int p, void* value,
               void* success, void* o_slot, void* o_ver, void* o_val,
               void* o_linked, void* okw, int device, void* stream) {
  int err = begin(device);
  if (err != 0 || p <= 0) return err;
  const FastArgs a{static_cast<const bool*>(fast),
                   static_cast<uint32_t*>(data),
                   static_cast<uint32_t*>(version),
                   n,
                   k,
                   static_cast<const int*>(slot),
                   static_cast<const int*>(kind),
                   static_cast<const uint32_t*>(expected),
                   static_cast<const uint32_t*>(desired),
                   static_cast<const int*>(c_slot),
                   static_cast<const uint32_t*>(c_ver),
                   static_cast<const uint32_t*>(c_val),
                   static_cast<const bool*>(c_linked),
                   p,
                   static_cast<uint32_t*>(value),
                   static_cast<bool*>(success),
                   static_cast<int*>(o_slot),
                   static_cast<uint32_t*>(o_ver),
                   static_cast<uint32_t*>(o_val),
                   static_cast<bool*>(o_linked),
                   static_cast<int*>(okw)};
  launch_fast(a, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Lanes sorted by (slot, lane); outputs val[p, k], verpt[p], ok[p] in that
// order.  `fast` may be null (always run); where *fast is true the kernel
// returns at once.
int slow_round(const void* fast, void* data, void* version, int n, int k,
               const void* slot, const void* kind, const void* link_ver,
               const void* expected, const void* desired, int p, void* val,
               void* verpt, void* ok, int device, void* stream) {
  int err = begin(device);
  if (err != 0 || p <= 0) return err;
  const SlowOp op{static_cast<const bool*>(fast),
                  static_cast<uint32_t*>(data),
                  static_cast<uint32_t*>(version),
                  n,
                  static_cast<const int*>(slot),
                  static_cast<const int*>(kind),
                  static_cast<const uint32_t*>(link_ver),
                  static_cast<const uint32_t*>(expected),
                  static_cast<const uint32_t*>(desired),
                  static_cast<uint32_t*>(val),
                  static_cast<uint32_t*>(verpt),
                  static_cast<int*>(ok)};
  replay::launch(op, p, k,
                 aligned16(data) && aligned16(expected) &&
                     aligned16(desired) && aligned16(val),
                 static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The sorted order (order int64[p], s_slot, s_kind), the slow round's
// outputs in it (val_s, verpt_s, succ_s) and the table's versions after the
// round; the links in (c_*) and the round's lane outputs (value, success,
// o_*); the fast round's okw; stats int32[6] and dirty int32[p] out.
// scratch: int32[round_epilogue_scratch(p)] of zeros.
int round_epilogue(const void* fast, int n, int k, int p, const void* order,
                   const void* s_slot, const void* s_kind, const void* val_s,
                   const void* verpt_s, const void* succ_s,
                   const void* version, const void* c_slot,
                   const void* c_ver, const void* c_val,
                   const void* c_linked, void* value, void* success,
                   void* o_slot, void* o_ver, void* o_val, void* o_linked,
                   const void* okw, void* stats, void* dirty, void* scratch,
                   int device, void* stream) {
  int err = begin(device);
  if (err != 0) return err;
  const int lane_blocks = (p + kEpilogueThreads - 1) / kEpilogueThreads;
  const int scan_blocks = p > 0 ? (p + kTile - 1) / kTile : 1;
  const EpilogueArgs a{static_cast<const bool*>(fast),
                       n,
                       k,
                       p,
                       static_cast<const int64_t*>(order),
                       static_cast<const int*>(s_slot),
                       static_cast<const int*>(s_kind),
                       static_cast<const uint32_t*>(val_s),
                       static_cast<const uint32_t*>(verpt_s),
                       static_cast<const int*>(succ_s),
                       static_cast<const uint32_t*>(version),
                       static_cast<const int*>(c_slot),
                       static_cast<const uint32_t*>(c_ver),
                       static_cast<const uint32_t*>(c_val),
                       static_cast<const bool*>(c_linked),
                       static_cast<uint32_t*>(value),
                       static_cast<bool*>(success),
                       static_cast<int*>(o_slot),
                       static_cast<uint32_t*>(o_ver),
                       static_cast<uint32_t*>(o_val),
                       static_cast<bool*>(o_linked),
                       static_cast<const int*>(okw),
                       static_cast<int*>(stats),
                       static_cast<int*>(dirty),
                       static_cast<int*>(scratch),
                       lane_blocks};
  round_epilogue_kernel<<<lane_blocks + scan_blocks, kEpilogueThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The int32 words of scratch `round_epilogue` needs at batch width p.
int round_epilogue_scratch(int p) {
  return kScratchHead + kRecord * (p > 0 ? (p + kTile - 1) / kTile : 1);
}

const char* engine_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
