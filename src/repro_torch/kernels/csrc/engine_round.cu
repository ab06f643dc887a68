// Hand-written Hopper (sm_90a) kernels for the fused big-atomic engine round.
//
// fast_round_kernel replaces src/repro/kernels/engine_round.py::
// fast_round_pallas (body _fast_kernel) and the host-side assembly of its
// results (_assemble_fast); the slow round (`SlowOp` over the segment
// replay kernels of segment_replay.cuh) replaces slow_round_pallas (body
// _slow_kernel); round_prologue_kernel replaces the host code before both
// (the batch's stable argsort by slot, engine_round.py:533, fast_path_ok
// and its n-sized count array, the gathers into the sorted order);
// round_epilogue_kernel the host code after both (engine.rebuild,
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
// resolved one after another; in the prologue and the epilogue, the round
// trips through L2 by which their blocks meet.
//
// The round's scratch (`Scratch`, int32[round_scratch(p)]) needs no memset:
// the prologue writes every word a later kernel of the round reads before
// it is read (the look-back words of the sort passes and of the epilogue,
// the epilogue's ticket, the predicate's bits).
//
// Design, prologue: one cooperative launch (every block resident at once,
// grid-wide barriers between phases), at most as many blocks as the card
// holds.  The sort is a stable LSD radix sort of the 32-bit key (the slot,
// n on an IDLE lane) with its sign bit flipped, so any int32 slot, in
// contract or not, sorts as `torch.sort(stable=True)` sorts it; 8-bit
// digits, the lane index as the value, tiles of 1024 keys.  Phases: the
// histograms of all four digits and the OR and AND of the keys, one read;
// then a pass a digit that is not the same in every key (a digit every key
// shares would be the identity: at n = 2^22 the keys take 23 bits, so
// three passes sort and none is launched for the fourth), each a read and a
// scatter ("onesweep"): a tile's keys ranked stably by digit (a warp per
// 128 keys in order, eight ballots for the lanes of a digit, counts per
// warp in shared memory), the tiles meeting per digit by a decoupled
// look-back (a tile waits only on the counts of the tiles before it, which
// each publishes before it waits), the scatter staged through shared
// memory so that it is written in runs; last, a thread per sorted lane:
// `order`, `s_slot`, the gathers into the sorted order, and the
// predicate's three facts (an active lane outside [0, n), a write, two
// equal adjacent sorted slots below n), which a block ORs into the scratch
// with one atomic, clearing `fast` if what it gets back with its own fails
// the predicate (the facts only grow, so the last block to OR sees them
// all: no done counter).  The sort reads 8 bytes a lane and moves 8 a
// pass, a few hundred KB at p = 16384: its time is the barriers and the
// L2 round trips inside each pass (the look-back), not bytes.  (Earlier
// designs on the H100: a histogram kernel, four pass kernels and a
// finishing kernel, six launches, 39 us at p = 16384; the same with
// programmatic dependent launch, 31 us; this one, 24-25 us.  PERF.md has
// the times.)
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
// Design, epilogue: one launch, programmatic (it may be scheduled while
// the slow round finishes), a block of 512 threads per tile of 1024 sorted
// lanes, then (slow branch) a block per 128 sorted lanes that puts their
// replay outputs back at their lanes (order[i]) with the new links: a
// scattered write costs a transaction a lane, and one SM's rate of them
// bounds a block, so they are spread over many.  A tile block stages its
// tile in shared memory with coalesced loads, summarises each thread's two
// lanes (the updates since the segment's start, the loads since the last
// write, the dirty cells), scans
// the summaries over the block, and sums the tile's share of the stats as
// a function of what comes before it: only the updates and loads carried
// into its first segment change them, so a tile's share is a few words
// beside its scan aggregate (`Part`).  The tiles meet by one decoupled
// look-back over those records, which gives every tile its running state
// (each dirty cell's rank, so the list comes out in ascending slot order)
// and the last tile the whole batch's stats, which it writes, then pads
// the list with n.  A tile waits on the tiles before it, so their blocks
// must be running: where the card holds every tile's block at once (p up
// to a few hundred thousand lanes on an H100), tile = blockIdx.x, since a
// block that waits then holds no place another tile's block needs; beyond
// that a block takes its tile from a ticket, the one atomic on global
// memory, so that a tile waits only on blocks that took their tickets
// before it and run (blocks are not promised to start in blockIdx order).
// No other atomic on global memory, no done counter.  A cell is dirty
// where a lane wrote it, known at its segment's first lane from the fast
// round's okw or the version the replay moved.
// (Earlier designs on the H100: one block walking all 16384 lanes, 25 us,
// one SM's instruction rate; scan blocks meeting through a tile ticket,
// global atomics and a last block, 14-23 us, a chain of global round
// trips.)

#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "segment_replay.cuh"

// A kernel's dynamic shared memory (the tests' CPU emulator, which runs the
// blocks of a cooperative launch at once, gives each block its own).
#ifndef SHARED_BLOCK_MEMORY
#define SHARED_BLOCK_MEMORY(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

namespace {

using replay::ld;
using replay::st;


constexpr int kLoad = 0, kStore = 1, kCas = 2, kIdle = 3, kLl = 4, kSc = 5,
              kValidate = 6;
constexpr int kThreads = 256;

// The sort: 8-bit digits of a 32-bit key, tiles of kSortTile keys, a warp
// per kWarpRun keys of a tile, in order.
constexpr int kSortThreads = 256, kSortPerThread = 4;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortTile = kSortThreads * kSortPerThread;
constexpr int kWarpRun = 32 * kSortPerThread;
constexpr int kRadix = 256, kDigits = 4;
static_assert(kSortThreads == kRadix, "a digit value a thread of a tile");
constexpr uint32_t kFlip = 0x80000000u;     // int32 order as unsigned order
// A sort pass's look-back word for one (tile, digit): the count of the
// digit in that tile (kAgg) or in all tiles up to it (kInc); 0: not yet.
constexpr uint32_t kAgg = 1u << 30, kInc = 2u << 30, kCount = kAgg - 1u;

// The epilogue: a block of kEpilogueThreads per tile of kTile sorted lanes,
// then (slow branch) a block per kLaneRun lanes put back in lane order; a
// look-back record a tile of kRecord words: its flag (1: its aggregate is
// there, 2: its inclusive prefix too), then the two `Part`s.
constexpr int kEpilogueThreads = 512, kPerThread = 2;
constexpr int kTile = kEpilogueThreads * kPerThread;
constexpr int kLaneRun = 128;
constexpr int kRecord = 32, kAggregate = 1, kInclusive = 16;

// Where the parts of the round's scratch lie (int32 words) at batch width
// p: the predicate's bits and the varying-digit mask; the sort blocks'
// histograms and ORs / ANDs; the sort passes' look-back words; two key and
// value buffers; the epilogue's tile ticket and look-back records.
struct Scratch {
  int tiles, etiles;
  size_t facts, hist, orand, status, keys[2], vals[2], ticket, records,
      words;

  __host__ __device__ explicit Scratch(int p) {
    tiles = p > 0 ? (p + kSortTile - 1) / kSortTile : 1;
    etiles = p > 0 ? (p + kTile - 1) / kTile : 1;
    size_t at = 0;
    facts = at;
    at += 2;
    hist = at;                        // a block at most a tile
    at += (size_t)tiles * kDigits * kRadix;
    orand = at;
    at += 2 * (size_t)tiles;
    status = at;
    at += (size_t)kDigits * tiles * kRadix;
    for (int b = 0; b < 2; ++b) {
      keys[b] = at;
      at += (size_t)p;
      vals[b] = at;
      at += (size_t)p;
    }
    ticket = at;
    at += 1;
    records = at;
    at += (size_t)etiles * kRecord;
    words = at;
  }
};

__device__ __forceinline__ uint32_t ld_volatile(const uint32_t* q) {
  return *reinterpret_cast<const volatile uint32_t*>(q);
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Hopper's programmatic dependent launch: a kernel launched by
// `launch_after` may be scheduled while the kernel before it on the stream
// is still running, and must call `wait_prior` before it reads anything
// (the wait returns once that kernel has finished and its writes are
// visible).
__device__ __forceinline__ void wait_prior() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

// Launches `kernel` with one launch attribute (`attr`: programmatic
// dependent launch, or a cooperative launch).
template <class... Args>
cudaError_t launch_with(cudaLaunchAttribute attr, void (*kernel)(Args...),
                        int grid, int block, size_t smem, cudaStream_t stream,
                        Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <class... Args>
cudaError_t launch_after(void (*kernel)(Args...), int grid, int block,
                         cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  return launch_with(attr, kernel, grid, block, 0, stream, args...);
}

// ---------------------------------------------------------------------------
// Prologue: the sort, the predicate and the replay's sorted lane operands.
// ---------------------------------------------------------------------------

struct PrologueArgs {
  int n, k, p;
  const int* slot;
  const int* kind;
  const uint32_t* expected;
  const uint32_t* desired;
  const int* c_slot;
  const uint32_t* c_ver;
  const bool* c_linked;
  int* order;
  int* s_slot;
  int* s_kind;
  uint32_t* s_link_ver;
  uint32_t* s_expected;
  uint32_t* s_desired;
  bool* fast;
  uint32_t* scratch;
  bool vec;          // rows of k % 4 == 0 words, 16-byte aligned
};

constexpr int kOutOfRange = 1, kWrites = 2, kDup = 4;

// Lane i's sort key: its slot (n on an IDLE lane), sign bit flipped.  Both
// words are loaded, so that the slot's load does not wait on the kind's.
__device__ __forceinline__ uint32_t sort_key(const PrologueArgs& a, int i) {
  const int kd = a.kind[i], s = a.slot[i];
  return (uint32_t)(kd == kIdle ? a.n : s) ^ kFlip;
}

// The lanes of the warp in `live` whose 8-bit digit equals this lane's
// `d` (for a lane in `live`): eight ballots, one a bit (cheaper on the H100
// than __match_any_sync, measured).
__device__ __forceinline__ unsigned match_digit(uint32_t d, unsigned live) {
  unsigned peers = live;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned m = __ballot_sync(replay::kFull, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? m : ~m;
  }
  return peers;
}

// Adds to count[d] one for each lane of the warp in `live` whose digit is
// d: a shared-memory atomic a lane, or one for the warp where every lane
// has the same digit (a digit no key varies in, one hot slot), which would
// otherwise serialise it.
__device__ __forceinline__ void warp_count(uint32_t* count, uint32_t d,
                                           unsigned live) {
  const bool in = (live >> (threadIdx.x & 31)) & 1u;
  if (live == replay::kFull && __all_sync(replay::kFull,
                                          d == __shfl_sync(replay::kFull,
                                                           d, 0))) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&count[d], 32u);
  } else if (in) {
    atomicAdd(&count[d], 1u);
  }
}

// The count of `digit` in the tiles before `tile` (thread of that digit):
// the published words of the nearest tiles, eight at a time, back to the
// first inclusive one.  Every tile publishes its own count before it looks
// back, so a tile waits only on tiles before it, all of them resident.
__device__ uint32_t look_back_count(const uint32_t* st, int tile, int digit) {
  uint32_t excl = 0u;
  for (int j = tile - 1; j >= 0; j -= 8) {
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = j - e >= 0 ? ld_volatile(st + (size_t)(j - e) * kRadix + digit)
                        : kInc;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      while (w[e] == 0u)
        w[e] = ld_volatile(st + (size_t)(j - e) * kRadix + digit);
      excl += w[e] & kCount;
      if (w[e] & kInc) return excl;
    }
  }
  return excl;
}

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

// Sorted lane i: its lane j = order[i] and key from the last pass (`keys`,
// `vals`; none ran: the lanes as they are), the lane's kind, link version
// (odd-poisoned unless its link names its cell) and rows gathered into the
// sorted order; returns the predicate's facts it shows: an active lane
// outside [0, n), a write, two equal adjacent sorted slots below n.
__device__ __forceinline__ int finish_lane(const PrologueArgs& a,
                                           const uint32_t* keys,
                                           const uint32_t* vals, bool sorted,
                                           int i) {
  // every load first (the stores could alias them for all the compiler
  // knows, and would hold each one back)
  const int j = sorted ? (int)vals[i] : i;
  const int ss = (int)((sorted ? keys[i] : sort_key(a, i)) ^ kFlip);
  const int prev = i > 0 ? (int)((sorted ? keys[i - 1] : sort_key(a, i - 1))
                                 ^ kFlip)
                         : ss + 1;
  const int kd = a.kind[j], s = a.slot[j];
  const bool linked = a.c_linked[j] && a.c_slot[j] == s;
  const uint32_t link_ver = linked ? a.c_ver[j] : 1u;
  if (a.vec && a.k == 4) {
    const uint4 e = reinterpret_cast<const uint4*>(a.expected)[j];
    const uint4 d = reinterpret_cast<const uint4*>(a.desired)[j];
    reinterpret_cast<uint4*>(a.s_expected)[i] = e;
    reinterpret_cast<uint4*>(a.s_desired)[i] = d;
  } else {
    copy_row(a.s_expected + (size_t)i * a.k, a.expected + (size_t)j * a.k,
             a.k, a.vec);
    copy_row(a.s_desired + (size_t)i * a.k, a.desired + (size_t)j * a.k,
             a.k, a.vec);
  }
  a.order[i] = j;
  a.s_slot[i] = ss;
  a.s_kind[i] = kd;
  a.s_link_ver[i] = link_ver;
  int bits = 0;
  if (kd != kIdle && (s < 0 || s >= a.n)) bits |= kOutOfRange;
  if (kd == kStore || kd == kCas || kd == kSc) bits |= kWrites;
  if (ss < a.n && prev == ss) bits |= kDup;
  return bits;
}

// The prologue kernel's shared memory (dynamic, so that each block of a
// cooperative launch has its own in the tests' CPU emulator too).
struct SortShared {
  uint32_t hist[kDigits * kRadix];
  uint32_t count[kSortWarps * kRadix];   // a row a warp
  uint32_t start[kRadix];        // where the digit's keys of the tile go
  uint32_t tile_start[kRadix];   // the same within the tile
  uint32_t global_start[kRadix];   // the digit's first place in the batch
  uint32_t staged_key[kSortTile], staged_val[kSortTile];
  uint32_t warp_sum[kRadix / 32];
  uint32_t key_or, key_and;
};

// One sort pass over one tile: its keys and values (pass 0: the lanes' keys
// and indices; else what the pass before wrote) ranked stably by the digit
// at `shift`, then scattered to buffer pass % 2.
__device__ void sort_tile(const PrologueArgs& a, const Scratch& sc,
                          SortShared& sh, int pass, int shift, int tile) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const uint32_t* kin = a.scratch + sc.keys[(pass + 1) & 1];
  const uint32_t* vin = a.scratch + sc.vals[(pass + 1) & 1];
  const int first = tile * kSortTile + warp * kWarpRun;
  uint32_t key[kSortPerThread], val[kSortPerThread], rank[kSortPerThread];
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    const int q = first + r * 32 + lane;
    const bool valid = q < a.p;
    key[r] = !valid ? 0u : pass == 0 ? sort_key(a, q) : kin[q];
    val[r] = !valid ? 0u : pass == 0 ? (uint32_t)q : vin[q];
  }
  uint32_t* wc = sh.count + warp * kRadix;
  for (int q = lane; q < kRadix; q += 32) wc[q] = 0u;
  __syncwarp();

  // This warp's run, ranked within the warp in order.
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    const bool valid = first + r * 32 + lane < a.p;
    const uint32_t d = (key[r] >> shift) & 0xffu;
    const unsigned peers = match_digit(d, __ballot_sync(replay::kFull, valid));
    const unsigned below = peers & lanes_below();
    if (valid) rank[r] = wc[d] + (uint32_t)__popc(below);
    __syncwarp();
    if (valid && below == 0u) wc[d] += (uint32_t)__popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // A digit a thread: the warps' exclusive prefix within the tile, the
  // digit's start within the tile, then the tiles before this one by the
  // look-back.
  if (t < kRadix) {
    uint32_t run = 0u;
    for (int w = 0; w < kSortWarps; ++w) {
      const uint32_t c = sh.count[w * kRadix + t];
      sh.count[w * kRadix + t] = run;
      run += c;
    }
    uint32_t x = run;
    for (unsigned d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(replay::kFull, x, d);
      if (lane >= (int)d) x += y;
    }
    if (lane == 31) sh.warp_sum[warp] = x;
    sh.tile_start[t] = x - run;
    uint32_t* st = a.scratch + sc.status + (size_t)pass * sc.tiles * kRadix;
    volatile uint32_t* word = st + (size_t)tile * kRadix + t;
    uint32_t excl = 0u;
    if (tile == 0) {
      *word = kInc | run;
    } else {
      *word = kAgg | run;
      excl = look_back_count(st, tile, t);
      *word = kInc | (excl + run);
    }
    sh.start[t] = sh.global_start[t] + excl;
  }
  __syncthreads();
  if (t < kRadix)
    for (int w = 0; w < warp; ++w) sh.tile_start[t] += sh.warp_sum[w];
  __syncthreads();

  // The scatter, staged: each key to its place in the tile's sorted order
  // in shared memory, then out in that order, so that consecutive threads
  // write the consecutive places of one digit (a scatter straight from
  // the ranks costs a transaction a key).
#pragma unroll
  for (int r = 0; r < kSortPerThread; ++r) {
    if (first + r * 32 + lane >= a.p) break;
    const uint32_t d = (key[r] >> shift) & 0xffu;
    const uint32_t at = sh.tile_start[d] + wc[d] + rank[r];
    sh.staged_key[at] = key[r];
    sh.staged_val[at] = val[r];
  }
  __syncthreads();
  uint32_t* kout = a.scratch + sc.keys[pass & 1];
  uint32_t* vout = a.scratch + sc.vals[pass & 1];
  const int in_tile = a.p - tile * kSortTile < kSortTile
                          ? a.p - tile * kSortTile : kSortTile;
  for (int q = t; q < in_tile; q += kSortThreads) {
    const uint32_t k = sh.staged_key[q];
    const uint32_t d = (k >> shift) & 0xffu;
    const uint32_t pos = sh.start[d] + (uint32_t)q - sh.tile_start[d];
    kout[pos] = k;
    vout[pos] = sh.staged_val[q];
  }
  __syncthreads();                  // before the next tile reuses `sh`
}

// The prologue, one cooperative launch of at most as many blocks as the
// card holds at once, a tile of the sort each at most (block b takes tiles
// b, b + gridDim.x, ...; the blocks past the last tile wait for the last
// phase):
//   1. each block's histograms of all four digits of its tiles' keys and
//      their OR and AND; the words the rest of the round expects cleared,
//      `fast` set; a grid barrier;
//   2. every block: the digits that vary (the ORs and ANDs);
//   3. a pass a varying digit, each followed by a grid barrier: the digit's
//      start in the batch from the histograms, the tiles ranked and
//      scattered (`sort_tile`), meeting per digit by the look-back;
//   4. a thread per sorted lane (`finish_lane`); a block ORs its lanes'
//      facts into the scratch with one atomic and clears `fast` if the
//      facts it gets back with its own fail the predicate: the facts only
//      grow, so the last block to OR sees them all.
__global__ void __launch_bounds__(kSortThreads) round_prologue_kernel(
    PrologueArgs a) {
  SHARED_BLOCK_MEMORY(raw);
  SortShared& sh = *reinterpret_cast<SortShared*>(raw);
  const cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const Scratch sc(a.p);
  const int t = threadIdx.x, blocks = gridDim.x;
  const int sorters = blocks < sc.tiles ? blocks : sc.tiles;

  for (int q = t; q < kDigits * kRadix; q += kSortThreads) sh.hist[q] = 0u;
  if (t == 0) {
    sh.key_or = 0u;
    sh.key_and = ~0u;
  }
  __syncthreads();
  uint32_t o = 0u, an = ~0u;
  for (int tile = blockIdx.x; tile < sc.tiles; tile += blocks) {
    uint32_t u[kSortPerThread];
#pragma unroll
    for (int r = 0; r < kSortPerThread; ++r) {
      const int i = tile * kSortTile + r * kSortThreads + t;
      u[r] = i < a.p ? sort_key(a, i) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kSortPerThread; ++r) {
      const bool valid = tile * kSortTile + r * kSortThreads + t < a.p;
      if (valid) {
        o |= u[r];
        an &= u[r];
      }
      const unsigned live = __ballot_sync(replay::kFull, valid);
      for (int d = 0; d < kDigits; ++d)
        warp_count(sh.hist + d * kRadix, (u[r] >> (8 * d)) & 0xffu, live);
    }
  }
  for (unsigned d = 16; d > 0; d >>= 1) {
    o |= __shfl_down_sync(replay::kFull, o, d);
    an &= __shfl_down_sync(replay::kFull, an, d);
  }
  if ((t & 31) == 0) {
    atomicOr(&sh.key_or, o);
    atomicAnd(&sh.key_and, an);
  }
  __syncthreads();
  if ((int)blockIdx.x < sorters) {
    uint32_t* hist =
        a.scratch + sc.hist + (size_t)blockIdx.x * kDigits * kRadix;
    for (int q = t; q < kDigits * kRadix; q += kSortThreads)
      hist[q] = sh.hist[q];
    if (t == 0) {
      a.scratch[sc.orand + 2 * blockIdx.x] = sh.key_or;
      a.scratch[sc.orand + 2 * blockIdx.x + 1] = sh.key_and;
    }
  }
  const size_t first = (size_t)blockIdx.x * kSortThreads + t;
  const size_t stride = (size_t)blocks * kSortThreads;
  const size_t status_words = (size_t)kDigits * sc.tiles * kRadix;
  for (size_t q = first; q < status_words; q += stride)
    a.scratch[sc.status + q] = 0u;
  for (size_t q = first; q < (size_t)sc.etiles; q += stride)
    a.scratch[sc.records + q * kRecord] = 0u;
  if (blockIdx.x == 0 && t == 0) {
    a.scratch[sc.facts] = 0u;
    a.scratch[sc.ticket] = 0u;
    *a.fast = true;
  }
  grid.sync();

  // The digits that vary.
  __syncthreads();
  if (t == 0) {
    sh.key_or = 0u;
    sh.key_and = ~0u;
  }
  __syncthreads();
  for (int h = t; h < sorters; h += kSortThreads) {
    atomicOr(&sh.key_or, a.scratch[sc.orand + 2 * h]);
    atomicAnd(&sh.key_and, a.scratch[sc.orand + 2 * h + 1]);
  }
  __syncthreads();
  uint32_t vary = 0u;
  for (int d = 0; d < kDigits; ++d)
    if (((sh.key_or ^ sh.key_and) >> (8 * d)) & 0xffu) vary |= 1u << d;
  if (a.p == 0) vary = 0u;
  if (blockIdx.x == 0 && t == 0) a.scratch[sc.facts + 1] = vary;

  int pass = 0;
  for (uint32_t v = vary; v != 0u; v &= v - 1u, ++pass) {
    const int digit = __ffs((int)v) - 1;
    // the digit's first place in the batch: an exclusive scan of its
    // counts summed over the blocks' histograms (a digit value a thread)
    const int lane = t & 31, warp = t >> 5;
    uint32_t mine = 0u;
    for (int h = 0; h < sorters; ++h)
      mine += a.scratch[sc.hist + ((size_t)h * kDigits + digit) * kRadix + t];
    uint32_t x = mine;
    for (unsigned d = 1; d < 32; d <<= 1) {
      const uint32_t y = __shfl_up_sync(replay::kFull, x, d);
      if (lane >= (int)d) x += y;
    }
    if (lane == 31) sh.warp_sum[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) x += sh.warp_sum[w];
    sh.global_start[t] = x - mine;
    __syncthreads();
    for (int tile = blockIdx.x; tile < sc.tiles; tile += blocks)
      sort_tile(a, sc, sh, pass, 8 * digit, tile);
    grid.sync();
  }

  const uint32_t* keys = a.scratch + sc.keys[(pass + 1) & 1];
  const uint32_t* vals = a.scratch + sc.vals[(pass + 1) & 1];
  int bits = 0;
  for (int i = blockIdx.x * kSortThreads + t; i < a.p;
       i += blocks * kSortThreads)
    bits |= finish_lane(a, keys, vals, pass > 0, i);
  const int block_bits = (__syncthreads_or(bits & kOutOfRange) ? kOutOfRange
                                                               : 0) |
                         (__syncthreads_or(bits & kWrites) ? kWrites : 0) |
                         (__syncthreads_or(bits & kDup) ? kDup : 0);
  if (t == 0 && block_bits) {
    const int all =
        atomicOr(reinterpret_cast<int*>(a.scratch + sc.facts), block_bits) |
        block_bits;
    if ((all & kOutOfRange) || ((all & kWrites) && (all & kDup)))
      *a.fast = false;
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
  const int* order;
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
  uint32_t* records;          // kRecord words a tile, flag words zero
  uint32_t* ticket;           // zero; null: tile = blockIdx.x
  int tiles;                  // blocks before the first lane block
  bool vec;                   // rows of k % 4 == 0 words, 16-byte aligned
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

// The sorted lanes a block holds in shared memory: 2 a thread.  Each
// lane's slot, and its kind (bits 0-3), success (bit 4) and whether it
// starts the segment of a cell the batch wrote (bit 5); entry 0 is the lane
// before the tile.
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

// Load the sorted lanes [base, base + kTile) (those below p) into `t`:
// every lane's loads first, then the shared-memory stores.
__device__ void load_tile(const EpilogueArgs& a, bool fast, int base,
                          Tile& t) {
  int slot[kPerThread];
  uint8_t bits[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = base + r * kEpilogueThreads + (int)threadIdx.x;
    if (i < a.p) {
      slot[r] = a.s_slot[i];
      bits[r] = lane_bits(a, fast, i);
    }
  }
  if (threadIdx.x == 0 && base > 0) {
    t.slot[0] = a.s_slot[base - 1];
    t.bits[0] = lane_bits(a, fast, base - 1);
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = r * kEpilogueThreads + (int)threadIdx.x;
    if (base + j < a.p) {
      t.slot[j + 1] = slot[r];
      t.bits[j + 1] = bits[r];
    }
  }
  __syncthreads();
}

// The slow branch's outputs of sorted lane i back at its lane (order[i]),
// with its new link: the loads of each group of four words before its
// stores (the stores could alias them for all the compiler knows).
__device__ __forceinline__ void lane_back(const EpilogueArgs& a, int i) {
  const int j = a.order[i];
  const int kd = a.s_kind[i], s = a.s_slot[i];
  const bool is_ll = kd == kLl && s < a.n;
  const bool succ = a.succ_s[i] != 0;
  const int c_slot = a.c_slot[j];
  const uint32_t ver = is_ll ? a.verpt_s[i] : a.c_ver[j];
  const bool linked = is_ll || (kd != kSc && a.c_linked[j]);
  const size_t si = (size_t)i * a.k, sj = (size_t)j * a.k;
  for (int q = 0; a.vec && q < a.k / 4; ++q) {
    const uint4 x = reinterpret_cast<const uint4*>(a.val_s + si)[q];
    const uint4 c =
        is_ll ? x : reinterpret_cast<const uint4*>(a.c_val + sj)[q];
    reinterpret_cast<uint4*>(a.value + sj)[q] =
        kd != kIdle ? x : make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(a.o_val + sj)[q] = c;
  }
  for (int w0 = 0; !a.vec && w0 < a.k; w0 += 4) {
    uint32_t x[4], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w0 + q < a.k) {
        x[q] = a.val_s[si + w0 + q];
        c[q] = is_ll ? x[q] : a.c_val[sj + w0 + q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w0 + q < a.k) {
        a.value[sj + w0 + q] = kd != kIdle ? x[q] : 0u;
        a.o_val[sj + w0 + q] = c[q];
      }
    }
  }
  a.success[j] = succ;
  a.o_slot[j] = is_ll ? s : c_slot;
  a.o_ver[j] = ver;
  a.o_linked[j] = linked;
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
  // this run, then `b`
  __device__ Seg then(const Seg& b) const {
    return Seg{hs | b.hs, b.hs ? b.u : u + b.u, hh | b.hh,
               b.hh ? b.r : r + b.r, d + b.d};
  }
};

// A run of sorted lanes as the tiles meet: its Seg, and its share of the
// stats as a function of the u and r carried into it.  Only the run's lanes
// before its first segment start read the carried u, and only one lane,
// the last before its first reset if it wrote, reads the carried r.
struct Part {
  Seg seg;
  uint32_t rmax;     // the largest u of an update after the first start
  uint32_t ufirst;   // the largest u, from the run's start, of an update
                     // before the first start (0: none)
  uint32_t raced;    // the raced loads, less the carried r
  uint32_t pwrote;   // a lane before the first reset wrote: add carried r
  uint32_t updates, loads, cas_fail, flags;
  static constexpr int kWords = 13;

  __device__ static Part identity() {
    return Part{Seg::identity(), 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  }
  template <class F>
  __device__ void each(F&& f) {
    f(seg.hs), f(seg.u), f(seg.hh), f(seg.r), f(seg.d), f(rmax), f(ufirst);
    f(raced), f(pwrote), f(updates), f(loads), f(cas_fail), f(flags);
  }
  __device__ Part shfl(int src) const {
    Part x = *this;
    x.each([&](uint32_t& w) { w = __shfl_sync(replay::kFull, w, src); });
    return x;
  }
  __device__ Part shfl_up(unsigned delta) const {
    Part x = *this;
    x.each([&](uint32_t& w) { w = __shfl_up_sync(replay::kFull, w, delta); });
    return x;
  }
  __device__ void store(volatile uint32_t* rec) const {
    Part x = *this;
    int q = 0;
    x.each([&](uint32_t& w) { rec[q++] = w; });
  }
  __device__ static Part load(const volatile uint32_t* rec) {
    Part x;
    int q = 0;
    x.each([&](uint32_t& w) { w = rec[q++]; });
    return x;
  }
  // this run, then `b`
  __device__ Part then(const Part& b) const {
    Part c;
    c.seg = seg.then(b.seg);
    // b's updates before its first start, counted on from this run's u
    const uint32_t bu = b.ufirst ? seg.u + b.ufirst : 0u;
    c.rmax = rmax > b.rmax ? rmax : b.rmax;
    if (seg.hs) {
      c.rmax = c.rmax > bu ? c.rmax : bu;
      c.ufirst = ufirst;
    } else {
      c.ufirst = ufirst > bu ? ufirst : bu;
    }
    c.raced = raced + b.raced + (b.pwrote ? seg.r : 0u);
    c.pwrote = pwrote | (seg.hh ? 0u : b.pwrote);
    c.updates = updates + b.updates;
    c.loads = loads + b.loads;
    c.cas_fail = cas_fail + b.cas_fail;
    c.flags = flags | b.flags;
    return c;
  }
};
static_assert(kAggregate + Part::kWords <= kInclusive &&
                  kInclusive + Part::kWords <= kRecord,
              "a look-back record holds two Parts");

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

// Warp 0 of tile `tile`: publish its aggregate, look back over the tiles
// before it (decoupled look-back, 32 tiles a step, one a lane) for its
// exclusive prefix, publish its inclusive prefix, and return the exclusive
// one (to every lane).  A tile waits only on tiles before it, whose blocks
// run (see the kernel).
__device__ Part look_back(const EpilogueArgs& a, int tile, const Part& agg) {
  using replay::kFull;
  const int lane = threadIdx.x & 31;
  volatile uint32_t* rec = a.records + (size_t)kRecord * tile;
  if (lane == 0) {
    agg.store(rec + (tile == 0 ? kInclusive : kAggregate));
    __threadfence();
    rec[0] = tile == 0 ? 2u : 1u;
  }
  Part before = Part::identity();
  for (int top = tile - 1; top >= 0; top -= 32) {
    const int t = top - lane;           // lane 0: the nearest tile
    uint32_t flag = 2u;                 // past tile 0: an empty inclusive
    Part v = Part::identity();
    if (t >= 0) {
      const volatile uint32_t* prev = a.records + (size_t)kRecord * t;
      while ((flag = prev[0]) == 0u) {
      }
      __threadfence();
      v = Part::load(prev + (flag == 2u ? kInclusive : kAggregate));
    }
    const unsigned inclusive = __ballot_sync(kFull, flag == 2u);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    // the tiles from lane `stop` (farthest) down to lane 0, in order
    Part x = v.shfl(lane <= stop ? stop - lane : lane);
    if (lane > stop) x = Part::identity();
    for (unsigned d = 1; d < 32; d <<= 1) {
      const Part up = x.shfl_up(d);
      if (lane >= (int)d) x = up.then(x);
    }
    before = x.shfl(stop).then(before);
    if (inclusive) break;
  }
  if (lane == 0 && tile > 0) {
    before.then(agg).store(rec + kInclusive);
    __threadfence();
    rec[0] = 2u;
  }
  return before;
}

// Blocks [0, tiles): a tile of kTile sorted lanes each, tile = blockIdx.x,
// or the block's ticket where the card may not hold every tile's block at
// once; the last tile writes the stats and pads the dirty list with n.  The
// blocks after them (slow branch): kLaneRun sorted lanes each put back in
// lane order, a random write a lane, spread over many SMs (one SM's
// transactions bound a scattered write).
__global__ void __launch_bounds__(kEpilogueThreads) round_epilogue_kernel(
    EpilogueArgs a) {
  __shared__ Tile tile;
  __shared__ Seg seg_tmp[32];
  __shared__ Part prefix, share;
  __shared__ uint32_t part[kEpilogueThreads / 32][8];
  __shared__ int ticket;
  wait_prior();
  const bool fast = *a.fast;
  if ((int)blockIdx.x >= a.tiles) {
    const int i = ((int)blockIdx.x - a.tiles) * kLaneRun + (int)threadIdx.x;
    if (!fast && (int)threadIdx.x < kLaneRun && i < a.p) lane_back(a, i);
    return;
  }
  int me = blockIdx.x;
  if (a.ticket != nullptr) {
    if (threadIdx.x == 0) ticket = (int)atomicAdd(a.ticket, 1u);
    __syncthreads();
    me = ticket;
  }
  const int n = a.n, base = me * kTile;
  load_tile(a, fast, base, tile);

  // This thread's run, summarised; the block's scan.
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

  // The tile's share of the stats, its lanes' running state counted from
  // the tile's start: an update before the tile's first segment start
  // counts on from the carried u, the one wrote lane before its first
  // reset from the carried r (`Part`).
  uint32_t u = mine.u, r = mine.r, rmax = 0u, ufirst = 0u, raced = 0u,
           pwrote = 0u, updates = 0u, loads = 0u, cas_fail = 0u, flags = 0u;
  bool started = mine.hs != 0u, reset = mine.hh != 0u;
  walk(a, tile, base, [&](const Lane& l) {
    if (l.start) {
      u = 0u;
      started = true;
    }
    if (l.reset) {
      r = 0u;
      reset = true;
    }
    u += l.upd;
    if (l.upd) {                            // u: the lane's write rank + 1
      uint32_t& top = started ? rmax : ufirst;
      if (u > top) top = u;
    }
    if (l.wrote) {                          // the loads since the last reset
      raced += r;
      if (!reset) pwrote = 1u;
    }
    r += l.read;
    updates += l.wrote;
    loads += l.read;
    cas_fail += l.cas_fail;
    flags |= (l.valcas ? 1u : 0u) | (l.sc ? 2u : 0u);
  });
  // the warp's share, then warp 0 sums the warps' (the shares' parts are
  // maxima, sums and ORs, so any order of adding them up will do)
  uint32_t v[8] = {rmax, ufirst, raced, pwrote, updates, loads, cas_fail,
                   flags};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int round = 0; round < 2; ++round) {
    for (unsigned d = 16; d > 0; d >>= 1) {
      uint32_t o[8];
#pragma unroll
      for (int f = 0; f < 8; ++f)
        o[f] = __shfl_down_sync(replay::kFull, v[f], d);
      v[0] = o[0] > v[0] ? o[0] : v[0];
      v[1] = o[1] > v[1] ? o[1] : v[1];
      v[2] += o[2];
      v[3] |= o[3];
      v[4] += o[4];
      v[5] += o[5];
      v[6] += o[6];
      v[7] |= o[7];
    }
    if (round == 1) break;
    if (lane == 0)
      for (int f = 0; f < 8; ++f) part[warp][f] = v[f];
    __syncthreads();
    if (warp > 0) break;
    for (int f = 0; f < 8; ++f)
      v[f] = lane < kEpilogueThreads / 32 ? part[lane][f] : 0u;
  }
  if (threadIdx.x < 32) {
    const Part agg{tile_total, v[0], v[1], v[2], v[3], v[4], v[5], v[6],
                   v[7]};
    const Part b = look_back(a, me, agg);
    if (threadIdx.x == 0) {
      prefix = b;
      share = agg;
    }
  }
  __syncthreads();

  // The dirty cells in ascending slot order: each one's rank.
  int at = (int)(prefix.seg.d + mine.d);
  walk(a, tile, base, [&](const Lane& l) {
    if (l.dirty) a.dirty[at++] = l.slot;
  });
  if (me != a.tiles - 1) return;
  const Part all = prefix.then(share);      // lane 0 starts a segment
  // the padding: words up to a 16-byte boundary, then four at a time
  const int from = (int)all.seg.d;
  const int head = (int)((16u - ((uintptr_t)(a.dirty + from) & 15u)) & 15u) / 4;
  const int body = from + head < a.p ? from + head : a.p;
  if ((int)threadIdx.x < body - from) a.dirty[from + threadIdx.x] = n;
  int4* quads = reinterpret_cast<int4*>(a.dirty + body);
  for (int q = threadIdx.x; q < (a.p - body) / 4; q += kEpilogueThreads)
    quads[q] = make_int4(n, n, n, n);
  for (int q = body + (a.p - body) / 4 * 4 + (int)threadIdx.x; q < a.p;
       q += kEpilogueThreads)
    a.dirty[q] = n;
  if (threadIdx.x == 0) {
    const uint32_t rounds = all.rmax > all.ufirst ? all.rmax : all.ufirst;
    a.stats[0] = (all.flags & 1u) ? (int)rounds : ((all.flags & 2u) ? 1 : 0);
    a.stats[1] = (int)all.updates;
    a.stats[2] = (int)all.loads;
    a.stats[3] = (int)all.cas_fail;
    a.stats[4] = (int)all.raced;
    a.stats[5] = (int)all.seg.d;
  }
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

// The most blocks of `kernel` (`threads` threads, `smem` bytes of dynamic
// shared memory) the card holds at once, known after the first call on
// `device` (an instance of the template, and its cache, a kernel); 0 if
// the runtime cannot say.
template <class Kernel>
int blocks_max(Kernel kernel, int threads, size_t smem, int device) {
  static int known[64];
  if (device >= 0 && device < 64 && known[device] > 0) return known[device];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  if (device >= 0 && device < 64) known[device] = per_sm * sms;
  return per_sm * sms;
}

// Common prologue of the entry points: clear any error left by an earlier
// call and select the device.
int begin(int device) {
  cudaGetLastError();
  return (int)cudaSetDevice(device);
}

}  // namespace

extern "C" {

// The batch (slot, kind, expected, desired, the links c_*) in; the sorted
// order (order, s_slot: int32[p]), the replay's sorted operands (s_kind,
// s_link_ver, s_expected, s_desired) and the predicate *fast out.  One
// cooperative launch of round_prologue_kernel on `stream`.  scratch:
// int32[round_scratch(p)], written before it is read; `round_epilogue` of
// the same round takes it as the prologue leaves it.
int round_prologue(int n, int k, int p, const void* slot, const void* kind,
                   const void* expected, const void* desired,
                   const void* c_slot, const void* c_ver,
                   const void* c_linked, void* order, void* s_slot,
                   void* s_kind, void* s_link_ver, void* s_expected,
                   void* s_desired, void* fast, void* scratch, int device,
                   void* stream) {
  int err = begin(device);
  if (err != 0) return err;
  const bool vec = k % 4 == 0 && aligned16(expected) && aligned16(desired) &&
                   aligned16(s_expected) && aligned16(s_desired);
  const PrologueArgs a{n,
                       k,
                       p,
                       static_cast<const int*>(slot),
                       static_cast<const int*>(kind),
                       static_cast<const uint32_t*>(expected),
                       static_cast<const uint32_t*>(desired),
                       static_cast<const int*>(c_slot),
                       static_cast<const uint32_t*>(c_ver),
                       static_cast<const bool*>(c_linked),
                       static_cast<int*>(order),
                       static_cast<int*>(s_slot),
                       static_cast<int*>(s_kind),
                       static_cast<uint32_t*>(s_link_ver),
                       static_cast<uint32_t*>(s_expected),
                       static_cast<uint32_t*>(s_desired),
                       static_cast<bool*>(fast),
                       static_cast<uint32_t*>(scratch),
                       vec};
  const Scratch sc(p);
  const auto st = static_cast<cudaStream_t>(stream);
  // a cooperative launch may not exceed what the card holds at once
  const int most = blocks_max(round_prologue_kernel, kSortThreads,
                              sizeof(SortShared), device);
  if (most <= 0) return (int)cudaGetLastError();
  // a tile each for the sort, a lane a thread for the last phase
  int blocks = (p + kSortThreads - 1) / kSortThreads;
  blocks = blocks > sc.tiles ? blocks : sc.tiles;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  return (int)launch_with(coop, round_prologue_kernel,
                          blocks < most ? blocks : most, kSortThreads,
                          sizeof(SortShared), st, a);
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

// The sorted order (order, s_slot, s_kind: int32[p]), the slow round's
// outputs in it (val_s, verpt_s, succ_s) and the table's versions after the
// round; the links in (c_*) and the round's lane outputs (value, success,
// o_*); the fast round's okw; stats int32[6] and dirty int32[p] out.
// scratch: int32[round_scratch(p)] as this round's `round_prologue` left it
// (or all zeros).
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
  const Scratch sc(p);
  const EpilogueArgs a{static_cast<const bool*>(fast),
                       n,
                       k,
                       p,
                       static_cast<const int*>(order),
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
                       static_cast<uint32_t*>(scratch) + sc.records,
                       // tiles in blockIdx order where every tile's block
                       // fits on the card at once
                       sc.etiles > blocks_max(round_epilogue_kernel,
                                              kEpilogueThreads, 0, device)
                           ? static_cast<uint32_t*>(scratch) + sc.ticket
                           : nullptr,
                       sc.etiles,
                       k % 4 == 0 && aligned16(val_s) && aligned16(c_val) &&
                           aligned16(value) && aligned16(o_val)};
  return (int)launch_after(round_epilogue_kernel,
                           sc.etiles + (p + kLaneRun - 1) / kLaneRun,
                           kEpilogueThreads, static_cast<cudaStream_t>(stream),
                           a);
}

// The int32 words of the round's scratch at batch width p.
int round_scratch(int p) { return (int)Scratch(p).words; }

const char* engine_round_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
