// A stand-in for the CUDA runtime that lets g++ compile the port's kernel
// sources for the CPU, for tests/test_torch_replay_emulated.py.  A block
// runs as one fiber (a `ucontext` with its own stack) per CUDA thread, all
// of a launch's fibers on the calling thread, switched round-robin
// whenever one waits: the 32 of a warp meet at every warp shuffle, ballot,
// match and `__syncwarp()`, all of the block's at `__syncthreads()`, and a
// loop's test (`while (emu_spin() && ...)`, as the test rewrites every
// `while (`) lets the others run first, so a thread spinning on a flag
// lets the thread that sets it run; so do a `__threadfence()` and every
// atomic.  One OS thread a launch, so the
// emulation needs no core of its own: under a loaded machine it slows by
// its share of one core, where a thread per CUDA thread waited on the
// scheduler at every barrier.  Blocks run one after another, in blockIdx
// order (so a block that waits on the blocks before it, as a look-back
// does, finds them done), and a `__shared__` variable (a static) is the
// running block's; but the blocks of a cooperative launch
// (`cudaLaunchKernelEx` with cudaLaunchAttributeCooperative) run all at
// once, meet at `this_grid().sync()`, and each has its own dynamic shared
// memory (`SHARED_BLOCK_MEMORY`).  The card reported holds two blocks of
// any kernel at once, so a cooperative kernel's blocks take several tiles
// each in the tests, and the epilogue's blocks take tickets past two
// tiles.  Launches `kernel<<<grid, block, smem, stream>>>(args)` are
// rewritten by the test into `EmuLaunch(grid, block, smem,
// stream)(kernel)(args)`.  Only what the engine-round, table and
// attention-backward kernels and the TF32 converters use is here
// (`cuda_bf16.h` beside it).
#pragma once

#include <ucontext.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
#define __shared__ static

#define __align__(n) alignas(n)

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
// Every block gets the dynamic shared memory its launch asks for.
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int,
                                                         size_t) {
  *blocks = 1;
  return cudaSuccess;
}

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// Programmatic dependent launch: kernels run one after another here, so
// the attribute changes nothing.  A cooperative launch runs its blocks at
// once.
enum cudaLaunchAttributeID {
  cudaLaunchAttributeCooperative = 2,
  cudaLaunchAttributeProgrammaticStreamSerialization = 5
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    int cooperative;
    int programmaticStreamSerializationAllowed;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint32_t __float_as_uint(float x) {
  uint32_t u;
  std::memcpy(&u, &x, sizeof u);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float x;
  std::memcpy(&x, &u, sizeof x);
  return x;
}

// The fibers of a launch: each runs until it waits (`emu_yield`), then the
// next one that is not done; the CUDA thread's identity lives in globals
// that each switch sets from the fiber.
struct EmuWarp;
struct EmuBlock;
struct EmuGrid;
struct EmuBarrier;
struct EmuFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
  const EmuBarrier* waits = nullptr;   // the barrier whose phase it awaits
  unsigned phase = 0;
  dim3 tid, bid;
  EmuWarp* warp;
  EmuBlock* block;
  int lane;
  unsigned turn = 0;
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuWarp* emu_warp;
inline thread_local EmuBlock* emu_block;
inline thread_local EmuGrid* emu_grid;
inline thread_local int emu_lane;
inline thread_local unsigned emu_turn;
inline thread_local ucontext_t emu_main;
inline thread_local EmuFiber* emu_fiber;
inline thread_local const std::function<void()>* emu_body;

// Back to the scheduler; returns when this fiber's turn comes again.
inline void emu_yield() {
  emu_fiber->turn = emu_turn;
  swapcontext(&emu_fiber->ctx, &emu_main);
}
// A loop's test: the other fibers run first (see the top of the file).
inline bool emu_spin() {
  emu_yield();
  return true;
}

// A barrier of `expected` fibers: the last to arrive ends the phase; the
// others wait for it.  `arrive_and_drop` arrives and leaves for good (a
// thread that returned), as std::barrier's.
struct EmuBarrier {
  int expected, count = 0;
  unsigned phase = 0;
  explicit EmuBarrier(int n) : expected(n) {}
  void arrive_and_wait() {
    const unsigned p = phase;
    if (++count == expected) {
      count = 0;
      ++phase;
      return;
    }
    emu_fiber->waits = this;           // not resumed until the phase ends
    emu_fiber->phase = p;
    while (phase == p) emu_yield();
    emu_fiber->waits = nullptr;
  }
  void arrive_and_drop() {
    --expected;
    if (count > 0 && count >= expected) {
      count = 0;
      ++phase;
    }
  }
};

// A warp's lanes exchange values through two slot buffers used in turns,
// so one barrier a call suffices: a buffer is written again only after
// the next call's barrier, which every lane passes after its last read.
struct EmuWarp {
  EmuBarrier bar{32};
  uint64_t slot[2][32];
};
struct EmuBlock {
  EmuBarrier bar;
  std::atomic<int> acc{0};
  std::vector<unsigned char> smem;
  EmuBlock(int threads, size_t smem_bytes) : bar(threads), smem(smem_bytes) {}
};
struct EmuGrid {
  EmuBarrier bar;
  explicit EmuGrid(int threads) : bar(threads) {}
};

#define SHARED_BLOCK_MEMORY(name) unsigned char* name = emu_block->smem.data()

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline int __syncthreads_or(int pred) {
  if (pred) emu_block->acc.fetch_or(1);
  emu_block->bar.arrive_and_wait();
  const int r = emu_block->acc.load();
  emu_block->bar.arrive_and_wait();
  if (threadIdx.x == 0) emu_block->acc.store(0);
  emu_block->bar.arrive_and_wait();
  return r;
}
// A fence and every atomic let the other fibers run next: what a thread
// does after one (publish a ticket it drew, a flag after its data) is
// then interleaved with the others' reads, as on the card.
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
  emu_yield();
}
template <class T>
T emu_after(T old) {
  emu_yield();
  return old;
}
template <class T>
T atomicOr(T* p, T v) { return emu_after(__atomic_fetch_or(p, v, __ATOMIC_SEQ_CST)); }
template <class T>
T atomicAnd(T* p, T v) { return emu_after(__atomic_fetch_and(p, v, __ATOMIC_SEQ_CST)); }
template <class T>
T atomicAdd(T* p, T v) { return emu_after(__atomic_fetch_add(p, v, __ATOMIC_SEQ_CST)); }
template <class T>
T atomicMax(T* p, T v) {
  T old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return emu_after(old);
}
inline int min(int a, int b) { return a < b ? a : b; }

// This lane's buffer for the warp's next exchange.
inline uint64_t* emu_slots() { return emu_warp->slot[emu_turn ^= 1u]; }

// Every lane publishes `v`, then reads lane `src`'s.
template <class T>
T emu_exchange(T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  uint64_t* slot = emu_slots();
  slot[emu_lane] = u;
  emu_warp->bar.arrive_and_wait();
  const uint64_t r = slot[src];
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
inline void emu_full(unsigned mask) {
  if (mask != 0xffffffffu) std::abort();  // the kernels use full warps only
}
template <class T>
T __shfl_sync(unsigned mask, T v, int src, int = 32) {
  emu_full(mask);
  return emu_exchange(v, src & 31);
}
template <class T>
T __shfl_xor_sync(unsigned mask, T v, int lane_mask, int = 32) {
  emu_full(mask);
  return emu_exchange(v, (emu_lane ^ lane_mask) & 31);
}
template <class T>
T __shfl_up_sync(unsigned mask, T v, unsigned d) {
  emu_full(mask);
  const int src = emu_lane - (int)d;
  return emu_exchange(v, src < 0 ? emu_lane : src);
}
template <class T>
T __shfl_down_sync(unsigned mask, T v, unsigned d) {
  emu_full(mask);
  const int src = emu_lane + (int)d;
  return emu_exchange(v, src > 31 ? emu_lane : src);
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  emu_full(mask);
  uint64_t* slot = emu_slots();
  slot[emu_lane] = pred != 0;
  emu_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)slot[i] << i;
  return r;
}
// The lanes whose `v` equals this lane's.
template <class T>
unsigned __match_any_sync(unsigned mask, T v) {
  emu_full(mask);
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  uint64_t* slot = emu_slots();
  slot[emu_lane] = u;
  emu_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)(slot[i] == u) << i;
  return r;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  emu_full(mask);
  emu_warp->bar.arrive_and_wait();
}
inline int __all_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) == mask;
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }

// Each fiber's stack (malloc'd, so its pages are touched only as used).
constexpr size_t kEmuStack = 256 * 1024;

inline void emu_fiber_main() {
  (*emu_body)();
  // a thread that returns early leaves the barrier phases to the rest, as
  // on the card
  emu_block->bar.arrive_and_drop();
  emu_grid->bar.arrive_and_drop();
  emu_fiber->done = true;              // uc_link: back to the scheduler
}

// Run `body` as `fibers` (their identities set), round-robin to the end.
inline void emu_run(std::vector<EmuFiber>& fibers, EmuGrid* grid,
                    const std::function<void()>& body) {
  emu_body = &body;
  emu_grid = grid;
  for (auto& f : fibers) {
    f.stack.reset(new char[kEmuStack]);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = kEmuStack;
    f.ctx.uc_link = &emu_main;
    makecontext(&f.ctx, emu_fiber_main, 0);
  }
  for (size_t live = fibers.size(); live;) {
    size_t ran = 0;
    for (auto& f : fibers) {
      if (f.done || (f.waits != nullptr && f.waits->phase == f.phase))
        continue;
      ++ran;
      emu_fiber = &f;
      threadIdx = f.tid;
      blockIdx = f.bid;
      emu_warp = f.warp;
      emu_block = f.block;
      emu_lane = f.lane;
      emu_turn = f.turn;
      swapcontext(&emu_main, &f.ctx);
      f.turn = emu_turn;
      live -= f.done;
    }
    if (ran == 0) std::abort();        // every live fiber waits: a deadlock
  }
}

struct EmuLaunch {
  dim3 grid, block;
  size_t smem;
  bool together;             // every block at once (a cooperative launch)
  EmuLaunch(dim3 g, dim3 b, size_t s = 0, cudaStream_t = nullptr,
            bool all = false)
      : grid(g), block(b), smem(s), together(all) {}
  template <class F>
  auto operator()(F kernel) {
    return [g = grid, b = block, smem = smem, together = together,
            kernel](auto... args) {
      const unsigned step = together ? g.x : 1;
      const std::function<void()> body = [&] { kernel(args...); };
      blockDim = b;
      gridDim = g;
      // a cooperative launch is one-dimensional; any other grid runs
      // block by block, x fastest
      for (unsigned bz = 0; bz < (together ? 1 : g.z); ++bz)
      for (unsigned by = 0; by < (together ? 1 : g.y); ++by)
      for (unsigned b0 = 0; b0 < g.x; b0 += step) {
        std::vector<std::vector<EmuWarp>> warps;
        std::vector<std::unique_ptr<EmuBlock>> blocks;
        for (unsigned bx = 0; bx < step; ++bx) {
          warps.emplace_back(b.x / 32);
          blocks.push_back(std::make_unique<EmuBlock>((int)b.x, smem));
        }
        EmuGrid grid_bar((int)(step * b.x));
        std::vector<EmuFiber> fibers(step * b.x);
        for (unsigned bx = 0; bx < step; ++bx)
          for (unsigned t = 0; t < b.x; ++t) {
            EmuFiber& f = fibers[bx * b.x + t];
            f.tid = dim3(t);
            f.bid = dim3(b0 + bx, by, bz);
            f.warp = &warps[bx][t / 32];
            f.block = blocks[bx].get();
            f.lane = (int)(t % 32);
          }
        emu_run(fibers, &grid_bar, body);
      }
    };
  }
};

template <class... K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*kernel)(K...), A... args) {
  bool together = false;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    together |= cfg->attrs[i].id == cudaLaunchAttributeCooperative &&
                cfg->attrs[i].val.cooperative;
  EmuLaunch(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cfg->stream,
            together)(kernel)(args...);
  return cudaSuccess;
}
