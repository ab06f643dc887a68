// A stand-in for the CUDA runtime that lets g++ compile the port's kernel
// sources for the CPU, for tests/test_torch_replay_emulated.py.  A block
// runs as one std::thread per CUDA thread: the 32 of a warp meet at every
// warp shuffle, ballot, match and `__syncwarp()`, all of the block's at
// `__syncthreads()`.  Blocks run one after another, in blockIdx order (so a
// block that waits on the blocks before it, as a look-back does, finds
// them done), and a `__shared__` variable (a static) is the running
// block's; but the blocks of a cooperative launch (`cudaLaunchKernelEx`
// with cudaLaunchAttributeCooperative) run all at once, meet at
// `this_grid().sync()`, and each has its own dynamic shared memory
// (`SHARED_BLOCK_MEMORY`).  The card reported holds two blocks of any
// kernel at once, so a cooperative kernel's blocks take several tiles each
// in the tests, and the epilogue's blocks take tickets past two tiles.  Launches `kernel<<<grid, block, smem, stream>>>(args)` are
// rewritten by the test into `EmuLaunch(grid, block, smem,
// stream)(kernel)(args)`.  Only what the engine-round, table and
// attention-backward kernels and the TF32 converters use is here (`cuda_bf16.h` beside it).
#pragma once

#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
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

// A warp's lanes exchange values through two slot buffers used in turns,
// so one barrier a call suffices: a buffer is written again only after
// the next call's barrier, which every lane passes after its last read.
struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t slot[2][32];
};
struct EmuBlock {
  std::barrier<> bar;
  std::atomic<int> acc{0};
  std::vector<unsigned char> smem;
  EmuBlock(std::ptrdiff_t threads, size_t smem_bytes)
      : bar(threads), smem(smem_bytes) {}
};
struct EmuGrid {
  std::barrier<> bar;
  explicit EmuGrid(std::ptrdiff_t threads) : bar(threads) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuWarp* emu_warp;
inline thread_local EmuBlock* emu_block;
inline thread_local EmuGrid* emu_grid;
inline thread_local int emu_lane;
inline thread_local unsigned emu_turn;

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
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T>
T atomicOr(T* p, T v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }
template <class T>
T atomicAnd(T* p, T v) { return __atomic_fetch_and(p, v, __ATOMIC_SEQ_CST); }
template <class T>
T atomicAdd(T* p, T v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <class T>
T atomicMax(T* p, T v) {
  T old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (old < v && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
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
      // a cooperative launch is one-dimensional; any other grid runs
      // block by block, x fastest
      for (unsigned bz = 0; bz < (together ? 1 : g.z); ++bz)
      for (unsigned by = 0; by < (together ? 1 : g.y); ++by)
      for (unsigned b0 = 0; b0 < g.x; b0 += step) {
        std::vector<std::vector<EmuWarp>> warps;
        std::vector<std::unique_ptr<EmuBlock>> blocks;
        for (unsigned bx = 0; bx < step; ++bx) {
          warps.emplace_back(b.x / 32);
          blocks.push_back(std::make_unique<EmuBlock>((std::ptrdiff_t)b.x,
                                                      smem));
        }
        EmuGrid grid_bar((std::ptrdiff_t)(step * b.x));
        std::vector<std::thread> threads;
        for (unsigned bx = 0; bx < step; ++bx)
          for (unsigned t = 0; t < b.x; ++t)
            threads.emplace_back([&, bx, t] {
              blockIdx = dim3(b0 + bx, by, bz);
              blockDim = b;
              gridDim = g;
              threadIdx = dim3(t);
              emu_warp = &warps[bx][t / 32];
              emu_block = blocks[bx].get();
              emu_grid = &grid_bar;
              emu_lane = (int)(t % 32);
              kernel(args...);
              // a thread that returns early leaves the barrier phases to
              // the rest, as on the card
              emu_block->bar.arrive_and_drop();
              grid_bar.bar.arrive_and_drop();
            });
        for (auto& t : threads) t.join();
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
