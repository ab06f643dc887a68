// A stand-in for the CUDA runtime that lets g++ compile the port's kernel
// sources for the CPU, for tests/test_torch_replay_emulated.py.  A block
// runs as one std::thread per CUDA thread: the 32 of a warp meet at every
// warp shuffle and ballot, all of the block's at `__syncthreads()`; blocks
// run one after another, so a `__shared__` variable (a static) is the
// running block's.  Launches `kernel<<<grid, block, smem, stream>>>(args)`
// are rewritten by the test into `EmuLaunch(grid, block, smem,
// stream)(kernel)(args)`.  Only what the engine-round and table kernels
// use is here.
#pragma once

#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(x)
#define __shared__ static

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
struct EmuBlock {
  std::barrier<> bar;
  std::atomic<int> acc{0};
  explicit EmuBlock(std::ptrdiff_t threads) : bar(threads) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local EmuWarp* emu_warp;
inline thread_local EmuBlock* emu_block;
inline thread_local int emu_lane;

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

// Every lane publishes `v`, then reads lane `src`'s.
template <class T>
T emu_exchange(T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof(T));
  emu_warp->slot[emu_lane] = u;
  emu_warp->bar.arrive_and_wait();
  const uint64_t r = emu_warp->slot[src];
  emu_warp->bar.arrive_and_wait();
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
  emu_warp->slot[emu_lane] = pred != 0;
  emu_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)emu_warp->slot[i] << i;
  emu_warp->bar.arrive_and_wait();
  return r;
}
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }

struct EmuLaunch {
  dim3 grid, block;
  EmuLaunch(dim3 g, dim3 b, int = 0, cudaStream_t = nullptr)
      : grid(g), block(b) {}
  template <class F>
  auto operator()(F kernel) {
    return [g = grid, b = block, kernel](auto... args) {
      for (unsigned bx = 0; bx < g.x; ++bx) {
        std::vector<EmuWarp> warps(b.x / 32);
        EmuBlock block((std::ptrdiff_t)b.x);
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < b.x; ++t)
          threads.emplace_back([&, t] {
            blockIdx = dim3(bx);
            blockDim = b;
            gridDim = g;
            threadIdx = dim3(t);
            emu_warp = &warps[t / 32];
            emu_block = &block;
            emu_lane = (int)(t % 32);
            kernel(args...);
            // a thread that returns early leaves the block's barrier
            // phases to the rest, as on the card
            block.bar.arrive_and_drop();
          });
        for (auto& t : threads) t.join();
      }
    };
  }
};
