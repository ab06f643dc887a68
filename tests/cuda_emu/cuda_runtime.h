// A stand-in for the CUDA runtime that lets g++ compile the port's kernel
// sources for the CPU, for tests/test_torch_replay_emulated.py.  Each warp
// runs as 32 std::threads that meet at every warp shuffle and ballot;
// blocks, and the warps of a block, run one after another.  Launches
// `kernel<<<grid, block, smem, stream>>>(args)` are rewritten by the test
// into `EmuLaunch(grid, block, smem, stream)(kernel)(args)`.  Only what the
// engine-round and table kernels use is here.
#pragma once

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
inline thread_local dim3 threadIdx, blockIdx, blockDim;
inline thread_local EmuWarp* emu_warp;
inline thread_local int emu_lane;

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
      for (unsigned bx = 0; bx < g.x; ++bx)
        for (unsigned w0 = 0; w0 < b.x; w0 += 32) {
          EmuWarp warp;
          std::vector<std::thread> lanes;
          for (int l = 0; l < 32; ++l)
            lanes.emplace_back([&, l] {
              blockIdx = dim3(bx);
              blockDim = b;
              threadIdx = dim3(w0 + l);
              emu_warp = &warp;
              emu_lane = l;
              kernel(args...);
            });
          for (auto& t : lanes) t.join();
        }
    };
  }
};
