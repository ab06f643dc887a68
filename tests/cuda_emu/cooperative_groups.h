// A stand-in for CUDA's cooperative groups, for the CPU emulator of
// cuda_runtime.h: the grid of a cooperative launch and its barrier.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct grid_group {
  void sync() const { emu_grid->bar.arrive_and_wait(); }
};

inline grid_group this_grid() { return grid_group{}; }

}  // namespace cooperative_groups
