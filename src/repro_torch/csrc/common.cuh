// Shared definitions of the port's CUDA kernels.
//
// Every entry point has a plain C interface (device pointers, sizes and the
// CUDA stream as void*), launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;
constexpr int kSms = 132;  // H100 SXM

// Blocks for a grid-stride loop over n items: enough to cover n with
// `per_thread` items a thread, capped at `cap` blocks.
inline int grid_for(int64_t n, int per_thread, int cap) {
  int64_t per_block = static_cast<int64_t>(kThreads) * per_thread;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace repro
