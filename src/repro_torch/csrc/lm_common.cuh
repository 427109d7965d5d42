// Shared by the LM kernels (ssd_scan, flash_attention): the floating types
// they take (float32, bfloat16), converted to and from float32 by the
// intrinsics; and the 64 x 64 register-tiled products that flash_attention's
// CUDA-core route computes: 16 x 16 threads, each holding a 4 x 4 tile of
// the product and reading float4s from tiles stored transposed ([col][row],
// rows padded to kLd so the float4 reads stay aligned and spread over the
// banks).
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro {

// dtype codes the Python wrappers pass (their DTYPES tables)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kTile = 64;       // rows and columns of a tiled product
constexpr int kLd = kTile + 4;  // padded row of a transposed [col][row] tile
static_assert(kThreads == 16 * 16, "one 4x4 tile of 64x64 per thread");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][c] += a[r] * b[c]: one step of a thread's 4x4 tile
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

}  // namespace repro
