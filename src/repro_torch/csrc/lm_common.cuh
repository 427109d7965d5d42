// Shared by the LM kernels (ssd_scan, flash_attention): the floating types
// they take (float32, bfloat16), converted to and from float32 by the
// intrinsics; the 64 x 64 register-tiled products that flash_attention's
// CUDA-core route computes: 16 x 16 threads, each holding a 4 x 4 tile of
// the product and reading float4s from tiles stored transposed ([col][row],
// rows padded to kLd so the float4 reads stay aligned and spread over the
// banks); and the split of a float32 into two TF32 values that the
// tensor-core products of ssd_scan and of flash_attention's float32 route
// (flash_attention_tf32.cu) take in three terms, lo*hi + hi*lo + hi*hi
// ("3xTF32"), with mma.sync's m16n8k8 fragments for ssd_scan.
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

// ---- TF32 products on the tensor cores ---------------------------------
// cvt.rna.tf32.f32 for finite v: round the magnitude to 10 mantissa bits,
// ties away from zero (half a step added to the bits, the low 13 cleared),
// in two integer operations and without the instruction's NaN handling
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, each a TF32 value
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An m16 x k8 A fragment, split: element r of lane (g = lane / 4,
// t = lane % 4) is (row g + 8 (r & 1), column t + 4 (r >> 1)).
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int r, float v) { split(v, hi[r], lo[r]); }
};

// hi and lo of v side by side, as the split shared tiles hold them
__device__ __forceinline__ uint2 split2(float v) {
  uint2 r;
  split(v, r.x, r.y);
  return r;
}

// d += A B for one k8 x n8 B fragment (rows t and t + 4, column g), the
// small terms first
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          uint2 b0, uint2 b1) {
  mma(d, a.lo, b0.x, b1.x);
  mma(d, a.hi, b0.y, b1.y);
  mma(d, a.hi, b0.x, b1.x);
}

// the same with a B fragment split here (pass 3, a small share of the work)
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          float b0, float b1) {
  mma_split(d, a, split2(b0), split2(b1));
}

}  // namespace repro
