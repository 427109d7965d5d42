// Vectorized predicate evaluation: mask = AND_k (col_k OP_k lit_k).
//
// Replaces the TPU kernel filter_eval_pallas / _filter_kernel in
// src/repro/kernels/filter_eval/filter_eval.py.  Op codes: 0 '<', 1 '<=',
// 2 '>', 3 '>=', 4 '==', 5 '!='.  Columns are float32 (the executor's gate
// admits only columns and literals that float32 holds exactly), compared in
// float32, so the mask is bit-exact against the plain torch version.
//
// Bound on this card: bytes.  Each row reads 4 bytes per column and writes
// one byte; there is one compare per column.  The design keeps the whole
// conjunction in registers, so no intermediate mask goes to device memory
// (the TPU kernel's VMEM fusion, here in one pass of one thread per row).
// The K column pointers, op codes and literals travel as one by-value kernel
// argument (K <= 8), so there is no metadata copy before the launch.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 8;

struct FilterArgs {
  const float* cols[kMaxCols];
  int ops[kMaxCols];
  float lits[kMaxCols];
  int k;
};

__device__ __forceinline__ bool cmp(float x, int op, float lit) {
  switch (op) {
    case 0: return x < lit;
    case 1: return x <= lit;
    case 2: return x > lit;
    case 3: return x >= lit;
    case 4: return x == lit;
    default: return x != lit;
  }
}

__global__ void filter_eval_kernel(FilterArgs a, int64_t n, uint8_t* out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool m = true;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < a.k) m &= cmp(__ldg(a.cols[c] + i), a.ops[c], a.lits[c]);
    }
    out[i] = m ? 1 : 0;
  }
}

}  // namespace

REPRO_API int filter_eval_launch(const void* const* cols, const int* ops,
                                 const float* lits, int k, int64_t n,
                                 void* out, void* stream) {
  if (k < 1 || k > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  FilterArgs a;
  for (int c = 0; c < kMaxCols; ++c) {
    a.cols[c] = c < k ? static_cast<const float*>(cols[c]) : nullptr;
    a.ops[c] = c < k ? ops[c] : 0;
    a.lits[c] = c < k ? lits[c] : 0.0f;
  }
  a.k = k;
  int blocks = repro::grid_for(n, 4, repro::kSms * 16);
  filter_eval_kernel<<<blocks, repro::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, n, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
