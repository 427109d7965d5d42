// Vectorized predicate evaluation: mask = AND_k (col_k OP_k lit_k).
//
// Replaces the TPU kernel filter_eval_pallas / _filter_kernel in
// src/repro/kernels/filter_eval/filter_eval.py.  Op codes: 0 '<', 1 '<=',
// 2 '>', 3 '>=', 4 '==', 5 '!='.  Columns are float32 (the executor's gate
// admits only columns and literals that float32 holds exactly), compared in
// float32, so the mask is bit-exact against the plain torch version, NaN
// and -0.0 included.
//
// Bound on this card: bytes.  Each row reads 4 bytes per column and writes
// one byte; there is one compare per column.  The design keeps the whole
// conjunction in registers, so no intermediate mask goes to device memory
// (the TPU kernel's VMEM fusion), and moves the bytes in wide accesses: a
// thread takes four rows, one 16-byte load per column and one 4-byte store
// of the four mask bytes.  That needs every column and the output at the
// same phase: `head` rows (0-3, computed by the wrapper:
// kernels/filter_eval/ops.py: vector_head) bring the columns to a 16-byte
// boundary and the output to a 4-byte one; those rows and the last n - head
// mod 4 are taken one by one.  When the columns' phases differ, head is -1
// and every row is taken one by one.  The trip's staging puts every array
// on a 128-byte boundary, so the executor's calls have head 0.  The grid is
// one wave (the SMs times the blocks the kernel keeps resident on each).
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

__device__ __forceinline__ uint8_t row_mask(const FilterArgs& a, int64_t i) {
  bool m = true;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < a.k) m &= cmp(__ldg(a.cols[c] + i), a.ops[c], a.lits[c]);
  }
  return m ? 1 : 0;
}

// rows i .. i + 3 as four mask bytes, row i in the lowest
__device__ __forceinline__ uint32_t quad_mask(const FilterArgs& a, int64_t i) {
  uint32_t m = 0x01010101u;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < a.k) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(a.cols[c] + i));
      const int op = a.ops[c];
      const float lit = a.lits[c];
      m &= static_cast<uint32_t>(cmp(x.x, op, lit)) |
           static_cast<uint32_t>(cmp(x.y, op, lit)) << 8 |
           static_cast<uint32_t>(cmp(x.z, op, lit)) << 16 |
           static_cast<uint32_t>(cmp(x.w, op, lit)) << 24;
    }
  }
  return m;
}

__global__ void filter_eval_kernel(FilterArgs a, int64_t n, int64_t head,
                                   uint8_t* out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (head < 0) {
    for (int64_t i = t; i < n; i += stride) out[i] = row_mask(a, i);
    return;
  }
  const int64_t quads = (n - head) / 4;
  for (int64_t q = t; q < quads; q += stride) {
    const int64_t i = head + 4 * q;
    *reinterpret_cast<uint32_t*>(out + i) = quad_mask(a, i);
  }
  const int64_t tail = head + 4 * quads;
  if (t < head) out[t] = row_mask(a, t);
  if (t < n - tail) out[tail + t] = row_mask(a, tail + t);
}

// one wave of filter_eval_kernel's blocks on this card
int wave_blocks() {
  static const int blocks = [] {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, filter_eval_kernel, repro::kThreads, 0) != cudaSuccess ||
        per_sm < 1)
      per_sm = 1;
    return per_sm * repro::sm_count();
  }();
  return blocks;
}

}  // namespace

REPRO_API int filter_eval_launch(const void* const* cols, const int* ops,
                                 const float* lits, int k, int64_t n,
                                 void* out, int64_t head, void* stream) {
  if (k < 1 || k > kMaxCols || head < -1 || head > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  FilterArgs a;
  for (int c = 0; c < kMaxCols; ++c) {
    a.cols[c] = c < k ? static_cast<const float*>(cols[c]) : nullptr;
    a.ops[c] = c < k ? ops[c] : 0;
    a.lits[c] = c < k ? lits[c] : 0.0f;
  }
  a.k = k;
  auto o = static_cast<uint8_t*>(out);
  if (head > n) head = n;
  if (head >= 0 && n - head >= 4) {
    // the wrapper's phase, checked: a misaligned wide access would fault
    bool in_phase = (reinterpret_cast<uintptr_t>(o + head) & 3) == 0;
    for (int c = 0; c < k; ++c)
      in_phase = in_phase && repro::aligned16(a.cols[c] + head);
    if (!in_phase) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int64_t work = head < 0 ? n : (n - head) / 4 + 3;
  int blocks = repro::grid_for(work, 1, wave_blocks());
  filter_eval_kernel<<<blocks, repro::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, n, head, o);
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int filter_eval_trip(REPRO_TRIP_PARAMS, const void* const* cols,
                                const int* ops, const float* lits, int k,
                                int64_t n, void* out, int64_t head,
                                void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return filter_eval_launch(cols, ops, lits, k, n, out, head, stream);
  });
}
