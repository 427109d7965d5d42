// Flash attention: causal (or full) multi-head attention with an online
// softmax, scale 1/sqrt(d), q/k/v (B*H, S, d) -> out (B*H, S, d) in the
// input dtype.  Running max, denominator and accumulator are float32;
// masked scores are -1e30; out = acc / max(l, 1e-30).
//
// Replaces the TPU kernel flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention/flash_attention.py.  There the k tiles
// are the innermost sequential grid axis and (max, denom, acc) live in VMEM
// scratch across it; here one block per (b*h, 64-row q tile) loops over the
// k tiles itself, with (max, denom) in shared memory and acc in registers,
// and stops at the diagonal when causal (the TPU grid visits the masked
// tiles too; they add nothing).
//
// This is the CUDA-core route: the wrapper
// (kernels/flash_attention/ops.py:route) sends it float32 with d not a
// multiple of 8 or above 128, and bf16 with d not a multiple of 16 or above
// 128.  float32 with d a multiple of 8 up to 128 goes to the tensor cores
// in three TF32 terms (flash_attention_tf32.cu; one term would miss the
// float32 sweep's atol 3e-5, three keep it), bf16 with d a multiple of 16
// up to 128 to flash_attention_wgmma.cu.
//
// Bound on this card: operations (2 * 2 * S^2 * d per head, halved when
// causal, against a few bytes per row).  It computes on the CUDA cores in
// float32: 256 threads each hold a 4x4 register tile of the 64x64
// scores and a 4x(4*KD) tile of the 64xd accumulator (lm_common.cuh), read
// float4s from q and k tiles stored transposed, and reduce each row's max
// and sum over 4 neighbouring lanes by shuffles.  Tiles are the kernel's own (64 x 64);
// the API's block_q/block_k only set the wrapper's divisibility check.
// Shared memory: 2*d*68 + 64*64*KD + 64*68 floats, 223 KB at d = 256.
// Heavy causal tiles (late q tiles) are scheduled first.
#include <cfloat>

#include "lm_common.cuh"

namespace {

using repro::kLd;
using repro::kTile;
using repro::ld4;
using repro::outer4;
constexpr int kBlock = repro::kThreads;
constexpr float kMasked = -1e30f;

inline size_t smem_floats(int d, int kd) {
  return 2 * static_cast<size_t>(d) * kLd + kTile * 64 * kd + kTile * kLd +
         3 * kTile;
}

// KD: the accumulator's column tiles of 64 (d <= 64 * KD)
template <typename T, int KD>
__global__ void __launch_bounds__(kBlock)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int64_t bh_count,
             int64_t S, int d, float scale, int causal) {
  constexpr int DP = 64 * KD;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                // [c][i] q tile, d x kLd
  float* kt = qt + d * kLd;        // [c][j] k tile, d x kLd
  float* vs = kt + d * kLd;        // [j][c] v tile, 64 x DP
  float* sT = vs + kTile * DP;     // [j][i] scores, then probabilities
  float* m_s = sT + kTile * kLd;   // running max per row
  float* l_s = m_s + kTile;        // running denominator per row
  float* a_s = l_s + kTile;        // this k tile's rescale per row

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t nqt = (S + kTile - 1) / kTile;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t order = blockIdx.x / bh_count;
  const int64_t qi = causal ? nqt - 1 - order : order;
  const int64_t q0 = qi * kTile;
  const int64_t base = bh * S * d;

  for (int e = tid; e < kTile * d; e += kBlock) {
    const int ii = e / d, c = e - ii * d;
    qt[c * kLd + ii] =
        q0 + ii < S ? repro::to_f32(q[base + (q0 + ii) * d + c]) : 0.0f;
  }
  if (tid < kTile) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.0f;
  }
  float acc[KD][4][4] = {};

  const int64_t nkt = causal ? qi + 1 : nqt;
  for (int64_t kj = 0; kj < nkt; ++kj) {
    const int64_t k0 = kj * kTile;
    for (int e = tid; e < kTile * d; e += kBlock) {
      const int jj = e / d, c = e - jj * d;
      kt[c * kLd + jj] =
          k0 + jj < S ? repro::to_f32(k[base + (k0 + jj) * d + c]) : 0.0f;
    }
    for (int e = tid; e < kTile * DP; e += kBlock) {
      const int jj = e / DP, c = e - jj * DP;
      vs[e] = (k0 + jj < S && c < d)
                  ? repro::to_f32(v[base + (k0 + jj) * d + c])
                  : 0.0f;
    }
    __syncthreads();

    // scores: scaled, then masked
    float sc[4][4] = {};
    for (int c = 0; c < d; ++c)
      outer4(sc, ld4(qt + c * kLd + ty * 4), ld4(kt + c * kLd + tx * 4));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t i = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t j = k0 + tx * 4 + c;
        const bool masked = j >= S || (causal && j > i);
        sT[(tx * 4 + c) * kLd + ty * 4 + r] =
            masked ? kMasked : sc[r][c] * scale;
      }
    }
    __syncthreads();

    // online softmax: four lanes per row, 16 columns each
    {
      const int row = tid >> 2, part = tid & 3;
      const float m_prev = m_s[row], l_prev = l_s[row];
      float mx = -FLT_MAX;
      for (int jj = part * 16; jj < part * 16 + 16; ++jj)
        mx = fmaxf(mx, sT[jj * kLd + row]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int jj = part * 16; jj < part * 16 + 16; ++jj) {
        const float p = expf(sT[jj * kLd + row] - m_new);
        sT[jj * kLd + row] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[row] = m_new;
        l_s[row] = alpha * l_prev + sum;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = a_s[ty * 4 + r];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[kk][r][c] *= alpha;
    }
    for (int jj = 0; jj < kTile; ++jj) {
      const float4 p = ld4(sT + jj * kLd + ty * 4);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        outer4(acc[kk], p, ld4(vs + jj * DP + kk * 64 + tx * 4));
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + ty * 4 + r;
    if (i >= S) continue;
    const float den = fmaxf(l_s[ty * 4 + r], 1e-30f);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kk * 64 + tx * 4 + c;
        if (col < d)
          out[base + i * d + col] = repro::from_f32<T>(acc[kk][r][c] / den);
      }
  }
}

template <typename T, int KD>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int64_t seq, int d, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(d, KD) * sizeof(float);
  auto kernel = flash_kernel<T, KD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = bh * ((seq + kTile - 1) / kTile);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kBlock, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, seq, d, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             int64_t bh, int64_t seq, int d, float scale, int causal,
             cudaStream_t s) {
  switch ((d + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, out, bh, seq, d, scale, causal, s);
    case 2: return launch<T, 2>(q, k, v, out, bh, seq, d, scale, causal, s);
    case 3: return launch<T, 3>(q, k, v, out, bh, seq, d, scale, causal, s);
    case 4: return launch<T, 4>(q, k, v, out, bh, seq, d, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

REPRO_API int flash_attention_launch(const void* q, const void* k,
                                     const void* v, void* out, int64_t bh,
                                     int64_t seq, int head_dim, float scale,
                                     int causal, int dtype, void* stream) {
  if (bh < 1 || seq < 1 || head_dim < 1 || head_dim > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return launch_d<float>(q, k, v, out, bh, seq, head_dim, scale, causal,
                             s);
    case repro::kBF16:
      return launch_d<__nv_bfloat16>(q, k, v, out, bh, seq, head_dim, scale,
                                     causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
