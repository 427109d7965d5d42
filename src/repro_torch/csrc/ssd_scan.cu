// Mamba2 SSD chunked scan with zero initial state.  For every (b, h), over
// the chunks of Q rows in order, carrying a (P, N) float32 state:
//   y     = ((C B^T) o L) x + (C state^T) o exp(cum)
//   state <- (x o exp(cum[-1] - cum))^T B + state * exp(cum[-1])
// where cum is the in-chunk cumulative sum of dA and L[i,j] =
// exp(cum_i - cum_j) for i >= j, else 0.
//
// Replaces the TPU kernel ssd_scan_pallas / _ssd_chunk_kernel in
// src/repro/kernels/ssd_scan/ssd_scan.py.  There the chunk axis is a
// sequential grid axis and the state a VMEM scratch buffer carried from one
// grid step to the next; blocks on Hopper run in no order, so here one block
// per (b, h) walks its chunks itself, with the state in shared memory.
//
// Bound on this card: operations (float32 outside the tensor cores; the
// causal work is Q(Q+1)(N + P) + 4QNP per chunk and head, against a few
// bytes of input per row; the JAX kernel computes the full Q x Q square).
// Design:
//  - A chunk of 256 rows does not fit shared memory (B and C alone are
//    128 KB each in float32 at N = 128), so it is walked in tiles of 64
//    rows: for each tile of output rows i, the carried state's part, then
//    the causal tiles j <= i of (C_i B_j^T o L_ij) x_j (tiles above the
//    diagonal are all zero and skipped); then the state update, summed in
//    registers over every tile j.  About 134 KB of dynamic shared memory.
//  - 256 threads; each holds a 4x4 register tile of every 64x64 product
//    (lm_common.cuh) and reads float4s from tiles stored transposed where
//    that keeps the reads contiguous.
//  - L is computed from the difference cum_i - cum_j for j <= i only, never
//    as exp(cum_i) * exp(-cum_j): at mamba2-130m's decays cum falls to about
//    -1e3 within a chunk, and exp(+1e3) is inf in float32.
//  - B and C are indexed by batch, so the H blocks of one batch read the
//    same rows (through L2) instead of per-head copies.
//  - Inputs (all float32 or all bfloat16) are read in their dtype and
//    converted to float32; y is float32.
//  - Occupancy: B*H blocks, 48 at the prefill shape (B = 2, H = 24) on 132
//    SMs; states of parallel chunks are work for a later version.
#include "lm_common.cuh"

namespace {

using repro::kLd;
using repro::kTile;
using repro::ld4;
using repro::outer4;
constexpr int kBlock = repro::kThreads;
constexpr int kP = 64;          // columns of the x, y and state tiles
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;

inline size_t smem_floats(int N, int Q) {
  const int qr = (Q + 3) & ~3, np = (N + 3) & ~3;
  const int bsz = N * kLd > kTile * np ? N * kLd : kTile * np;
  return static_cast<size_t>(qr) + N * kP + N * kLd + bsz + kTile * kP +
         kTile * kLd;
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dA,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ y, int64_t S, int H, int P, int N,
                int Q) {
  extern __shared__ __align__(16) float smem[];
  const int qr = (Q + 3) & ~3, np = (N + 3) & ~3;
  const int bsz = N * kLd > kTile * np ? N * kLd : kTile * np;
  float* cum = smem;            // [Q] cumulative log decay of the chunk
  float* st = cum + qr;         // [n][p] carried state, N x 64
  float* ct = st + N * kP;      // [n][i] C tile, N x kLd
  float* bt = ct + N * kLd;     // [n][j] B tile (N x kLd) or [j][n] (64 x np)
  float* xs = bt + bsz;         // [j][p] x tile, 64 x 64
  float* sT = xs + kTile * kP;  // [j][i] masked, decayed scores, 64 x kLd

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x % H;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / H) * S;
  const int tiles = (Q + kTile - 1) / kTile;

  for (int e = tid; e < N * kP; e += kBlock) st[e] = 0.0f;

  for (int64_t s0 = 0; s0 < S; s0 += Q) {
    const int64_t r0 = row0 + s0;  // first row of the chunk in (B*S)
    // cum: warp 0, each lane a run of rows, then a shuffle scan over the
    // lanes' totals
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = tid * per, hi = min(lo + per, Q);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run += repro::to_f32(dA[(r0 + i) * H + h]);
        cum[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += base;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];

    // ---- y, one tile of 64 rows i at a time
    for (int it = 0; it < tiles; ++it) {
      const int i0 = it * kTile;
      for (int e = tid; e < kTile * N; e += kBlock) {
        const int ii = e / N, n = e - ii * N;
        ct[n * kLd + ii] =
            i0 + ii < Q ? repro::to_f32(Cm[(r0 + i0 + ii) * N + n]) : 0.0f;
      }
      __syncthreads();
      // the carried state's part: exp(cum_i) * sum_n C[i,n] state[p,n]
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n)
        outer4(acc, ld4(ct + n * kLd + ty * 4), ld4(st + n * kP + tx * 4));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        const float dec = i < Q ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= dec;
      }
      // the chunk's own part, over the tiles j0 <= i0
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        for (int e = tid; e < kTile * N; e += kBlock) {
          const int jj = e / N, n = e - jj * N;
          bt[n * kLd + jj] =
              j0 + jj < Q ? repro::to_f32(Bm[(r0 + j0 + jj) * N + n]) : 0.0f;
        }
        for (int e = tid; e < kTile * kP; e += kBlock) {
          const int jj = e >> 6, p = e & 63;
          xs[e] = (j0 + jj < Q && p < P)
                      ? repro::to_f32(x[((r0 + j0 + jj) * H + h) * P + p])
                      : 0.0f;
        }
        __syncthreads();
        float sc[4][4] = {};
        for (int n = 0; n < N; ++n)
          outer4(sc, ld4(ct + n * kLd + ty * 4), ld4(bt + n * kLd + tx * 4));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx * 4 + c;
            // j <= i < Q: both cums are defined and the exponent is <= 0
            const float v =
                (i < Q && j <= i) ? sc[r][c] * expf(cum[i] - cum[j]) : 0.0f;
            sT[(tx * 4 + c) * kLd + ty * 4 + r] = v;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < kTile; ++jj)
          outer4(acc, ld4(sT + jj * kLd + ty * 4), ld4(xs + jj * kP + tx * 4));
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (p < P) y[((r0 + i) * H + h) * P + p] = acc[r][c];
        }
      }
    }

    // ---- state update: sum_j (x_j exp(cum_last - cum_j)) B_j^T in
    // registers, thread tile p = tx*4.., n = ty*4 + 64k..
    float up[2][4][4] = {};
    for (int jt = 0; jt < tiles; ++jt) {
      const int j0 = jt * kTile;
      for (int e = tid; e < kTile * np; e += kBlock) {
        const int jj = e / np, n = e - jj * np;
        bt[e] = (j0 + jj < Q && n < N)
                    ? repro::to_f32(Bm[(r0 + j0 + jj) * N + n])
                    : 0.0f;
      }
      for (int e = tid; e < kTile * kP; e += kBlock) {
        const int jj = e >> 6, p = e & 63;
        const int j = j0 + jj;
        xs[e] = (j < Q && p < P)
                    ? repro::to_f32(x[((r0 + j) * H + h) * P + p]) *
                          expf(cum_last - cum[j])
                    : 0.0f;
      }
      __syncthreads();
      for (int jj = 0; jj < kTile; ++jj) {
        const float4 xv = ld4(xs + jj * kP + tx * 4);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int n0 = ty * 4 + 64 * k;
          if (n0 < N) outer4(up[k], xv, ld4(bt + jj * np + n0));
        }
      }
      __syncthreads();
    }
    const float keep = expf(cum_last);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = ty * 4 + 64 * k + c, p = tx * 4 + r;
          if (n < N) st[n * kP + p] = st[n * kP + p] * keep + up[k][r][c];
        }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* dA, const void* B, const void* C,
           void* y, int64_t batch, int64_t seq, int heads, int P, int N,
           int Q, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, Q) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch * heads), kBlock, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dA),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(y), seq, heads, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int ssd_scan_launch(const void* x, const void* dA, const void* B,
                              const void* C, void* y, int64_t batch,
                              int64_t seq, int heads, int head_dim,
                              int d_state, int chunk, int dtype,
                              void* stream) {
  if (batch < 1 || heads < 1 || batch * heads > 0x7fffffff || head_dim < 1 ||
      head_dim > kP || d_state < 1 || d_state > kMaxN || chunk < 1 ||
      chunk > kMaxQ || seq < chunk || seq % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return launch<float>(x, dA, B, C, y, batch, seq, heads, head_dim,
                           d_state, chunk, s);
    case repro::kBF16:
      return launch<__nv_bfloat16>(x, dA, B, C, y, batch, seq, heads,
                                   head_dim, d_state, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
