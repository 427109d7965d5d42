// Flash attention on Hopper's tensor cores (wgmma), bfloat16 in and out:
// causal (or full) multi-head attention with an online softmax, scale
// 1/sqrt(d), q/k/v (B*H, S, d) -> out (B*H, S, d), d a multiple of 16 up
// to 128.  Running max, denominator and accumulator are float32; masked
// scores are -1e30; out = acc / max(l, 1e-30).  float32 with d a multiple
// of 8 up to 128 takes the tensor cores in three TF32 terms
// (flash_attention_tf32.cu); the other head dims, in either dtype, take the
// CUDA-core kernel in flash_attention.cu; the wrapper
// (kernels/flash_attention/ops.py:route) chooses.
//
// Replaces the TPU kernel flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention/flash_attention.py:62, as the other two
// kernels do for the other inputs.
//
// Bound on this card: bf16 operations, 2 * 2 * B*H * S^2 * d, halved when
// causal (against 4 * B*H * S * d * 2 bytes).
//
// Design.  A block of two consumer warpgroups (256 threads) owns 128 query
// rows, 64 per warpgroup, matching wgmma's m64; the heaviest causal q tiles
// are scheduled first.  Q is loaded once into shared memory; K and V tiles
// of BN key rows (64 at d <= 64, 128 above) stream through a ring of three
// stages.  The loads are cp.async, 16 bytes a thread, issued by all 256
// threads two tiles ahead; each thread then arrives on the stage's "full"
// mbarrier when its copies land (cp.async.mbarrier.arrive.noinc), and
// every thread arrives on the stage's "empty" mbarrier once its P V on
// that tile has completed, which frees the stage for the tile three later.
// Rows past S and the columns that pad d up to 64 or 128 are zero-filled
// by the copy itself (src-size 0).  (cp.async rather than TMA: a tensor map
// needs cuTensorMapEncodeTiled from libcuda, which this library does not
// link.)  Every tile is stored with the 128-byte swizzle (the 16-byte chunk
// c of row r at chunk c ^ (r % 8) of its 128-byte row, 64-column blocks one
// after another), the layout the wgmma descriptors name (layout type 1,
// 8-row groups 1024 bytes apart).
//   Turns: the warpgroups take the tensor cores in turn (named barriers 1
//     and 2): one issues P V of tile j and Q K^T of tile j + 1 and hands
//     over, then runs its softmax on the CUDA cores while the other's
//     products run.
//   S = Q K^T: wgmma m64nBNk16, Q and K both K-major from shared memory,
//     float32 accumulators in registers.
//   Softmax: on the accumulator fragment in registers; a thread holds two
//     rows, each spread over the 4 lanes of a quad, so a row max takes two
//     shuffles (the row sum stays per thread until the epilogue); one
//     ex2.approx per score with log2(e) folded into the scale; no score
//     tile goes to shared memory.  Only tiles reaching the diagonal
//     (causal) or past S are masked.
//   O += P V: wgmma m64nDk16 with P as A from registers (the accumulator
//     fragment of S is, pair by pair, the A fragment of the next product)
//     and V as B read MN-major through the descriptor's transpose bit, so no
//     transposed copy of V is made.  P is carried as two bfloat16 terms,
//     hi = bf16(p) and lo = bf16(p - hi), each its own wgmma: one bf16
//     rounding of p (2^-9 relative) breaks the one-bf16-step tolerance that
//     the plain version is held to at every shape of the sweep
//     (tests/test_torch_kernel_routes.py emulates both), while hi + lo keeps
//     p to about 2^-17.  That is half as much tensor work again (Q K^T
//     once, P V twice).
//   Registers: at d <= 64 with 64-key tiles a thread holds S (32), P (32)
//     and O (32), fits 128 registers, and two blocks share an SM; at d = 128
//     with 128-key tiles (S 64, P 64, O 64) one block takes an SM and Q K^T
//     waits for P V instead of running beside it.
//   Epilogue: divide by max(l, 1e-30), round to bf16, stage through the
//     warpgroup's own rows of the (then idle) Q tile, and store 16 bytes a
//     thread.
// Shared memory: Q 128 x D plus K and V 3 x BN x D each, bf16: 64 KB at
// d <= 64, 224 KB at d = 128.
#include <cuda_bf16.h>

#include "lm_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;           // query rows of a block
constexpr int kKeyTileD64 = 64;    // key rows of a K/V tile at d <= 64
constexpr int kThreadsFA = 256;    // two warpgroups of 64 query rows each
constexpr int kStages = 3;         // K/V ring
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// rows [row0, row0 + ROWS) of a (S, d) matrix into a swizzled ROWS x DP
// tile; rows past S and columns past d are zero-filled
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g,
                                          int64_t row0, int64_t S, int d,
                                          int tid) {
  constexpr int kChunks = DP / 8;
  static_assert(ROWS * kChunks % kThreadsFA == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreadsFA; ++i) {
    const int e = tid + i * kThreadsFA;
    const int r = e / kChunks, c = e % kChunks;
    const int64_t gr = row0 + r;
    const bool ok = gr < S && c * 8 < d;
    cp_async16(dst + swz<ROWS>(r, c), ok ? g + gr * d + c * 8 : g,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma m64nNk16, float32 += bf16 x bf16 (operand lists written out)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (DP == 64)
    wgmma_rs_n64(d, a, desc_b);
  else
    wgmma_rs_n128(d, a, desc_b);
}

// mbarriers in shared memory
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the barrier's pending count falls by one when all of this thread's
// earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_on_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// byte offsets in the block's shared memory (from a 1024-aligned base)
template <int DP, int BN>
struct Layout {
  static constexpr int kTile = BN * DP * 2;  // one K or V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kBM * DP * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBytes = kV + kStages * kTile;
};

// One warpgroup's state: its 64 query rows' accumulator fragment (rows r
// and r + 8 of the warpgroup, columns 8 i + cq and 8 i + cq + 1 of each
// n8 block i), running max (log2 domain) and this thread's part of the
// running denominator.
template <int DP>
struct Rows {
  float o[DP / 2];
  float m[2];
  float l[2];
};

// S = Q K^T for this warpgroup's rows against the K tile at sK (the first
// k step overwrites S); k step ks is 32 bytes into 64-column block ks / 4
template <int DP, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t sQ,
                                         uint32_t sK, int wg) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t kcol = (ks & 3) * 32;
    wgmma_ss<BN>(
        s, desc_sw128(sQ + (ks >> 2) * kBM * 128 + wg * 64 * 128 + kcol, 16,
                      1024),
        desc_sw128(sK + (ks >> 2) * BN * 128 + kcol, 16, 1024), ks > 0);
  }
  wgmma_commit();
}

// O += P V against the V tile at sV (MN-major: 16 key rows a step, 2048
// bytes; 64-column blocks BN * 128 bytes apart), P as hi + lo
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4],
                                         uint32_t sV) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    const uint64_t dv = desc_sw128(sV + j * 16 * 128, BN * 128, 1024);
    wgmma_rs<DP>(o, ph[j], dv);
    wgmma_rs<DP>(o, pl[j], dv);
  }
  wgmma_commit();
}

// the online softmax of one score tile, on the fragment in registers (a row
// lives on the 4 lanes of a quad); leaves P in ph/pl and rescales o
template <int DP, int BN>
__device__ __forceinline__ void softmax(float (&s)[BN / 2], Rows<DP>& st,
                                        uint32_t (&ph)[BN / 16][4],
                                        uint32_t (&pl)[BN / 16][4],
                                        float scale_log2, bool edge,
                                        int64_t k0, int64_t row, int64_t S,
                                        int causal, int cq) {
  if (edge) {  // the diagonal tile and the tile past S
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int64_t col = k0 + 8 * (i >> 2) + cq + (i & 1);
      if (col >= S || (causal && col > row + 8 * ((i >> 1) & 1)))
        s[i] = kMasked;
    }
  }
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float alpha[2], neg[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h] * scale_log2);
    alpha[h] = ex2(st.m[h] - m_new);
    st.m[h] = m_new;
    neg[h] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float p = ex2(fmaf(s[i], scale_log2, neg[(i >> 1) & 1]));
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + rs[h];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) st.o[i] *= alpha[(i >> 1) & 1];
  // P as A fragments, k16 step j = columns 16 j .. 16 j + 15: the pairs of
  // n8 blocks 2 j and 2 j + 1
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[8 * j + 2 * r], x1 = s[8 * j + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      ph[j][r] = bf16x2_bits(hi);
      pl[j][r] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// DP: d padded to the 64-column swizzle blocks (64 or 128); BN: key rows
// of a K/V tile (64 or 128); a block of 128 x 64 tiles fits twice an SM
template <int DP, int BN>
__global__ void __launch_bounds__(kThreadsFA, BN == 64 ? 2 : 1)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   int64_t bh_count, int64_t S, int d, float scale_log2,
                   int causal) {
  using L = Layout<DP, BN>;
  __shared__ uint64_t full[kStages], empty[kStages];
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t full0 = smem_u32(&full[0]), empty0 = smem_u32(&empty[0]);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int64_t nqt = (S + kBM - 1) / kBM;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t order = blockIdx.x / bh_count;
  const int64_t qi = causal ? nqt - 1 - order : order;
  const int64_t q0 = qi * kBM;
  const int64_t off = bh * S * d;
  const bf16* qg = q + off;
  const bf16* kg = k + off;
  const bf16* vg = v + off;
  // causal: the tiles up to the one holding the block's last row
  const int64_t nkt_all = (S + BN - 1) / BN;
  const int64_t last = (q0 + kBM + BN - 1) / BN;
  const int64_t nkt = causal && last < nkt_all ? last : nkt_all;
  // tiles that need the mask: those reaching the diagonal or past S
  auto edge = [&](int64_t t) {
    return (causal && (t + 1) * BN > q0) || (t + 1) * BN > S;
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full0 + 8 * i, kThreadsFA);
      mbar_init(empty0 + 8 * i, kThreadsFA);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile j sits in stage j % kStages; its fill and its release are phase
  // j / kStages of that stage's barriers.  Every thread copies its share of
  // a tile and arrives on the stage's full barrier when its copies land.
  auto load_kv = [&](int64_t j) {
    const int st = static_cast<int>(j % kStages);
    load_tile<BN, DP>(sK + st * L::kTile, kg, j * BN, S, d, tid);
    load_tile<BN, DP>(sV + st * L::kTile, vg, j * BN, S, d, tid);
    mbar_arrive_on_copies(full0 + 8 * st);
  };
  auto wait_full = [&](int64_t j) {
    mbar_wait(full0 + 8 * (j % kStages),
              static_cast<uint32_t>((j / kStages) & 1));
    fence_async_smem();
  };
  load_tile<kBM, DP>(sQ, qg, q0, S, d, tid);
  load_kv(0);  // lands with Q
  if (nkt > 1) load_kv(1);

  const int rw = 16 * warp + (lane >> 2);
  const int64_t row = q0 + 64 * wg + rw;
  const int cq = 2 * (lane & 3);
  Rows<DP> st;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) st.o[i] = 0.0f;
  st.m[0] = st.m[1] = kMasked;
  st.l[0] = st.l[1] = 0.0f;
  float s[BN / 2] = {};
  uint32_t ph[BN / 16][4], pl[BN / 16][4];
  // at D = 64 Q K^T of the next tile is issued beside P V of this one; at
  // 128 the registers of both would not fit, so it follows P V
  constexpr bool kOverlap = DP * BN <= 64 * 128;

  // The warpgroups take turns on the tensor cores (named barriers 1 and
  // 2): one issues P V of tile j and Q K^T of tile j + 1 while the other
  // runs its softmax on the CUDA cores.  Warpgroup 0 goes first.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) bar_arrive(1, kThreadsFA);
  wait_full(0);
  bar_sync(my_turn, kThreadsFA);
  issue_qk<DP, BN>(s, sQ, sK, wg);
  bar_arrive(their_turn, kThreadsFA);
  wgmma_wait<0>();
  keep(s);
  softmax<DP, BN>(s, st, ph, pl, scale_log2, edge(0), 0, row, S, causal,
                  cq);

  for (int64_t kt = 0; kt < nkt; ++kt) {
    const int64_t j = kt + 2;  // the tile to prefetch, into kt - 1's stage
    if (j < nkt) {
      if (j >= kStages)
        mbar_wait(empty0 + 8 * (j % kStages),
                  static_cast<uint32_t>((j / kStages - 1) & 1));
      load_kv(j);
    }
    const bool more = kt + 1 < nkt;
    if (more) wait_full(kt + 1);
    const uint32_t next_k =
        sK + static_cast<int>((kt + 1) % kStages) * L::kTile;
    bar_sync(my_turn, kThreadsFA);
    issue_pv<DP, BN>(st.o, ph, pl,
                     sV + static_cast<int>(kt % kStages) * L::kTile);
    if (kOverlap && more) {
      issue_qk<DP, BN>(s, sQ, next_k, wg);
      keep(s);
    }
    // the other warpgroup's products queue behind these; warpgroup 1's
    // last turn is the block's last, and nobody waits on it
    if (wg == 0 || more) bar_arrive(their_turn, kThreadsFA);
    if (kOverlap && more)
      wgmma_wait<1>();  // P V done, Q K^T may still run
    else
      wgmma_wait<0>();
    keep(st.o);
    keep(ph);
    keep(pl);
    mbar_arrive(empty0 + 8 * (kt % kStages));
    if (more) {
      if (!kOverlap) issue_qk<DP, BN>(s, sQ, next_k, wg);
      wgmma_wait<0>();
      keep(s);
      softmax<DP, BN>(s, st, ph, pl, scale_log2, edge(kt + 1), (kt + 1) * BN,
                      row, S, causal, cq);
    }
  }

  // epilogue: whole-row denominators, then bf16 through this warpgroup's
  // rows of the Q tile (no other warpgroup reads them)
  float den[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(0xffffffffu, st.l[h], 2);
    den[h] = fmaxf(st.l[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + rw + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(smem + L::kQ + swz<kBM>(r, i) +
                                         2 * cq) =
          __floats2bfloat162_rn(st.o[4 * i + 2 * h] / den[h],
                                st.o[4 * i + 2 * h + 1] / den[h]);
    }
  bar_sync(3 + wg, 128);
  constexpr int kChunks = DP / 8;
  const int t = tid & 127;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int e = t + i * 128;
    const int r = 64 * wg + e / kChunks, c = e % kChunks;
    const int64_t gr = q0 + r;
    if (gr < S && c * 8 < d)
      *reinterpret_cast<uint4*>(out + off + gr * d + c * 8) =
          *reinterpret_cast<const uint4*>(smem + L::kQ + swz<kBM>(r, c));
  }
}

template <int DP, int BN>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int64_t seq, int d, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = Layout<DP, BN>::kBytes + 1024;  // + the alignment slack
  auto kernel = flash_wgmma_kernel<DP, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = bh * ((seq + kBM - 1) / kBM);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreadsFA, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), bh, seq, d,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int flash_attention_wgmma_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           int64_t bh, int64_t seq,
                                           int head_dim, float scale,
                                           int causal, void* stream) {
  if (bh < 1 || seq < 1 || head_dim < 16 || head_dim > 128 ||
      head_dim % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return head_dim <= 64 ? launch<64, kKeyTileD64>(q, k, v, out, bh, seq,
                                                 head_dim, scale, causal, s)
                        : launch<128, 128>(q, k, v, out, bh, seq, head_dim,
                                           scale, causal, s);
}
