// Flash attention in float32 on Hopper's tensor cores (wgmma, TF32 in three
// terms): causal (or full) multi-head attention with an online softmax,
// scale 1/sqrt(d), q/k/v (B*H, S, d) float32 -> out (B*H, S, d) float32, d a
// multiple of 8 up to 128.  Running max, denominator and accumulator are
// float32; masked scores are -1e30; out = acc / max(l, 1e-30).  The wrapper
// (kernels/flash_attention/ops.py:route) sends bfloat16 with d a multiple of
// 16 up to 128 to flash_attention_wgmma.cu, and the other head dims, in
// either dtype, to flash_attention.cu.
//
// Replaces the TPU kernel flash_attention_pallas / _flash_kernel in
// src/repro/kernels/flash_attention/flash_attention.py:62 for float32.
//
// Bound on this card: operations.  The function needs 2 * 2 * B*H * S^2 * d
// (halved when causal) against 4 * B*H * S * d * 4 bytes; each product runs
// as three TF32 products, lo*hi + hi*lo + hi*hi with hi = rna(x) and
// lo = rna(x - hi) (lm_common.cuh, as in ssd_scan.cu), so the tensor cores
// do three times the work at 495 TFLOP/s.  One TF32 term keeps about three
// decimal digits and misses the float32 sweep's atol 3e-5; three keep about
// 21 bits (tests/test_torch_flash_tf32.py emulates both on the CPU).
//
// Design.  A block of two warpgroups (256 threads) owns 128 query rows, 64
// per warpgroup, wgmma's m64; the heaviest causal q tiles are scheduled
// first.  Both products are wgmma m64nNk8 .tf32, float32 accumulators in
// registers.  TF32 wgmma reads its shared-memory operands K-major only (no
// transpose bit), and every operand has to be split into hi and lo before
// the tensor cores see it, so each tile passes through registers on its way
// to shared memory instead of landing by cp.async:
//   Q: loaded once, split, stored as a hi and a lo tile (K-major: d runs
//     along the 128-byte rows).
//   K and V, in tiles of BN keys: each thread loads its share of tile j + 2
//     into registers (16 bytes at a time, rows coalesced) while tiles j and
//     j + 1 are in shared memory; after issuing P V of tile j it splits and
//     stores tile j + 1 into the other of two stages, beside the running
//     products.  One barrier a tile publishes the stage.  K goes as it is
//     (K-major for Q K^T); V goes transposed, V^T with d as rows and keys
//     along the rows, as P V's K-major B operand.
//   P from registers: the S accumulator fragment gives a thread columns 2t
//     and 2t + 1 of each 8-key block, and the k8 A fragment wants columns t
//     and t + 4.  Rather than stage P through shared memory (16 KB more of
//     traffic and a barrier per tile), the keys are permuted inside each
//     8-key block when V^T is stored: slot t holds key 2t and slot t + 4 key
//     2t + 1.  P's A fragments are then S's registers renamed, and the P V
//     sum runs over the same keys in another order.  A thread loads keys
//     8g + par + {0, 2, 4, 6}, which are slots 4 par .. 4 par + 3 of block g:
//     one 16-byte store a d column.
//   V^T's rows are permuted too: d column 4c + j goes to row
//     32 (c / 8) + 8 j + c % 8, so the eight lanes of a quarter warp (c =
//     0..7) store to eight distinct 16-byte bank groups of the swizzle; the
//     epilogue puts each output column back.
//   Softmax: on the accumulator fragment in registers, as in
//     flash_attention_wgmma.cu (a row on the 4 lanes of a quad, one
//     ex2.approx a score with log2(e) in the scale); P's hi and lo are made
//     from S in place.  Only tiles reaching the diagonal or past S are
//     masked; rows and columns past S or d are zero-filled by the loads.
//   Epilogue: divide by max(l, 1e-30), stage through the warpgroup's own
//     rows of Q's hi tile, store 16 bytes a thread.
// Every tile is stored with the 128-byte swizzle (16-byte chunk c of row r
// at chunk c ^ (r % 8), 32-float blocks of rows one after another), the
// layout the descriptors name; a k8 step is 32 bytes, as bf16's k16.
// Shared memory (Q hi + lo, then K hi, K lo, V^T hi, V^T lo a stage):
//   d <= 32: BN 64, two stages, 32 + 2 x 32 = 96 KB;
//   d <= 64: BN 64, two stages, 64 + 2 x 64 = 192 KB;
//   d <= 128: BN 32, one stage (two would need 256 KB), 128 + 64 = 192 KB;
//     the next tile is stored after P V completes instead of beside it.
// One block an SM.  Registers at d = 64: O 32, S 32, P hi and lo 64, the
// next tile 32.  The two warpgroups issue their products as they come.
// Three variants were built and timed at d = 64 and not kept: the
// warpgroups taking the tensor cores in turn, as flash_attention_wgmma.cu's
// do (no faster); Q K^T's lo terms in an accumulator of their own, two
// chains of products instead of one (no faster); and Q K^T of tile j + 1
// issued beside P V of tile j with the next tile stored under Q K^T
// (slower: two barriers a tile).
#include "lm_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace repro::hopper;
using repro::split;

constexpr int kBM = 128;          // query rows of a block
constexpr int kThreadsFA = 256;   // two warpgroups of 64 query rows each
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// wgmma m64nNk8, float32 += tf32 x tf32 (operand lists written out); A and
// B from shared memory (ss) or A from registers (rs)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 32)
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 32)
    wgmma_rs_n32(d, a, desc_b);
  else if constexpr (N == 64)
    wgmma_rs_n64(d, a, desc_b);
  else
    wgmma_rs_n128(d, a, desc_b);
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// hi and lo of four values, as two 16-byte chunks
__device__ __forceinline__ void split4(float4 v, uint4& hi, uint4& lo) {
  split(v.x, hi.x, lo.x);
  split(v.y, hi.y, lo.y);
  split(v.z, hi.z, lo.z);
  split(v.w, hi.w, lo.w);
}

// byte offsets in the block's shared memory (from a 1024-aligned base)
template <int DP, int BN, int STAGES>
struct Layout {
  static constexpr int kQTile = kBM * DP * 4;  // Q's hi or lo tile
  static constexpr int kKVTile = BN * DP * 4;  // K's or V^T's hi or lo tile
  static constexpr int kQh = 0, kQl = kQTile;
  // a stage: K hi, K lo, V^T hi, V^T lo
  static constexpr int kStage0 = 2 * kQTile, kStage = 4 * kKVTile;
  static constexpr int kBytes = kStage0 + STAGES * kStage;
};

// A thread's share of a K/V tile: key rows 8 g + par + 2 i (i < 4) of the
// 16-byte chunk c (d columns 4c .. 4c + 3), for K and for V; threads past
// the tile's (g, par, c) units hold nothing
template <int DP, int BN>
struct Share {
  static constexpr int kChunks = DP / 4;
  static constexpr int kUnits = BN / 8 * 2 * kChunks;
  static_assert(kUnits <= kThreadsFA, "one unit a thread at most");
  float4 k[4], v[4];
  int c, par, g;
  bool on;
  __device__ __forceinline__ explicit Share(int tid)
      : c(tid % kChunks), par((tid / kChunks) & 1), g(tid / (2 * kChunks)),
        on(tid < kUnits) {}

  // load the tile of keys [k0, k0 + BN); zero past S and past d
  __device__ __forceinline__ void load(const float* kg, const float* vg,
                                       int64_t k0, int64_t S, int d) {
    const bool col_ok = on && c * 4 < d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = k0 + 8 * g + par + 2 * i;
      const bool ok = col_ok && row < S;
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      k[i] = ok ? __ldg(reinterpret_cast<const float4*>(kg + row * d + 4 * c))
                : zero;
      v[i] = ok ? __ldg(reinterpret_cast<const float4*>(vg + row * d + 4 * c))
                : zero;
    }
  }

  // split and store into a stage: K rows as they are; V transposed, d
  // column 4c + j at row 32 (c / 8) + 8 j + c % 8, its keys 8g + par +
  // {0, 2, 4, 6} at slots 4 par .. 4 par + 3 of key block g (chunk 2g + par)
  __device__ __forceinline__ void store(uint8_t* stage) const {
    constexpr int kTile = BN * DP * 4;
    if (!on) return;
    uint4 hi, lo;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t o = swz<BN>(8 * g + par + 2 * i, c);
      split4(k[i], hi, lo);
      *reinterpret_cast<uint4*>(stage + o) = hi;
      *reinterpret_cast<uint4*>(stage + kTile + o) = lo;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t o = swz<DP>(32 * (c >> 3) + 8 * j + (c & 7), 2 * g + par);
      split4(make_float4(at(v[0], j), at(v[1], j), at(v[2], j), at(v[3], j)),
             hi, lo);
      *reinterpret_cast<uint4*>(stage + 2 * kTile + o) = hi;
      *reinterpret_cast<uint4*>(stage + 3 * kTile + o) = lo;
    }
  }
};

// One warpgroup's state: its 64 query rows' accumulator fragment (rows r
// and r + 8 of the warpgroup, columns 8 i + cq and 8 i + cq + 1 of each
// n8 block i, in V^T's row order), running max (log2 domain) and this
// thread's part of the running denominator.
template <int DP>
struct Rows {
  float o[DP / 2];
  float m[2];
  float l[2];
};

// S = Q K^T for this warpgroup's rows against the K tile (hi at sK, lo one
// tile later); k step ks is 32 bytes into 32-float block ks / 4; the small
// terms first, the first product overwrites S
template <int DP, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t sQh,
                                         uint32_t sQl, uint32_t sK, int wg) {
  constexpr uint32_t kKTile = BN * DP * 4;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    const uint32_t qo = (ks >> 2) * kBM * 128 + wg * 64 * 128 + (ks & 3) * 32;
    const uint32_t ko = (ks >> 2) * BN * 128 + (ks & 3) * 32;
    wgmma_ss<BN>(s, desc(sQl + qo), desc(sK + ko), ks > 0);
    wgmma_ss<BN>(s, desc(sQh + qo), desc(sK + kKTile + ko), 1);
    wgmma_ss<BN>(s, desc(sQh + qo), desc(sK + ko), 1);
  }
  wgmma_commit();
}

// O += P V against the V^T tile (hi at sV, lo one tile later; k step j is
// 32 bytes into 32-slot block j / 4), P as hi + lo A fragments
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2],
                                         const uint32_t (&ph)[BN / 8][4],
                                         const uint32_t (&pl)[BN / 8][4],
                                         uint32_t sV) {
  constexpr uint32_t kVTile = BN * DP * 4;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const uint32_t vo = (j >> 2) * DP * 128 + (j & 3) * 32;
    wgmma_rs<DP>(o, pl[j], desc(sV + vo));
    wgmma_rs<DP>(o, ph[j], desc(sV + kVTile + vo));
    wgmma_rs<DP>(o, ph[j], desc(sV + vo));
  }
  wgmma_commit();
}

// the online softmax of one score tile, on the fragment in registers (a row
// lives on the 4 lanes of a quad); leaves P in ph/pl and rescales o
template <int DP, int BN>
__device__ __forceinline__ void softmax(float (&s)[BN / 2], Rows<DP>& st,
                                        uint32_t (&ph)[BN / 8][4],
                                        uint32_t (&pl)[BN / 8][4],
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
  // k8 step j: keys 8j .. 8j + 7, S's n8 block j.  The A fragment's
  // elements (row, slot) (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) are
  // keys 2t, 2t, 2t + 1, 2t + 1 of the block (V^T's slot order): s[4j],
  // s[4j + 2], s[4j + 1], s[4j + 3]
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    split(s[4 * j], ph[j][0], pl[j][0]);
    split(s[4 * j + 2], ph[j][1], pl[j][1]);
    split(s[4 * j + 1], ph[j][2], pl[j][2]);
    split(s[4 * j + 3], ph[j][3], pl[j][3]);
  }
}

// DP: d padded to the 32-float swizzle blocks (32, 64 or 128); BN: keys a
// K/V tile (64, or 32 at DP 128); STAGES: K/V stages (2, or 1 at DP 128)
template <int DP, int BN, int STAGES>
__global__ void __launch_bounds__(kThreadsFA, 1)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int64_t bh_count, int64_t S, int d, float scale_log2,
                  int causal) {
  using L = Layout<DP, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQh = base + L::kQh, sQl = base + L::kQl;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int64_t nqt = (S + kBM - 1) / kBM;
  const int64_t bh = blockIdx.x % bh_count;
  const int64_t order = blockIdx.x / bh_count;
  const int64_t qi = causal ? nqt - 1 - order : order;
  const int64_t q0 = qi * kBM;
  const int64_t off = bh * S * d;
  const float* qg = q + off;
  const float* kg = k + off;
  const float* vg = v + off;
  // causal: the tiles up to the one holding the block's last row
  const int64_t nkt_all = (S + BN - 1) / BN;
  const int64_t last = (q0 + kBM + BN - 1) / BN;
  const int64_t nkt = causal && last < nkt_all ? last : nkt_all;
  // tiles that need the mask: those reaching the diagonal or past S
  auto edge = [&](int64_t t) {
    return (causal && (t + 1) * BN > q0) || (t + 1) * BN > S;
  };

  // Q, split once
  constexpr int kChunks = DP / 4;
#pragma unroll
  for (int i = 0; i < kBM * kChunks / kThreadsFA; ++i) {
    const int e = tid + i * kThreadsFA;
    const int r = e / kChunks, c = e % kChunks;
    const int64_t gr = q0 + r;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < S && c * 4 < d)
      x = __ldg(reinterpret_cast<const float4*>(qg + gr * d + 4 * c));
    uint4 hi, lo;
    split4(x, hi, lo);
    *reinterpret_cast<uint4*>(smem + L::kQh + swz<kBM>(r, c)) = hi;
    *reinterpret_cast<uint4*>(smem + L::kQl + swz<kBM>(r, c)) = lo;
  }
  // tile j sits in stage j % STAGES; the registers hold the next one
  Share<DP, BN> next(tid);
  next.load(kg, vg, 0, S, d);
  next.store(smem + L::kStage0);
  if (nkt > 1) next.load(kg, vg, BN, S, d);
  fence_async_smem();
  __syncthreads();

  const int rw = 16 * warp + (lane >> 2);
  const int64_t row = q0 + 64 * wg + rw;
  const int cq = 2 * (lane & 3);
  Rows<DP> st;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) st.o[i] = 0.0f;
  st.m[0] = st.m[1] = kMasked;
  st.l[0] = st.l[1] = 0.0f;
  float s[BN / 2] = {};
  uint32_t ph[BN / 8][4], pl[BN / 8][4];

  for (int64_t kt = 0; kt < nkt; ++kt) {
    const int cur = STAGES == 1 ? 0 : static_cast<int>(kt & 1);
    const uint32_t stage = base + L::kStage0 + cur * L::kStage;
    issue_qk<DP, BN>(s, sQh, sQl, stage, wg);
    wgmma_wait<0>();
    keep(s);
    softmax<DP, BN>(s, st, ph, pl, scale_log2, edge(kt), kt * BN, row, S,
                    causal, cq);
    issue_pv<DP, BN>(st.o, ph, pl, stage + 2 * L::kKVTile);
    const bool more = kt + 1 < nkt;
    // the other stage was last read by tile kt - 1's products, complete
    // before the barrier that ended that tile
    if (STAGES == 2 && more)
      next.store(smem + L::kStage0 + (cur ^ 1) * L::kStage);
    wgmma_wait<0>();
    keep(st.o);
    keep(ph);
    keep(pl);
    if (more) {
      if (STAGES == 1) {  // both warpgroups done with the only stage
        __syncthreads();
        next.store(smem + L::kStage0);
      }
      if (kt + 2 < nkt) next.load(kg, vg, (kt + 2) * BN, S, d);
      fence_async_smem();
      __syncthreads();
    }
  }

  // epilogue: whole-row denominators, then through this warpgroup's rows of
  // Q's hi tile (no other warpgroup reads them).  Accumulator column
  // n = 8i + cq + e is V^T's row n, which holds d column
  // 32 (i / 4) + 4 (cq + e) + i % 4.
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
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 64 * wg + rw + 8 * h;
        const int col = 32 * (i >> 2) + 4 * (cq + e) + (i & 3);
        *reinterpret_cast<float*>(smem + L::kQh + swz<kBM>(r, col >> 2) +
                                  4 * (col & 3)) =
            st.o[4 * i + 2 * h + e] / den[h];
      }
  bar_sync(3 + wg, 128);
  const int t = tid & 127;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int e = t + i * 128;
    const int r = 64 * wg + e / kChunks, c = e % kChunks;
    const int64_t gr = q0 + r;
    if (gr < S && c * 4 < d)
      *reinterpret_cast<float4*>(out + off + gr * d + 4 * c) =
          *reinterpret_cast<const float4*>(smem + L::kQh + swz<kBM>(r, c));
  }
}

template <int DP, int BN, int STAGES>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int64_t seq, int d, float scale, int causal,
           cudaStream_t stream) {
  const int bytes = Layout<DP, BN, STAGES>::kBytes + 1024;  // + alignment
  auto kernel = flash_tf32_kernel<DP, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = bh * ((seq + kBM - 1) / kBM);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreadsFA, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), bh, seq, d,
      scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_API int flash_attention_tf32_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          int64_t bh, int64_t seq,
                                          int head_dim, float scale,
                                          int causal, void* stream) {
  if (bh < 1 || seq < 1 || head_dim < 8 || head_dim > 128 ||
      head_dim % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 32)
    return launch<32, 64, 2>(q, k, v, out, bh, seq, head_dim, scale, causal,
                             s);
  if (head_dim <= 64)
    return launch<64, 64, 2>(q, k, v, out, bh, seq, head_dim, scale, causal,
                             s);
  return launch<128, 32, 1>(q, k, v, out, bh, seq, head_dim, scale, causal,
                            s);
}
