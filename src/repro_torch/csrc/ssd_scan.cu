// Mamba2 SSD chunked scan with zero initial state, in four chunk-parallel
// passes.  With cum the in-chunk cumulative sum of dA (per head) and chunks
// of Q rows:
//   1. chunk states, one block per (b, c, h): cum by a block scan, written
//      to `cum` (B, H, S); the chunk's own state
//        S_c = sum_j (x_j exp(cum_last - cum_j))^T B_j          (P x N)
//      written to `states` (B, nc, H, P, N);
//   2. state passing, one thread per (b, h, p, n), sequential over chunks:
//        prev_c = state;  state = state * exp(cum_last_c) + S_c
//      with prev_c written back in place of S_c (the order of the plain
//      version's step 3);
//   3. C B^T once per (b, c), shared by the H heads (B and C are (B, S, N)):
//      the causal 64 x 64 tiles of a (B, nc, Q, Q) scratch `cb`;
//   4. chunk scan, one block per (b, c, 128-row tile i, h), the heads of one
//      chunk next to each other in the grid so they meet `cb` in L2:
//        y_i = exp(cum_i) C_i prev_c^T + sum_{j<=i} cb_ij exp(cum_i - cum_j) x_j
//      over the causal slabs j <= i only.
//
// Replaces the TPU kernel ssd_scan_pallas / _ssd_chunk_kernel in
// src/repro/kernels/ssd_scan/ssd_scan.py.  There the chunk axis is a
// sequential grid axis and the state a VMEM scratch carried from one grid
// step to the next; on Hopper only pass 2 is sequential, over nc chunks, and
// it touches nothing but the (P, N) states.  The decomposition is the one
// the public Mamba2 SSD kernels use (chunk cumsum, chunk state, state
// passing, bmm_chunk, chunk scan).
//
// Bound on this card: operations.  The causal work is Q(Q+1) N per (b, c)
// for C B^T and Q(Q+1) P + 4QNP per (b, c, h), against a few bytes of input
// per row (chip_smoke.py:ssd_cost).  The products run on the tensor cores:
// mma.sync m16n8k8 in TF32 with float32 accumulators, each operand split
// into hi = rna(a) and lo = rna(a - hi) and each product summed as
// lo*hi + hi*lo + hi*hi ("3xTF32").  One TF32 term keeps about
// three decimal digits and breaks the float32 tolerances
// (tests/test_torch_ssd_passes.py emulates both on the CPU).
// Design:
//  - Tiles are staged in shared memory by cp.async, 16 bytes a thread, in
//    two stages: the next tile lands while the current one multiplies.
//    Inputs stay in their dtype there (float32 or bfloat16) and are
//    converted to float32 when they are split; y and every scratch buffer
//    are float32.
//  - An operand that several warps read (pass 1's two, pass 4's B) is split
//    once per block into a shared tile of (hi, lo) pairs; one that only its
//    warp reads is split in registers.  Pass 4's warps take 32 rows (two
//    m-tiles), so each B fragment read feeds two products.
//  - Row pitches put the lanes of a fragment read on distinct banks
//    (pitch(), pitch2()).
//  - L is computed from the difference cum_i - cum_j for j <= i only, never
//    as exp(cum_i) * exp(-cum_j): at mamba2-130m's decays cum falls to about
//    -1e3 within a chunk, and exp(+1e3) is inf in float32.
//  - Grids at mamba2-130m's prefill heads (B 2, H 24, Q 256) and S = 4096:
//    768, 1536, 320 and 1536 blocks for passes 1-4.
#include "lm_common.cuh"

namespace {

constexpr int kTile = 64;   // rows and columns of a C B^T tile; columns p of y
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kSlab = 32;   // rows j a pass-1 stage holds
constexpr int kStateThreads = 256;  // passes 1 and 2: eight warps
constexpr int kScanThreads = 128;  // passes 3 and 4: four warps

inline __host__ __device__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Row pitch (elements) of a shared tile that mma fragments read.  k_rows:
// the tile's rows are the product's k index (lane % 4 walks rows, lane / 4
// columns), where a float pitch of 8 (mod 16) puts the 32 lanes on 32
// banks; otherwise (lane / 4 walks rows, lane % 4 columns) a pitch of
// 4 (mod 8) does.  bfloat16 rows keep 16 bytes alignment for cp.async.
template <typename T>
inline __host__ __device__ int pitch(int cols, bool k_rows) {
  if (sizeof(T) == 2 || k_rows) return round_up(cols, 16) + 8;
  return round_up(cols, 8) + 4;
}

// Row pitch (uint2 elements) of a split tile: 4 (mod 8) puts the 16 lanes
// of each half-warp's 8-byte reads on 16 distinct bank pairs, for either
// walk above.
inline __host__ __device__ int pitch2(int cols) { return round_up(cols, 8) + 4; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- cp.async ------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [0, R) x columns [0, C) of a tile into shared memory (pitch
// ld): row r of the source at g + r * stride, valid for r < rows and
// c < cols; the rest is zero.  vec: cp.async 16 bytes at a time (g,
// stride, cols, C and ld on 16-byte boundaries), else element by element.
// Warps walk rows and lanes columns (no division): with vec, each row's
// C / kV <= 32 chunks go to the fewest lanes that hold them (8, 16 or 32),
// so a warp takes 4, 2 or 1 rows at a time.
template <typename T>
__device__ __forceinline__ void stage(T* s, int ld, const T* g,
                                      int64_t stride, int rows, int cols,
                                      int R, int C, bool vec) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int cv = C / kV;
    const int shift = cv <= 8 ? 3 : cv <= 16 ? 4 : 5;  // lanes a row: 2^shift
    const int per = 32 >> shift;                        // rows a warp
    const int c = (lane & ((1 << shift) - 1)) * kV;
    if (c >= C) return;
    for (int r = warp * per + (lane >> shift); r < R; r += warps * per) {
      T* d = s + r * ld + c;
      if (r < rows && c < cols)
        cp_async16(d, g + r * stride + c);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int r = warp; r < R; r += warps)
      for (int c = lane; c < C; c += 32)
        s[r * ld + c] = (r < rows && c < cols) ? g[r * stride + c]
                                               : repro::from_f32<T>(0.0f);
  }
}

// ---- TF32 products on the tensor cores (lm_common.cuh) ---------------
using repro::FragA;
using repro::mma_split;
using repro::split2;

// Inclusive prefix sum of g[0], g[stride], ... g[(Q-1) stride] into cum[0, Q)
// by the whole block; `tot` holds a float per warp.
template <typename T>
__device__ void block_cumsum(const T* g, int64_t stride, int Q, float* cum,
                             float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int per = (Q + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, Q), hi = min(lo + per, Q);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    run += repro::to_f32(g[i * stride]);
    cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float v = lane < warps ? tot[lane] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    __syncwarp();
    if (lane < warps) tot[lane] = v;
  }
  __syncthreads();
  const float base = (warp ? tot[warp - 1] : 0.0f) + incl - run;
  for (int i = lo; i < hi; ++i) cum[i] += base;
  __syncthreads();
}

struct Shape {
  int64_t S;
  int H, P, N, Q, nc;
};

// ---- pass 1: cum and each chunk's own state --------------------------------
struct StateLayout {
  int pp, np;          // P padded to m-tiles of 16, N to n-tiles of 8
  int ldx, ldb;        // raw slabs (input dtype)
  int ldxa, ldbb;      // split slabs (uint2)
  size_t ring, split;  // bytes of one raw slab pair, of the split pair
};

template <typename T>
inline __host__ __device__ StateLayout state_layout(int P, int N) {
  StateLayout l;
  l.pp = round_up(P, 16);
  l.np = round_up(N, 8);
  l.ldx = pitch<T>(l.pp, true);
  l.ldb = pitch<T>(l.np, true);
  l.ldxa = pitch2(l.pp);
  l.ldbb = pitch2(round_up(l.np, 64));  // a warp reads 8 whole n-tiles
  l.ring = static_cast<size_t>(kSlab) * (l.ldx + l.ldb) * sizeof(T);
  l.split = static_cast<size_t>(kSlab) * (l.ldxa + l.ldbb) * 8;
  return l;
}

template <typename T>
inline size_t state_smem(const Shape& s) {
  const StateLayout l = state_layout<T>(s.P, s.N);
  return (2 * static_cast<size_t>(round_up(s.Q, kTile)) + 32) * 4 +
         2 * l.ring + l.split;
}

// One block per (b, c, h), over the chunk's rows j in slabs of kSlab: each
// slab lands raw (cp.async, two stages), is split once into hi/lo tiles
// (A = (x w)^T, B = B), and multiplies.  8 warps: warp w takes rows p of
// m-tile w % 4 and the 8 n-tiles of half w / 4 of the N columns.
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ dA,
                   const T* __restrict__ Bm, float* __restrict__ cum_out,
                   float* __restrict__ states, Shape sh, bool vx, bool vb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = sh.H, P = sh.P, N = sh.N, Q = sh.Q, nc = sh.nc;
  const int qr = round_up(Q, kTile);
  const StateLayout l = state_layout<T>(P, N);
  float* cum = reinterpret_cast<float*>(smem);
  float* w = cum + qr;   // exp(cum_last - cum_j), 0 past Q
  float* tot = w + qr;   // 32
  unsigned char* ring = reinterpret_cast<unsigned char*>(tot + 32);
  uint2* xa = reinterpret_cast<uint2*>(ring + 2 * l.ring);  // [j][p]
  uint2* bb = xa + kSlab * l.ldxa;                           // [j][n]

  const int h = blockIdx.x % H;
  const int c = (blockIdx.x / H) % nc;
  const int b = blockIdx.x / (H * nc);
  const int64_t r0 = static_cast<int64_t>(b) * sh.S +
                     static_cast<int64_t>(c) * Q;  // first row, of B*S
  const T* xg = x + (r0 * H + h) * P;
  const int64_t xstride = static_cast<int64_t>(H) * P;
  const T* bg = Bm + r0 * N;
  const int steps = (Q + kSlab - 1) / kSlab;
  auto raw_x = [&](int s) {
    return reinterpret_cast<T*>(ring + (s & 1) * l.ring);
  };
  auto raw_b = [&](int s) { return raw_x(s) + kSlab * l.ldx; };
  auto load = [&](int s) {
    const int j0 = s * kSlab, rows = min(kSlab, Q - j0);
    stage(raw_x(s), l.ldx, xg + j0 * xstride, xstride, rows, P, kSlab, l.pp,
          vx);
    stage(raw_b(s), l.ldb, bg + static_cast<int64_t>(j0) * N, N, rows, N,
          kSlab, l.np, vb);
    cp_commit();
  };
  load(0);  // lands while the block scans dA

  block_cumsum(dA + r0 * H + h, H, Q, cum, tot);
  const float last = cum[Q - 1];
  float* cg = cum_out + (static_cast<int64_t>(b) * H + h) * sh.S +
              static_cast<int64_t>(c) * Q;
  for (int i = threadIdx.x; i < qr; i += blockDim.x) {
    w[i] = i < Q ? expf(last - cum[i]) : 0.0f;
    if (i < Q) cg[i] = cum[i];
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * 16, nt0 = (warp >> 2) * 8;
  const bool active = m0 < P && nt0 * 8 < N;
  float acc[8][4] = {};
  for (int s = 0; s < steps; ++s) {
    cp_wait<0>();
    __syncthreads();  // slab s landed; step s - 1 is done with the tiles
    if (s + 1 < steps) load(s + 1);
    const T* xr = raw_x(s);
    const T* br = raw_b(s);
    const float* ws = w + s * kSlab;
    for (int j = warp; j < kSlab; j += kStateThreads / 32) {
      const float wj = ws[j];
      for (int p = lane; p < l.pp; p += 32)
        xa[j * l.ldxa + p] = split2(repro::to_f32(xr[j * l.ldx + p]) * wj);
      for (int n = lane; n < l.np; n += 32)
        bb[j * l.ldbb + n] = split2(repro::to_f32(br[j * l.ldb + n]));
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kSlab; kk += 8) {
        FragA a;  // A[p][j] = x[j][p] w[j]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint2 v = xa[(kk + t + 4 * (r >> 1)) * l.ldxa + m0 + g +
                             8 * (r & 1)];
          a.hi[r] = v.x;
          a.lo[r] = v.y;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          // columns past N hold what the tile held before; only their own
          // outputs see it, and those are not written
          const uint2* bp = bb + (kk + t) * l.ldbb + (nt0 + nt) * 8 + g;
          mma_split(acc[nt], a, bp[0], bp[4 * l.ldbb]);
        }
      }
    }
  }

  float* out = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = (nt0 + nt) * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = m0 + g + 8 * (r >> 1), nn = n + (r & 1);
      if (active && p < P && nn < N) out[p * N + nn] = acc[nt][r];
    }
  }
}

// ---- pass 2: the state entering each chunk ---------------------------------
// One thread per state element; each batch of kAhead chunk states is loaded
// before the previous batch is written back.
__global__ void __launch_bounds__(kStateThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ cum,
                  Shape sh, int64_t total) {
  constexpr int kAhead = 8;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= total) return;
  const int64_t pn = static_cast<int64_t>(sh.P) * sh.N;
  const int64_t hpn = pn * sh.H;
  const int64_t b = e / hpn, rem = e - b * hpn;
  const int h = static_cast<int>(rem / pn);
  const float* last = cum + (b * sh.H + h) * sh.S + sh.Q - 1;
  float* s = states + b * sh.nc * hpn + rem;
  const int nc = sh.nc;
  auto fetch = [&](int c0, float (&own)[kAhead], float (&keep)[kAhead]) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      own[k] = c < nc ? s[c * hpn] : 0.0f;
      keep[k] = c < nc ? expf(last[static_cast<int64_t>(c) * sh.Q]) : 0.0f;
    }
  };
  float own[kAhead], keep[kAhead];
  fetch(0, own, keep);
  float state = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float own2[kAhead], keep2[kAhead];
    fetch(c0 + kAhead, own2, keep2);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        s[c * hpn] = state;
        // state * decay, then + own: rounded as the plain version rounds
        state = __fadd_rn(__fmul_rn(state, keep[k]), own[k]);
      }
      own[k] = own2[k];
      keep[k] = keep2[k];
    }
  }
}

// ---- pass 3: C B^T once per (b, c) ------------------------------------------
template <typename T>
inline size_t bmm_smem(int ld) {
  return 2 * static_cast<size_t>(kTile) * ld * sizeof(T);
}

// One causal 64 x 64 tile (it, jt <= it) of one chunk's C B^T; warp w takes
// its rows 16 w ... 16 w + 15 and all 64 columns.
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 2)
bmm_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
           float* __restrict__ cb, Shape sh, bool vb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = sh.N, Q = sh.Q;
  const int T_ = (Q + kTile - 1) / kTile, ntri = T_ * (T_ + 1) / 2;
  const int np = round_up(N, 8), ld = pitch<T>(np, false);
  T* cs = reinterpret_cast<T*>(smem);
  T* bs = cs + kTile * ld;
  int it = 0, jt = blockIdx.x % ntri;
  while (jt > it) jt -= ++it;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x / ntri) * Q;  // (b nc + c) Q
  const int i0 = it * kTile, j0 = jt * kTile;
  stage(cs, ld, Cm + (r0 + i0) * N, N, min(kTile, Q - i0), N, kTile, np, vb);
  stage(bs, ld, Bm + (r0 + j0) * N, N, min(kTile, Q - j0), N, kTile, np, vb);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4] = {};
  const T* ca = cs + (m0 + g) * ld + t;
#pragma unroll
  for (int k = 0; k < kMaxN; k += 8) {
    if (k >= np) break;
    FragA a;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a.set(r, repro::to_f32(ca[8 * (r & 1) * ld + k + 4 * (r >> 1)]));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const T* br = bs + (nt * 8 + g) * ld + k + t;
      mma_split(acc[nt], a, repro::to_f32(br[0]), repro::to_f32(br[4]));
    }
  }
  float* out = cb + (r0 + i0) * Q + j0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = m0 + g + 8 * (r >> 1), j = nt * 8 + 2 * t + (r & 1);
      if (i0 + i < Q && j0 + j < Q)
        out[static_cast<int64_t>(i) * Q + j] = acc[nt][r];
    }
}

// ---- pass 4: y, tile by tile -----------------------------------------------
constexpr int kRows = 128;  // rows i of a pass-4 block: 4 warps of 32
constexpr int kStep = 32;   // k (columns n of N, or rows j) of a pass-4 step

struct ScanLayout {
  int pp;              // P padded to n-tiles of 8
  int c, prev;         // raw pitches, steps 0 .. nA-1: C_i (128 x 32 of N),
                       // prev (P x 32 of N)
  int cb, x;           // raw pitches, steps nA ..: cb_ij (128 x 32), x_j
                       // (32 x P)
  int sp_prev, sp_x;   // split pitches: prev [p][n], x_j [j][p]
  size_t stage, split; // bytes of one raw stage, of the split tile
};

template <typename T>
inline __host__ __device__ ScanLayout scan_layout(int P) {
  ScanLayout l;
  l.pp = round_up(P, 8);
  l.c = pitch<T>(kStep, false);
  l.prev = pitch<float>(kStep, false);
  l.cb = pitch<float>(kStep, false);
  l.x = pitch<T>(l.pp, true);
  l.sp_prev = pitch2(kStep);
  l.sp_x = pitch2(kTile);  // the B fragments read 8 whole n-tiles of p
  const size_t a = static_cast<size_t>(kRows) * l.c * sizeof(T) +
                   static_cast<size_t>(l.pp) * l.prev * 4;
  const size_t b = static_cast<size_t>(kRows) * l.cb * 4 +
                   static_cast<size_t>(kStep) * l.x * sizeof(T);
  l.stage = round_up(static_cast<int>(a > b ? a : b), 16);
  const int sa = kTile * l.sp_prev, sb = kStep * l.sp_x;
  l.split = static_cast<size_t>(sa > sb ? sa : sb) * 8;
  return l;
}

template <typename T>
inline size_t scan_smem(const Shape& s) {
  const ScanLayout l = scan_layout<T>(s.P);
  return static_cast<size_t>(round_up(s.Q, kRows)) * 4 + 2 * l.stage +
         l.split;
}

// A block is one 128-row tile i of one chunk and head: first the carried
// state's part over N in slabs of 32 (steps 0 .. nA-1), then the causal
// slabs of 32 rows j <= i (steps nA ..), one two-stage ring of raw tiles
// for both.  The B operand of a step (prev, or x_j) is split once into a
// shared tile; the A operand (C_i, or cb_ij exp(cum_i - cum_j)) is split in
// registers by the warp that owns its rows: warp w takes rows 32 w ...
// 32 w + 31 (two m-tiles, so each B fragment feeds both) and all P columns.
template <typename T>
__global__ void __launch_bounds__(kScanThreads, 3)
chunk_scan_kernel(const T* __restrict__ x, const T* __restrict__ Cm,
                  const float* __restrict__ cum, const float* __restrict__ prev,
                  const float* __restrict__ cb, float* __restrict__ y,
                  Shape sh, bool vx, bool vc, bool vs, bool vcb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = sh.H, P = sh.P, N = sh.N, Q = sh.Q, nc = sh.nc;
  const int T_ = (Q + kRows - 1) / kRows;
  const ScanLayout l = scan_layout<T>(P);
  float* cs = reinterpret_cast<float*>(smem);  // cum of rows 0 .. i0 + 127
  unsigned char* ring = smem + static_cast<size_t>(round_up(Q, kRows)) * 4;
  uint2* sp = reinterpret_cast<uint2*>(ring + 2 * l.stage);

  const int h = blockIdx.x % H;
  int64_t rest = blockIdx.x / H;
  const int it = T_ - 1 - static_cast<int>(rest % T_);  // longest first
  rest /= T_;
  const int64_t bc = rest;  // b * nc + c
  const int b = static_cast<int>(bc / nc), c = static_cast<int>(bc % nc);
  const int64_t r0 = bc * Q;  // first row of the chunk, of B*S
  const int i0 = it * kRows;
  const int nA = (N + kStep - 1) / kStep;
  const int steps = nA + (min(Q, i0 + kRows) + kStep - 1) / kStep;
  const int64_t xstride = static_cast<int64_t>(H) * P;
  const float* pg = prev + (bc * H + h) * P * N;

  // stage s's two raw tiles: (C_i, prev) for s < nA, else (cb_ij, x_j)
  auto raw0 = [&](int s) { return ring + (s & 1) * l.stage; };
  auto raw1 = [&](int s) {
    return raw0(s) + (s < nA ? kRows * l.c * sizeof(T) : kRows * l.cb * 4);
  };
  auto load = [&](int s) {
    if (s < nA) {
      const int n0 = s * kStep, cols = min(kStep, N - n0);
      stage(reinterpret_cast<T*>(raw0(s)), l.c, Cm + (r0 + i0) * N + n0, N,
            min(kRows, Q - i0), cols, kRows, kStep, vc);
      stage(reinterpret_cast<float*>(raw1(s)), l.prev, pg + n0, N, P, cols,
            l.pp, kStep, vs);
    } else {
      const int j0 = (s - nA) * kStep, rows = min(kStep, Q - j0);
      stage(reinterpret_cast<float*>(raw0(s)), l.cb, cb + (r0 + i0) * Q + j0,
            Q, min(kRows, Q - i0), rows, kRows, kStep, vcb);
      stage(reinterpret_cast<T*>(raw1(s)), l.x, x + ((r0 + j0) * H + h) * P,
            xstride, rows, P, kStep, l.pp, vx);
    }
    cp_commit();
  };
  load(0);
  const float* cg = cum + (static_cast<int64_t>(b) * H + h) * sh.S +
                    static_cast<int64_t>(c) * Q;
  for (int i = threadIdx.x; i < i0 + kRows; i += blockDim.x)
    cs[i] = i < Q ? cg[i] : 0.0f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = warp * 32, g = lane >> 2, t = lane & 3;
  const int last = i0 + m0 + 31;         // this warp's last row
  const bool rows_valid = i0 + m0 < Q;   // any row of the warp below Q
  float acc[2][8][4] = {};
  for (int s = 0; s < steps; ++s) {
    cp_wait<0>();
    __syncthreads();  // stage s landed; step s - 1 is done with the tiles
    if (s + 1 < steps) load(s + 1);
    if (s < nA) {
      // acc += C_i prev^T over this slab of N
      const float* pr = reinterpret_cast<const float*>(raw1(s));
      for (int p = warp; p < l.pp; p += kScanThreads / 32)
        sp[p * l.sp_prev + lane] = split2(pr[p * l.prev + lane]);  // [p][n]
      __syncthreads();
      if (!rows_valid) continue;
      const T* ct = reinterpret_cast<const T*>(raw0(s)) + (m0 + g) * l.c + t;
      const int kend = min(kStep, N - s * kStep);
#pragma unroll
      for (int k = 0; k < kStep; k += 8) {
        if (k >= kend) break;
        FragA a[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[mt].set(r, repro::to_f32(ct[(16 * mt + 8 * (r & 1)) * l.c + k +
                                          4 * (r >> 1)]));
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          // rows past P hold what the tile held before; only their own
          // outputs see it, and those are not written
          const uint2* bp = sp + (nt * 8 + g) * l.sp_prev + k + t;
          const uint2 b0 = bp[0], b1 = bp[4];
          mma_split(acc[0][nt], a[0], b0, b1);
          mma_split(acc[1][nt], a[1], b0, b1);
        }
      }
    } else {
      const T* xr = reinterpret_cast<const T*>(raw1(s));
      for (int j = warp; j < kStep; j += kScanThreads / 32)
        for (int p = lane; p < l.pp; p += 32)
          sp[j * l.sp_x + p] = split2(repro::to_f32(xr[j * l.x + p]));
      if (s == nA) {
        // the carried state decays from the chunk's start to row i
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = i0 + m0 + 16 * mt + 8 * half + g;
            const float d = i < Q ? expf(cs[i]) : 0.0f;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              acc[mt][nt][2 * half] *= d;
              acc[mt][nt][2 * half + 1] *= d;
            }
          }
      }
      __syncthreads();
      // acc += (cb_ij exp(cum_i - cum_j), j <= i) x_j
      const int j0 = (s - nA) * kStep;
      if (!rows_valid || j0 > last) continue;  // above the diagonal: all 0
      const float* bt = reinterpret_cast<const float*>(raw0(s)) +
                        (m0 + g) * l.cb + t;
      const float* cj = cs + j0 + t;
      float ci[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + m0 + 16 * mt + 8 * half + g;
          ci[mt][half] = i < Q ? cs[i] : 0.0f;
        }
#pragma unroll
      for (int k = 0; k < kStep; k += 8) {
        if (j0 + k > last) break;
        FragA a[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int dk = k + 4 * (r >> 1), di = 16 * mt + 8 * (r & 1);
            const int i = i0 + m0 + di + g, j = j0 + t + dk;
            // j <= i < Q: both cums are defined and the exponent is <= 0
            a[mt].set(r, (j <= i && i < Q)
                             ? bt[di * l.cb + dk] *
                                   __expf(ci[mt][r & 1] - cj[dk])
                             : 0.0f);
          }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint2* bp = sp + (k + t) * l.sp_x + nt * 8 + g;
          const uint2 b0 = bp[0], b1 = bp[4 * l.sp_x];
          mma_split(acc[0][nt], a[0], b0, b1);
          mma_split(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + m0 + 16 * mt + 8 * half + g;
        if (i >= Q) continue;
        float* out = y + ((r0 + i) * H + h) * P + p;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (p + 1 < P && (P & 1) == 0) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          if (p < P) out[0] = v0;
          if (p + 1 < P) out[1] = v1;
        }
      }
    }
}

// ---- launches --------------------------------------------------------------
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool valid(int64_t batch, int64_t seq, int heads, int P, int N, int Q) {
  if (batch < 1 || heads < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      Q < 1 || Q > kMaxQ || seq < Q || seq % Q != 0)
    return false;
  const int64_t tiles = (Q + kTile - 1) / kTile;
  const int64_t most = tiles * heads > tiles * (tiles + 1) / 2
                           ? tiles * heads
                           : tiles * (tiles + 1) / 2;
  return batch * (seq / Q) * most < 0x7fffffff;  // the largest grid
}

Shape shape_of(int64_t seq, int heads, int P, int N, int Q) {
  return {seq, heads, P, N, Q, static_cast<int>(seq / Q)};
}

template <typename T>
int chunk_state(const void* x, const void* dA, const void* B, void* cum,
                void* states, int64_t batch, const Shape& s,
                cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const size_t bytes = state_smem<T>(s);
  auto kernel = chunk_state_kernel<T>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch * s.nc * s.H), kStateThreads, bytes,
           stream>>>(static_cast<const T*>(x), static_cast<const T*>(dA),
                     static_cast<const T*>(B), static_cast<float*>(cum),
                     static_cast<float*>(states), s,
                     aligned16(x) && s.P % kV == 0,
                     aligned16(B) && s.N % kV == 0);
  return static_cast<int>(cudaGetLastError());
}

int state_pass(void* cum, void* states, int64_t batch, const Shape& s,
               cudaStream_t stream) {
  const int64_t total = batch * s.H * static_cast<int64_t>(s.P) * s.N;
  const int64_t blocks = (total + kStateThreads - 1) / kStateThreads;
  state_pass_kernel<<<static_cast<unsigned>(blocks), kStateThreads, 0,
                      stream>>>(static_cast<float*>(states),
                                static_cast<const float*>(cum), s, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bmm(const void* B, const void* C, void* cb, int64_t batch, const Shape& s,
        cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int tiles = (s.Q + kTile - 1) / kTile;
  const size_t bytes = bmm_smem<T>(pitch<T>(round_up(s.N, 8), false));
  auto kernel = bmm_kernel<T>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch * s.nc * tiles * (tiles + 1) / 2),
           kScanThreads, bytes, stream>>>(
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(cb), s,
      aligned16(B) && aligned16(C) && s.N % kV == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chunk_scan(const void* x, const void* C, const void* cum,
               const void* states, const void* cb, void* y, int64_t batch,
               const Shape& s, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int tiles = (s.Q + kRows - 1) / kRows;
  const size_t bytes = scan_smem<T>(s);
  auto kernel = chunk_scan_kernel<T>;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch * s.nc * tiles * s.H), kScanThreads,
           bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(C),
      static_cast<const float*>(cum), static_cast<const float*>(states),
      static_cast<const float*>(cb), static_cast<float*>(y), s,
      aligned16(x) && s.P % kV == 0, aligned16(C) && s.N % kV == 0,
      aligned16(states) && s.N % 4 == 0, aligned16(cb) && s.Q % 4 == 0);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// One entry per pass; the wrapper launches them in this order, and tests
// and chip_smoke.py check and time them one by one.  Scratch (float32, from the caller): cum
// (B, H, S), states (B, nc, H, P, N), cb (B, nc, Q, Q).
REPRO_API int ssd_chunk_state_launch(const void* x, const void* dA,
                                     const void* B, void* cum, void* states,
                                     int64_t batch, int64_t seq, int heads,
                                     int head_dim, int d_state, int chunk,
                                     int dtype, void* stream) {
  if (!valid(batch, seq, heads, head_dim, d_state, chunk)) return kInvalid;
  const Shape s = shape_of(seq, heads, head_dim, d_state, chunk);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return chunk_state<float>(x, dA, B, cum, states, batch, s, st);
    case repro::kBF16:
      return chunk_state<__nv_bfloat16>(x, dA, B, cum, states, batch, s, st);
    default:
      return kInvalid;
  }
}

REPRO_API int ssd_state_pass_launch(void* cum, void* states, int64_t batch,
                                    int64_t seq, int heads, int head_dim,
                                    int d_state, int chunk, void* stream) {
  if (!valid(batch, seq, heads, head_dim, d_state, chunk)) return kInvalid;
  return state_pass(cum, states, batch,
                    shape_of(seq, heads, head_dim, d_state, chunk),
                    static_cast<cudaStream_t>(stream));
}

REPRO_API int ssd_bmm_launch(const void* B, const void* C, void* cb,
                             int64_t batch, int64_t seq, int d_state,
                             int chunk, int dtype, void* stream) {
  if (!valid(batch, seq, 1, 1, d_state, chunk)) return kInvalid;
  const Shape s = shape_of(seq, 1, 1, d_state, chunk);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return bmm<float>(B, C, cb, batch, s, st);
    case repro::kBF16:
      return bmm<__nv_bfloat16>(B, C, cb, batch, s, st);
    default:
      return kInvalid;
  }
}

REPRO_API int ssd_chunk_scan_launch(const void* x, const void* C,
                                    const void* cum, const void* states,
                                    const void* cb, void* y, int64_t batch,
                                    int64_t seq, int heads, int head_dim,
                                    int d_state, int chunk, int dtype,
                                    void* stream) {
  if (!valid(batch, seq, heads, head_dim, d_state, chunk)) return kInvalid;
  const Shape s = shape_of(seq, heads, head_dim, d_state, chunk);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return chunk_scan<float>(x, C, cum, states, cb, y, batch, s, st);
    case repro::kBF16:
      return chunk_scan<__nv_bfloat16>(x, C, cum, states, cb, y, batch, s,
                                       st);
    default:
      return kInvalid;
  }
}
