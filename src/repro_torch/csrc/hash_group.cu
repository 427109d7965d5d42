// Grouped aggregation over int32 group codes (-1 = masked row):
//   hash_group:        per-group SUM and COUNT, two (G,) float32 outputs;
//   hash_group_minmax: per-group MIN and MAX, two (G,) float32 outputs, an
//                      empty group holding +inf / -inf.
//
// Replaces the TPU kernels hash_group_pallas / _group_kernel and
// hash_group_minmax_pallas / _minmax_kernel in
// src/repro/kernels/hash_group/hash_group.py.  The TPU has no scatter, so it
// multiplies a one-hot matrix on the MXU, row block after row block in
// order, and its sums repeat bit for bit.  Rows with a code < 0 or >= G are
// dropped, as the TPU kernel's padded one-hot drops them.
//
// Bound on this card: bytes (8 read per row, 8 written per group).
//
// hash_group is one launch on every path; the wrapper picks the path
// (kernels/hash_group/ops.py: group_path, with the measurement that set
// its row limits) and passes it here.  No path zeroes its outputs in a launch
// of its own.
//   morsel (n <= 8,192 rows for G <= 32, n <= 2,048 for G up to
//     kWarpCopyGroups; the SQL path's 1,024-row morsels): one block of
//     kGroupThreads threads writes the outputs itself, with no atomics:
//       registers (G <= 32): thread t sums rows t, t + T, ... of each group
//         in registers (a row outside a group adds 0); each warp folds its
//         lanes with a __shfl_xor_sync butterfly (16, 8, 4, 2, 1); thread j
//         then adds the warps' partials of group j in warp order, from 0;
//       warp copies (G <= kWarpCopyGroups): each warp keeps a private copy
//         of the G sums and counts in shared memory and takes the 32-row
//         chunks k with k % W == its index, in order; per chunk the lowest
//         lane of each code (__match_any_sync) adds its peers' values in
//         lane order, from 0, and adds that to the warp's copy; the copies
//         are then added in warp order, from 0.
//     Both repeat bit for bit; kernels/hash_group/order.py adds in these
//     orders on the CPU (tests/test_torch_group_order.py holds it to the
//     TPU kernel, the card tests hold this kernel to it);
//   grid (more rows, or more groups, up to kSmemGroups): one cooperative
//     launch of as many blocks as are resident, at most kGridBlocksPerSm a
//     SM (four were no faster at 3,000 or 8,000 groups and slower at 7);
//     each thread reads four codes and four values a load (16 bytes each);
//     G <= 32 sums in registers as above (repeats bit for bit for a given
//     grid), larger G in a shared-memory copy per block (227 KB opt-in)
//     with shared atomics (does not: a float atomicAdd on shared memory is
//     a compare-and-swap loop on this card, ATOMS.CAST.SPIN in the SASS,
//     which chip_smoke.py prints); each block writes its partials to a row
//     of the caller's scratch, the grid synchronises, and the blocks fold
//     the rows in order into the outputs: no global atomics.  The scratch
//     ([blocks][G] sums, then counts) is the caller's: the wrapper's
//     allocation, or the trip's staging buffer;
//   global (G > kSmemGroups): one cooperative launch that zeroes the
//     outputs in its prologue, synchronises the grid, then adds every row
//     with global atomics (no fixed order).
//
// Numbers: counts are exact (integer counters; float32 holds every integer
// below 2^24, which the executor's gate keeps the row count under).  Sums
// of integers whose partial sums stay below 2^24 are exact in any order;
// sums of arbitrary floats on a path without a fixed order agree with a
// sequential sum only to rounding.  MIN/MAX run on an order-preserving
// uint32 key of the float (sign bit clear: bits ^ 0x80000000; set: ~bits),
// so they are exact.  NaN is outside the contract (the gate rejects it).
//
// hash_group_minmax has two paths; the wrapper picks one by the row count
// (kernels/hash_group/ops.py: ONE_BLOCK_ROWS, with the measurement that
// set it) and passes it here:
//   one block (n <= ONE_BLOCK_ROWS and G <= 6,144, the SQL path's 1,024-row
//     morsels): a single launch of one 1,024-thread block takes the order
//     keys of all G groups in shared memory, scatters every row with
//     shared-memory atomicMin/atomicMax, and writes the decoded floats
//     straight to the outputs: no initialising or decoding launch, no
//     global atomics, nothing carried from one call to the next;
//   many blocks: three launches (initialise the order keys in the outputs,
//     the privatized scatter over up to 528 blocks folded in with global
//     atomics, decode), or global atomics per row when G > 6,144.
#include <cooperative_groups.h>

#include <algorithm>
#include <iterator>

#include "common.cuh"

namespace {

constexpr int64_t kSmemMaxGroups = (48 * 1024) / (2 * sizeof(float));

__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b ^ 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

constexpr uint32_t kKeyPosInf = 0xFF800000u;  // order_key(+inf)
constexpr uint32_t kKeyNegInf = 0x007FFFFFu;  // order_key(-inf)

// mins/maxs hold order keys while the kernels run and floats afterwards
__global__ void minmax_init(uint32_t* mins, uint32_t* maxs, int32_t g) {
  for (int32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < g;
       j += gridDim.x * blockDim.x) {
    mins[j] = kKeyPosInf;
    maxs[j] = kKeyNegInf;
  }
}

__global__ void minmax_smem(const int32_t* __restrict__ codes,
                            const float* __restrict__ vals, int64_t n,
                            int32_t g, uint32_t* mins, uint32_t* maxs) {
  extern __shared__ uint32_t keys[];  // [g mins | g maxs]
  for (int32_t j = threadIdx.x; j < g; j += blockDim.x) {
    keys[j] = kKeyPosInf;
    keys[g + j] = kKeyNegInf;
  }
  __syncthreads();
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t c = codes[i];
    if (c >= 0 && c < g) {
      uint32_t k = order_key(vals[i]);
      atomicMin(&keys[c], k);
      atomicMax(&keys[g + c], k);
    }
  }
  __syncthreads();
  for (int32_t j = threadIdx.x; j < g; j += blockDim.x) {
    if (keys[j] != kKeyPosInf) atomicMin(&mins[j], keys[j]);
    if (keys[g + j] != kKeyNegInf) atomicMax(&maxs[j], keys[g + j]);
  }
}

constexpr int kOneBlockThreads = 1024;

__global__ void __launch_bounds__(kOneBlockThreads)
minmax_one_block(const int32_t* __restrict__ codes,
                 const float* __restrict__ vals, int64_t n, int32_t g,
                 float* __restrict__ mins, float* __restrict__ maxs) {
  extern __shared__ uint32_t keys[];  // [g mins | g maxs]
  for (int32_t j = threadIdx.x; j < g; j += blockDim.x) {
    keys[j] = kKeyPosInf;
    keys[g + j] = kKeyNegInf;
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    int32_t c = codes[i];
    if (c >= 0 && c < g) {
      uint32_t k = order_key(vals[i]);
      atomicMin(&keys[c], k);
      atomicMax(&keys[g + c], k);
    }
  }
  __syncthreads();
  for (int32_t j = threadIdx.x; j < g; j += blockDim.x) {
    mins[j] = from_order_key(keys[j]);
    maxs[j] = from_order_key(keys[g + j]);
  }
}

__global__ void minmax_global(const int32_t* __restrict__ codes,
                              const float* __restrict__ vals, int64_t n,
                              int32_t g, uint32_t* mins, uint32_t* maxs) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t c = codes[i];
    if (c >= 0 && c < g) {
      uint32_t k = order_key(vals[i]);
      atomicMin(&mins[c], k);
      atomicMax(&maxs[c], k);
    }
  }
}

__global__ void minmax_decode(uint32_t* mins, uint32_t* maxs, int32_t g) {
  for (int32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < g;
       j += gridDim.x * blockDim.x) {
    reinterpret_cast<float*>(mins)[j] = from_order_key(mins[j]);
    reinterpret_cast<float*>(maxs)[j] = from_order_key(maxs[j]);
  }
}

// ---- hash_group (SUM/COUNT) ------------------------------------------------
namespace cg = cooperative_groups;

// The limits below are repeated in kernels/hash_group/ops.py, which reads
// them back through hash_group_limits (the card tests and chip_smoke.py
// hold its copies to them).
constexpr int kSmemOptIn = 232448;  // 227 KB: a block's shared memory, opted in
constexpr unsigned kAll = 0xffffffffu;
constexpr int kGroupThreads = 512;  // a block of the morsel and grid paths
constexpr int kWarps = kGroupThreads / 32;
constexpr int kRegisterGroups = 32;  // G up to which the sums stay in registers
// the morsel path's staged values: 32 a warp
constexpr int kStageBytes = kWarps * 32 * sizeof(float);
// G up to which the morsel path keeps a copy per warp, and up to which the
// grid path keeps its groups in shared memory (a sum and a count, 8 bytes
// each)
constexpr int kWarpCopyGroups = (kSmemOptIn - kStageBytes) / (kWarps * 8);
constexpr int kSmemGroups = (kSmemOptIn - kStageBytes) / 8;
constexpr int kGridBlocksPerSm = 2;
// the wrapper's path codes (kernels/hash_group/ops.py: GROUP_PATHS)
enum GroupPath { kMorsel = 0, kGrid = 1, kGlobal = 2 };

__device__ __forceinline__ int32_t valid_code(int32_t c, int32_t g) {
  return (c >= 0 && c < g) ? c : -1;
}

// One thread's running sums and counts of groups 0 .. GMAX-1 in registers
// (GMAX 8 or 32: on the H100 one kernel for G <= 32 with the loop bounded
// by G at run time took 0.0037 ms at G 7 against GMAX 8's 0.0021, PERF.md
// run F); a row
// outside group j adds 0 to it (and 0.0f + x == x for every sum these
// hold: a sum that starts at +0.0 never becomes -0.0).
template <int GMAX>
__device__ __forceinline__ void add_row(float (&sum)[GMAX],
                                        uint32_t (&cnt)[GMAX], int32_t c,
                                        float v) {
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    const bool hit = c == j;
    sum[j] += hit ? v : 0.0f;
    cnt[j] += hit ? 1u : 0u;
  }
}

// Each warp folds its lanes' sums of group j by a butterfly (xor 16, 8, 4,
// 2, 1: every lane ends with the same bits) and lane j writes them to
// `sums[j]` (lanes >= GMAX write 0).
template <int GMAX>
__device__ __forceinline__ void warp_row(const float (&sum)[GMAX],
                                         const uint32_t (&cnt)[GMAX],
                                         float* sums, uint32_t* counts) {
  const int lane = threadIdx.x & 31;
  float my_sum = 0.0f;
  uint32_t my_cnt = 0;
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    float s = sum[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
    const uint32_t k = __reduce_add_sync(kAll, cnt[j]);
    if (lane == j) {
      my_sum = s;
      my_cnt = k;
    }
  }
  sums[lane] = my_sum;
  counts[lane] = my_cnt;
}

// The block's G <= GMAX sums from registers: each warp's row of partials
// to `wsum`/`wcnt`, then thread j adds the rows of group j in warp order,
// from 0, and hands them to `write(j, sum, count)`.
template <int GMAX, typename Write>
__device__ __forceinline__ void fold_warps(const float (&sum)[GMAX],
                                           const uint32_t (&cnt)[GMAX],
                                           int32_t g, float* wsum,
                                           uint32_t* wcnt, Write write) {
  const int row = threadIdx.x & ~31;
  warp_row<GMAX>(sum, cnt, wsum + row, wcnt + row);
  __syncthreads();
  if (threadIdx.x < g) {
    float s = 0.0f;
    uint32_t k = 0;
    for (int w = 0; w < kWarps; ++w) {
      s += wsum[32 * w + threadIdx.x];
      k += wcnt[32 * w + threadIdx.x];
    }
    write(threadIdx.x, s, k);
  }
}

// morsel path, G <= GMAX: one block; sums in registers, warp partials
// added in warp order by thread j
template <int GMAX>
__global__ void __launch_bounds__(kGroupThreads)
group_morsel_registers(const int32_t* __restrict__ codes,
                       const float* __restrict__ vals, int64_t n, int32_t g,
                       float* __restrict__ sums, float* __restrict__ counts) {
  __shared__ float wsum[kWarps * 32];
  __shared__ uint32_t wcnt[kWarps * 32];
  float sum[GMAX];
  uint32_t cnt[GMAX];
#pragma unroll
  for (int j = 0; j < GMAX; ++j) {
    sum[j] = 0.0f;
    cnt[j] = 0;
  }
  for (int64_t i = threadIdx.x; i < n; i += kGroupThreads)
    add_row<GMAX>(sum, cnt, valid_code(__ldg(codes + i), g), __ldg(vals + i));
  fold_warps<GMAX>(sum, cnt, g, wsum, wcnt, [&](int j, float s, uint32_t k) {
    sums[j] = s;
    counts[j] = static_cast<float>(k);
  });
}

// morsel path, 32 < G <= kWarpCopyGroups: one block; a copy of the G sums
// and counts in shared memory per warp.  Warp w takes the 32-row chunks w,
// w + kWarps, ...; per chunk the lowest lane of each code adds its peers'
// values in lane order, from 0, to the warp's copy; the copies are then
// added in warp order, from 0.
__global__ void __launch_bounds__(kGroupThreads)
group_morsel_copies(const int32_t* __restrict__ codes,
                    const float* __restrict__ vals, int64_t n, int32_t g,
                    float* __restrict__ sums, float* __restrict__ counts) {
  extern __shared__ float smem[];  // [kWarps][g] sums | counts | staging
  float* csum = smem;
  uint32_t* ccnt = reinterpret_cast<uint32_t*>(smem + kWarps * g);
  for (int32_t j = threadIdx.x; j < 2 * kWarps * g; j += kGroupThreads)
    smem[j] = 0.0f;
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* my_sum = csum + w * g;
  uint32_t* my_cnt = ccnt + w * g;
  float* stage = smem + 2 * kWarps * g + 32 * w;
  for (int64_t base = 32 * w; base < n; base += 32 * kWarps) {
    const int64_t i = base + lane;
    int32_t c = -1;
    float v = 0.0f;
    if (i < n) {
      c = valid_code(__ldg(codes + i), g);
      v = __ldg(vals + i);
    }
    const uint32_t peers = __match_any_sync(kAll, c);
    stage[lane] = v;
    __syncwarp();
    if (c >= 0 && lane == __ffs(peers) - 1) {
      float s = 0.0f;
      for (uint32_t m = peers; m; m &= m - 1) s += stage[__ffs(m) - 1];
      my_sum[c] += s;
      my_cnt[c] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  for (int32_t j = threadIdx.x; j < g; j += kGroupThreads) {
    float s = 0.0f;
    uint32_t k = 0;
    for (int q = 0; q < kWarps; ++q) {
      s += csum[q * g + j];
      k += ccnt[q * g + j];
    }
    sums[j] = s;
    counts[j] = static_cast<float>(k);
  }
}

// A thread's rows on the grid and global paths: pairs of quads (four codes
// and four values, 16 bytes each a load) to `quad` while both arrays are
// 16-byte aligned (`vec`), then the rest one by one to `row`.
template <typename Row>
__device__ __forceinline__ void grid_rows(const int32_t* codes,
                                          const float* vals, int64_t n,
                                          int vec, Row row) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t quads = vec ? n / 4 : 0;
  const int4* c4 = reinterpret_cast<const int4*>(codes);
  const float4* v4 = reinterpret_cast<const float4*>(vals);
  auto quad = [&](int4 c, float4 v) {
    row(c.x, v.x);
    row(c.y, v.y);
    row(c.z, v.z);
    row(c.w, v.w);
  };
  for (int64_t q = t; q < quads; q += 2 * stride) {
    const int4 ca = __ldg(c4 + q);
    const float4 va = __ldg(v4 + q);
    int4 cb = make_int4(-1, -1, -1, -1);
    float4 vb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q + stride < quads) {
      cb = __ldg(c4 + q + stride);
      vb = __ldg(v4 + q + stride);
    }
    quad(ca, va);
    quad(cb, vb);
  }
  for (int64_t i = 4 * quads + t; i < n; i += stride)
    row(__ldg(codes + i), __ldg(vals + i));
}

// The grid's fold of its blocks' rows of partials into the outputs.  A warp
// takes 32 groups and one of `slices` runs of rows (as few runs as keep
// each at most 16 rows, up to one a warp): lane j adds its run of group j
// in row order, from 0; then the first warp of the 32 groups adds the runs
// in order, from 0.  A block takes 32 kWarps / slices groups at a time.
__device__ __forceinline__ void fold_blocks(const float* part_sum,
                                            const uint32_t* part_cnt,
                                            int32_t g, int rows, float* sums,
                                            float* counts, float* wsum,
                                            uint32_t* wcnt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int slices = 1;
  while (slices < kWarps && slices * 16 < rows) slices *= 2;
  const int per = (rows + slices - 1) / slices;
  const int slice = w % slices;
  const int b0 = slice * per, b1 = min(rows, b0 + per);
  const int tile_groups = 32 * (kWarps / slices);
  for (int64_t tile = blockIdx.x; tile * tile_groups < g; tile += gridDim.x) {
    const int64_t j = tile * tile_groups + 32 * (w / slices) + lane;
    float s = 0.0f;
    uint32_t k = 0;
    if (j < g) {
#pragma unroll 8
      for (int b = b0; b < b1; ++b) {
        s += __ldcg(part_sum + static_cast<int64_t>(b) * g + j);
        k += __ldcg(part_cnt + static_cast<int64_t>(b) * g + j);
      }
    }
    __syncthreads();
    wsum[32 * w + lane] = s;
    wcnt[32 * w + lane] = k;
    __syncthreads();
    if (slice == 0 && j < g) {
      float t = 0.0f;
      uint32_t c = 0;
      for (int q = 0; q < slices; ++q) {
        t += wsum[32 * (w + q) + lane];
        c += wcnt[32 * (w + q) + lane];
      }
      sums[j] = t;
      counts[j] = static_cast<float>(c);
    }
  }
}

// grid path: G <= GMAX (8 or 32) sums in registers, or with GMAX 0 a
// shared-memory copy of the G groups per block; block b writes its
// partials to row b of `scratch` ([gridDim.x][g] sums, then [gridDim.x][g]
// counts), the grid synchronises, the blocks fold the rows in order.
template <int GMAX>
__global__ void __launch_bounds__(kGroupThreads)
group_grid(const int32_t* __restrict__ codes, const float* __restrict__ vals,
           int64_t n, int32_t g, float* __restrict__ sums,
           float* __restrict__ counts, float* __restrict__ scratch, int vec) {
  // [kWarps][32] sums | counts; the shared copy lies over them before the
  // grid's synchronisation
  extern __shared__ float smem[];
  float* wsum = smem;
  uint32_t* wcnt = reinterpret_cast<uint32_t*>(smem + kWarps * 32);
  float* part_sum = scratch;
  uint32_t* part_cnt = reinterpret_cast<uint32_t*>(
      scratch + static_cast<int64_t>(gridDim.x) * g);
  const int64_t mine = static_cast<int64_t>(blockIdx.x) * g;
  if constexpr (GMAX > 0) {
    float sum[GMAX];
    uint32_t cnt[GMAX];
#pragma unroll
    for (int j = 0; j < GMAX; ++j) {
      sum[j] = 0.0f;
      cnt[j] = 0;
    }
    grid_rows(codes, vals, n, vec, [&](int32_t c, float v) {
      add_row<GMAX>(sum, cnt, valid_code(c, g), v);
    });
    fold_warps<GMAX>(sum, cnt, g, wsum, wcnt, [&](int j, float s, uint32_t k) {
      part_sum[mine + j] = s;
      part_cnt[mine + j] = k;
    });
  } else {
    float* csum = smem;
    uint32_t* ccnt = reinterpret_cast<uint32_t*>(smem + g);
    for (int32_t j = threadIdx.x; j < 2 * g; j += kGroupThreads)
      smem[j] = 0.0f;
    __syncthreads();
    grid_rows(codes, vals, n, vec, [&](int32_t c, float v) {
      c = valid_code(c, g);
      if (c >= 0) {
        atomicAdd(csum + c, v);
        atomicAdd(ccnt + c, 1u);
      }
    });
    __syncthreads();
    for (int32_t j = threadIdx.x; j < g; j += kGroupThreads) {
      part_sum[mine + j] = csum[j];
      part_cnt[mine + j] = ccnt[j];
    }
  }
  cg::this_grid().sync();
  fold_blocks(part_sum, part_cnt, g, gridDim.x, sums, counts, wsum, wcnt);
}

// global path (G > kSmemGroups): the outputs zeroed, the grid synchronised,
// every row added with global atomics.  `scratch` is unused; the
// parameters are group_grid's, so both launch alike.
__global__ void __launch_bounds__(kGroupThreads)
group_global(const int32_t* __restrict__ codes, const float* __restrict__ vals,
             int64_t n, int32_t g, float* __restrict__ sums,
             float* __restrict__ counts, float* __restrict__ scratch,
             int vec) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = t; j < g; j += stride) {
    sums[j] = 0.0f;
    counts[j] = 0.0f;
  }
  cg::this_grid().sync();
  grid_rows(codes, vals, n, vec, [&](int32_t c, float v) {
    c = valid_code(c, g);
    if (c >= 0) {
      atomicAdd(sums + c, v);
      atomicAdd(counts + c, 1.0f);
    }
  });
}

using GridKernel = void (*)(const int32_t*, const float*, int64_t, int32_t,
                            float*, float*, float*, int);

// The shared-memory opt-in above 48 KB, set once for the kernels that use it.
cudaError_t allow_large_smem() {
  static const cudaError_t err = [] {
    const void* kernels[] = {
        reinterpret_cast<const void*>(&group_morsel_copies),
        reinterpret_cast<const void*>(&group_grid<0>)};
    for (const void* k : kernels) {
      cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return err;
}

// One cooperative launch of `kernel`: as many blocks as are resident, at
// most kGridBlocksPerSm a SM and `max_blocks`, and no more than four rows a
// thread needs.
cudaError_t launch_grid(GridKernel kernel, int64_t n, int64_t max_blocks,
                        size_t smem, cudaStream_t s, void** args) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kGroupThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_need = (n + 4 * kGroupThreads - 1) / (4 * kGroupThreads);
  const int64_t blocks = std::min<int64_t>(
      {static_cast<int64_t>(std::min(per_sm, kGridBlocksPerSm)) *
           repro::sm_count(),
       max_blocks, std::max<int64_t>(1, rows_need)});
  if (blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(static_cast<unsigned>(blocks)),
                                     dim3(kGroupThreads), args, smem, s);
}

}  // namespace

REPRO_API int hash_group_launch(const void* codes, const void* vals, int64_t n,
                                int64_t g, void* sums, void* counts, int path,
                                void* scratch, int64_t scratch_blocks,
                                void* stream) {
  if (g < 1 || g > INT32_MAX || n < 0 || path < kMorsel || path > kGlobal ||
      (path == kMorsel && g > kWarpCopyGroups) ||
      (path == kGrid && (g > kSmemGroups || scratch == nullptr ||
                         scratch_blocks < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_large_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int32_t*>(codes);
  auto v = static_cast<const float*>(vals);
  auto so = static_cast<float*>(sums);
  auto co = static_cast<float*>(counts);
  int32_t g32 = static_cast<int32_t>(g);
  if (path == kMorsel) {
    if (g <= 8)
      group_morsel_registers<8><<<1, kGroupThreads, 0, s>>>(c, v, n, g32, so,
                                                            co);
    else if (g <= kRegisterGroups)
      group_morsel_registers<kRegisterGroups>
          <<<1, kGroupThreads, 0, s>>>(c, v, n, g32, so, co);
    else
      group_morsel_copies<<<1, kGroupThreads, 8 * kWarps * g + kStageBytes,
                            s>>>(c, v, n, g32, so, co);
    return static_cast<int>(cudaGetLastError());
  }
  auto sc = static_cast<float*>(scratch);
  int vec = repro::aligned16(codes) && repro::aligned16(vals);
  void* args[] = {&c, &v, &n, &g32, &so, &co, &sc, &vec};
  const size_t partials = 8 * kWarps * 32;
  if (path == kGlobal)
    err = launch_grid(group_global, n, INT32_MAX, 0, s, args);
  else if (g <= 8)
    err = launch_grid(group_grid<8>, n, scratch_blocks, partials, s, args);
  else if (g <= kRegisterGroups)
    err = launch_grid(group_grid<kRegisterGroups>, n, scratch_blocks,
                      partials, s, args);
  else
    err = launch_grid(group_grid<0>, n, scratch_blocks,
                      std::max<size_t>(8 * g, partials), s, args);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The limits above, in the order of kernels/hash_group/ops.py: limits().
REPRO_API int hash_group_limits(int64_t* out) {
  const int64_t limits[] = {kMorsel,         kGrid,           kGlobal,
                            kGroupThreads,   kRegisterGroups, kWarpCopyGroups,
                            kSmemGroups,     kSmemOptIn,      kGridBlocksPerSm};
  std::copy(std::begin(limits), std::end(limits), out);
  return static_cast<int>(cudaSuccess);
}

REPRO_API int hash_group_minmax_launch(const void* codes, const void* vals,
                                       int64_t n, int64_t g, void* mins,
                                       void* maxs, int one_block,
                                       void* stream) {
  if (g < 1 || g > INT32_MAX || (one_block && g > kSmemMaxGroups))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int32_t*>(codes);
  auto v = static_cast<const float*>(vals);
  int32_t g32 = static_cast<int32_t>(g);
  if (one_block) {
    minmax_one_block<<<1, kOneBlockThreads, 2 * g * sizeof(uint32_t), s>>>(
        c, v, n, g32, static_cast<float*>(mins), static_cast<float*>(maxs));
    return static_cast<int>(cudaGetLastError());
  }
  auto mi = static_cast<uint32_t*>(mins);
  auto ma = static_cast<uint32_t*>(maxs);
  int fill_blocks = repro::grid_for(g, 1, repro::kSms);
  minmax_init<<<fill_blocks, repro::kThreads, 0, s>>>(mi, ma, g32);
  if (g <= kSmemMaxGroups) {
    int per_thread = g > 1024 ? 16 : 4;
    int blocks = repro::grid_for(n, per_thread, repro::kSms * 4);
    minmax_smem<<<blocks, repro::kThreads, 2 * g * sizeof(uint32_t), s>>>(
        c, v, n, g32, mi, ma);
  } else {
    int blocks = repro::grid_for(n, 4, repro::kSms * 16);
    minmax_global<<<blocks, repro::kThreads, 0, s>>>(c, v, n, g32, mi, ma);
  }
  minmax_decode<<<fill_blocks, repro::kThreads, 0, s>>>(mi, ma, g32);
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int hash_group_trip(REPRO_TRIP_PARAMS, const void* codes,
                               const void* vals, int64_t n, int64_t g,
                               void* sums, void* counts, int path,
                               void* scratch, int64_t scratch_blocks,
                               void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return hash_group_launch(codes, vals, n, g, sums, counts, path, scratch,
                             scratch_blocks, stream);
  });
}

REPRO_API int hash_group_minmax_trip(REPRO_TRIP_PARAMS, const void* codes,
                                      const void* vals, int64_t n, int64_t g,
                                      void* mins, void* maxs, int one_block,
                                      void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return hash_group_minmax_launch(codes, vals, n, g, mins, maxs, one_block,
                                    stream);
  });
}
