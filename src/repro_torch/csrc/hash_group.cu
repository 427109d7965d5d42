// Grouped aggregation over int32 group codes (-1 = masked row):
//   hash_group:        per-group SUM and COUNT, two (G,) float32 outputs;
//   hash_group_minmax: per-group MIN and MAX, two (G,) float32 outputs, an
//                      empty group holding +inf / -inf.
//
// Replaces the TPU kernels hash_group_pallas / _group_kernel and
// hash_group_minmax_pallas / _minmax_kernel in
// src/repro/kernels/hash_group/hash_group.py.  The TPU has no scatter, so it
// multiplies a one-hot matrix on the MXU; Hopper has atomics in shared
// memory, so this is a privatized scatter instead: each block accumulates a
// private copy of the G groups in shared memory, then folds its non-empty
// groups into the outputs with one global atomic each.  When the private
// copy does not fit (2*G*4 bytes > 48 KB) the rows go to global atomics.
//
// Bound on this card: bytes (8 read per row, 8 written per group).  The
// privatized copy keeps the per-row atomics out of device memory.
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
//
// Numbers: counts are exact (float32 holds every integer below 2^24, which
// the executor's gate keeps the row count under).  Float atomics add in an
// order that changes from run to run, so sums of arbitrary floats agree with
// a sequential sum only to rounding; sums of integers whose partial sums stay
// below 2^24 are exact in any order.  MIN/MAX run on an order-preserving
// uint32 key of the float (sign bit clear: bits ^ 0x80000000; set: ~bits),
// so they are exact.  NaN is outside the contract (the gate rejects it).
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

__global__ void group_sum_smem(const int32_t* __restrict__ codes,
                               const float* __restrict__ vals, int64_t n,
                               int32_t g, float* sums, float* counts) {
  extern __shared__ float priv[];  // [g sums | g counts]
  for (int32_t j = threadIdx.x; j < 2 * g; j += blockDim.x) priv[j] = 0.0f;
  __syncthreads();
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t c = codes[i];
    if (c >= 0 && c < g) {
      atomicAdd(&priv[c], vals[i]);
      atomicAdd(&priv[g + c], 1.0f);
    }
  }
  __syncthreads();
  for (int32_t j = threadIdx.x; j < g; j += blockDim.x) {
    float cnt = priv[g + j];
    if (cnt != 0.0f) {
      atomicAdd(&sums[j], priv[j]);
      atomicAdd(&counts[j], cnt);
    }
  }
}

__global__ void group_sum_global(const int32_t* __restrict__ codes,
                                 const float* __restrict__ vals, int64_t n,
                                 int32_t g, float* sums, float* counts) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    int32_t c = codes[i];
    if (c >= 0 && c < g) {
      atomicAdd(&sums[c], vals[i]);
      atomicAdd(&counts[c], 1.0f);
    }
  }
}

__global__ void fill_zero(float* a, float* b, int32_t g) {
  for (int32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < g;
       j += gridDim.x * blockDim.x) {
    a[j] = 0.0f;
    b[j] = 0.0f;
  }
}

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

}  // namespace

REPRO_API int hash_group_launch(const void* codes, const void* vals, int64_t n,
                                int64_t g, void* sums, void* counts,
                                void* stream) {
  if (g < 1 || g > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int32_t*>(codes);
  auto v = static_cast<const float*>(vals);
  auto so = static_cast<float*>(sums);
  auto co = static_cast<float*>(counts);
  int32_t g32 = static_cast<int32_t>(g);
  fill_zero<<<repro::grid_for(g, 1, repro::kSms), repro::kThreads, 0, s>>>(
      so, co, g32);
  if (g <= kSmemMaxGroups) {
    // every block flushes up to g groups: fewer, fuller blocks when g is
    // large against the rows
    int per_thread = g > 1024 ? 16 : 4;
    int blocks = repro::grid_for(n, per_thread, repro::kSms * 4);
    group_sum_smem<<<blocks, repro::kThreads, 2 * g * sizeof(float), s>>>(
        c, v, n, g32, so, co);
  } else {
    int blocks = repro::grid_for(n, 4, repro::kSms * 16);
    group_sum_global<<<blocks, repro::kThreads, 0, s>>>(c, v, n, g32, so, co);
  }
  return static_cast<int>(cudaGetLastError());
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
                               void* sums, void* counts, void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return hash_group_launch(codes, vals, n, g, sums, counts, stream);
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
