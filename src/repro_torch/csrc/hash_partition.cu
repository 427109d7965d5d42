// Shuffle bucket assignment: lane = avalanche(fold_k float32 bits) % P.
//
// Replaces the TPU kernel hash_partition_pallas / _partition_kernel in
// src/repro/kernels/hash_partition/hash_partition.py.  Per row: each float32
// key column (-0.0 taken as +0.0) is bitcast to a uint32 word and folded as
// h = h * 16777619 ^ w (uint32 wrap), then the lowbias32 avalanche
// (0x7FEB352D, 0x846CA68B) mixes h and h % P is the lane.  The result is
// bit-identical to the numpy host path in core/runtime/shuffle.py, so one
// edge of a shuffle join may take this kernel while the other takes the host
// path.  Zero is normalised with a select on the compare, never with
// v + 0.0f: GPU arithmetic would canonicalise NaN payloads (NULL keys),
// which numpy keeps, and the two paths would then disagree on NULL lanes.
//
// Bound on this card: bytes (4 read per key column and 4 written per row; a
// handful of integer operations per row).  The design is one grid-stride
// pass with the whole fold in registers; the K <= 8 column pointers travel
// as one by-value kernel argument, so nothing is copied before the launch.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr uint32_t kMix1 = 0x7FEB352Du;
constexpr uint32_t kMix2 = 0x846CA68Bu;

struct PartitionArgs {
  const float* cols[kMaxCols];
  int k;
};

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 15;
  h *= kMix2;
  return h ^ (h >> 16);
}

__global__ void hash_partition_kernel(PartitionArgs a, int64_t n, uint32_t p,
                                      int32_t* __restrict__ out) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t h = 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c < a.k) {
        float v = __ldg(a.cols[c] + i);
        uint32_t w = (v == 0.0f) ? 0u : __float_as_uint(v);  // -0.0 -> +0.0
        h = (h * kFnvPrime) ^ w;
      }
    }
    out[i] = static_cast<int32_t>(avalanche(h) % p);
  }
}

}  // namespace

REPRO_API int hash_partition_launch(const void* const* cols, int k, int64_t n,
                                    int num_partitions, void* out,
                                    void* stream) {
  if (k < 1 || k > kMaxCols || num_partitions < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PartitionArgs a;
  for (int c = 0; c < kMaxCols; ++c)
    a.cols[c] = c < k ? static_cast<const float*>(cols[c]) : nullptr;
  a.k = k;
  int blocks = repro::grid_for(n, 4, repro::kSms * 16);
  hash_partition_kernel<<<blocks, repro::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      a, n, static_cast<uint32_t>(num_partitions),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int hash_partition_trip(REPRO_TRIP_PARAMS, const void* const* cols,
                                   int k, int64_t n, int num_partitions,
                                   void* out, void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return hash_partition_launch(cols, k, n, num_partitions, out, stream);
  });
}
