// Join-key dictionary lookup: per probe value, the position of its exact
// match in an ascending float32 dictionary (no NaN), else -1.
//
// Replaces the TPU kernel key_lookup_pallas / _lookup_kernel in
// src/repro/kernels/key_lookup/key_lookup.py (the hash-join probe of the
// streaming executor).  Each thread runs a leftmost binary search of at most
// ceil(log2(G+1)) steps, then tests equality at the insertion point, which
// is searchsorted + equality in one pass; the result is exact.
//
// Bound on this card: bytes (4 read + 4 written per probe, plus the
// dictionary once).  The search's log2(G) dependent reads would go to L2 if
// they hit device memory, so each block first stages the dictionary in
// shared memory when it fits (SSB's dictionaries are at most 2,556 floats,
// 10 KB) and searches there; a larger dictionary is searched in place.
#include "common.cuh"

namespace {

constexpr int64_t kSmemMaxEntries = (48 * 1024) / sizeof(float);

__device__ __forceinline__ int32_t lower_bound(const float* s, int32_t g,
                                               float p) {
  int32_t lo = 0, hi = g;
  while (lo < hi) {
    int32_t mid = (lo + hi) >> 1;
    if (s[mid] < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kStage>
__global__ void key_lookup_kernel(const float* __restrict__ sorted, int32_t g,
                                  const float* __restrict__ probe, int64_t n,
                                  int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  const float* dict = sorted;
  if (kStage) {
    for (int32_t j = threadIdx.x; j < g; j += blockDim.x) smem[j] = sorted[j];
    __syncthreads();
    dict = smem;
  }
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float p = probe[i];
    int32_t lo = lower_bound(dict, g, p);
    out[i] = (lo < g && dict[lo] == p) ? lo : -1;
  }
}

}  // namespace

REPRO_API int key_lookup_launch(const void* sorted, int64_t g,
                                const void* probe, int64_t n, void* out,
                                void* stream) {
  if (g < 1 || g > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto dict = static_cast<const float*>(sorted);
  auto pr = static_cast<const float*>(probe);
  auto o = static_cast<int32_t*>(out);
  int32_t g32 = static_cast<int32_t>(g);
  if (g <= kSmemMaxEntries) {
    // staging costs g reads per block: use fewer, fuller blocks
    int blocks = repro::grid_for(n, 8, repro::kSms * 4);
    key_lookup_kernel<true><<<blocks, repro::kThreads, g * sizeof(float), s>>>(
        dict, g32, pr, n, o);
  } else {
    int blocks = repro::grid_for(n, 1, repro::kSms * 16);
    key_lookup_kernel<false><<<blocks, repro::kThreads, 0, s>>>(
        dict, g32, pr, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
