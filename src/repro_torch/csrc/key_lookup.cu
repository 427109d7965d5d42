// Join-key dictionary lookup: per probe value, the position of its exact
// match in an ascending float32 dictionary (no NaN), else -1.
//
// Replaces the TPU kernel key_lookup_pallas / _lookup_kernel in
// src/repro/kernels/key_lookup/key_lookup.py (the hash-join probe of the
// streaming executor), which keeps the dictionary replicated in VMEM.
//
// Bound on this card: bytes (4 read + 4 written per probe, plus the
// dictionary once).  The executor calls it once per probe morsel (up to a
// stripe of 8,192 rows against SSB's dictionaries of at most 2,556 keys)
// from four threads, and the dictionary stays on the card for the join's
// life (registry.upload), so after the first morsel it is read from L2.
// The design follows from that:
//  * each block stages the dictionary into shared memory with one bulk
//    asynchronous copy (common.cuh: stage_begin / stage_wait) while its
//    threads load their probe rows, and searches there; a dictionary over
//    48 KB is searched in place;
//  * the search is the branchless lower bound, ceil(log2 G) dependent steps
//    whose count depends on G alone, so a thread runs the searches of its
//    rows in lockstep;
//  * calls below kVecRows (the path's morsels) take one row a thread in
//    blocks of 128, so 1,024 rows spread over 8 SMs; larger calls take 4
//    rows a thread through 16-byte loads and stores, in a grid of up to 8
//    blocks an SM that loops, each thread loading its next rows before it
//    searches its current ones.
// The result is searchsorted (leftmost) and an equality test, exact.
#include "common.cuh"

namespace {

constexpr int64_t kSmemMaxEntries = (48 * 1024) / sizeof(float);
constexpr int kSmallThreads = 128;
// from this many rows on, 4 rows a thread
constexpr int64_t kVecRows = int64_t{4} * repro::kThreads * repro::kSms;

template <int kVec>
__device__ __forceinline__ void load_rows(const float* __restrict__ probe,
                                          int64_t i, int64_t n,
                                          float (&p)[kVec]) {
  if constexpr (kVec == 4) {
    if (i + 4 <= n) {
      const float4 q = *reinterpret_cast<const float4*>(probe + i);
      p[0] = q.x;
      p[1] = q.y;
      p[2] = q.z;
      p[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) p[v] = i + v < n ? probe[i + v] : 0.0f;
}

template <int kVec>
__device__ __forceinline__ void store_rows(int32_t* __restrict__ out,
                                           int64_t i, int64_t n,
                                           const int32_t (&r)[kVec]) {
  if constexpr (kVec == 4) {
    if (i + 4 <= n) {
      *reinterpret_cast<int4*>(out + i) = make_int4(r[0], r[1], r[2], r[3]);
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    if (i + v < n) out[i + v] = r[v];
}

// lower bound of each p[v] in dict[0, g), then the equality test
template <int kVec>
__device__ __forceinline__ void lookup(const float* __restrict__ dict,
                                       int32_t g, const float (&p)[kVec],
                                       int32_t (&r)[kVec]) {
  int32_t base[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) base[v] = 0;
  for (int32_t len = g; len > 1;) {
    const int32_t half = len >> 1;
#pragma unroll
    for (int v = 0; v < kVec; ++v)
      base[v] = dict[base[v] + half] < p[v] ? base[v] + half : base[v];
    len -= half;
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int32_t lo = base[v] + (dict[base[v]] < p[v] ? 1 : 0);
    r[v] = (lo < g && dict[lo] == p[v]) ? lo : -1;
  }
}

template <int kVec, bool kStage>
__global__ void __launch_bounds__(repro::kThreads)
    key_lookup_kernel(const float* __restrict__ sorted, int32_t g,
                      const float* __restrict__ probe, int64_t n,
                      int32_t* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * kVec;
  int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if constexpr (kStage) repro::stage_begin(smem, sorted, g, &bar);
  float p[kVec];
  load_rows<kVec>(probe, i, n, p);  // beside the dictionary's copy
  if constexpr (kStage) repro::stage_wait(&bar);
  const float* dict = kStage ? smem : sorted;
  for (; i < n; i += step) {
    float next[kVec];
    load_rows<kVec>(probe, i + step, n, next);
    int32_t r[kVec];
    lookup<kVec>(dict, g, p, r);
    store_rows<kVec>(out, i, n, r);
#pragma unroll
    for (int v = 0; v < kVec; ++v) p[v] = next[v];
  }
}

template <bool kStage>
void launch(const float* dict, int32_t g, const float* probe, int64_t n,
            int32_t* out, cudaStream_t s) {
  const size_t smem = kStage ? static_cast<size_t>(g) * sizeof(float) : 0;
  if (n >= kVecRows && repro::aligned16(probe) && repro::aligned16(out)) {
    const int blocks = repro::grid_for(n, 4, repro::kSms * 8);
    key_lookup_kernel<4, kStage><<<blocks, repro::kThreads, smem, s>>>(
        dict, g, probe, n, out);
  } else {
    const int blocks =
        repro::grid_for(n, 1, repro::kSms * 16, kSmallThreads);
    key_lookup_kernel<1, kStage><<<blocks, kSmallThreads, smem, s>>>(
        dict, g, probe, n, out);
  }
}

}  // namespace

REPRO_API int key_lookup_launch(const void* sorted, int64_t g,
                                const void* probe, int64_t n, void* out,
                                void* stream) {
  if (g < 1 || g > INT32_MAX || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto dict = static_cast<const float*>(sorted);
  auto pr = static_cast<const float*>(probe);
  auto o = static_cast<int32_t*>(out);
  const int32_t g32 = static_cast<int32_t>(g);
  if (g <= kSmemMaxEntries) {
    // the bulk copy reads 16-byte units (the wrapper aligns the dictionary)
    if (!repro::aligned16(dict))
      return static_cast<int>(cudaErrorMisalignedAddress);
    launch<true>(dict, g32, pr, n, o, s);
  } else {
    launch<false>(dict, g32, pr, n, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int key_lookup_trip(REPRO_TRIP_PARAMS, const void* sorted, int64_t g,
                              const void* probe, int64_t n, void* out,
                              void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return key_lookup_launch(sorted, g, probe, n, out, stream);
  });
}
