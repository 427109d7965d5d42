// Bloom-filter probe: out[i] = AND_{j<k} bit((h1[i] + j*h2[i]) & (B-1)).
//
// Replaces the TPU kernel bloom_probe_pallas / _probe_kernel in
// src/repro/kernels/bloom/bloom.py (paper §4.6 semijoin reducers: every
// fact-table stripe is probed against a runtime bloom filter built from the
// dimension side), which keeps the whole bitset in VMEM.  Positions are
// Kirsch-Mitzenmacher double hashing in uint32 over a power-of-two bitset
// of B bits held as uint32 words; bit pos is bit pos&31 of word pos>>5.  The
// result equals the host BloomFilter.might_contain exactly (its uint64
// positions agree in the low bits that the mask keeps, and its uint64 words
// are these words in pairs on a little-endian host).
//
// Bound on this card: bytes (8 read and 1 written per row, plus the bitset
// once).  The executor calls it once per fact stripe (8,192 rows) from four
// threads, against a bitset of 512 to 32,768 bits that stays on the card
// for the scan's life (registry.upload), so it is read from L2.  The design
// follows from that:
//  * calls below kVecRows (the path's stripes) take one row a thread in
//    blocks of 128, so a stripe of 8,192 rows spreads over 64 SMs, and each
//    block stages the bitset into shared memory with one bulk asynchronous
//    copy (common.cuh: stage_begin / stage_wait) while its threads load
//    their rows' hashes, when it fits in 48 KB (393,216 bits);
//  * larger calls take 4 rows a thread through 16-byte loads of both hash
//    halves and a 4-byte store, in a grid of up to 8 blocks an SM that
//    loops, each thread loading its next rows before it tests its current
//    ones, and read the bitset in place through L1: staging it in each of
//    a thousand blocks measured slower at 4M rows, as does a bitset over
//    48 KB at any size;
//  * the k bit tests are dependent reads into the bitset, so a thread runs
//    its rows' tests in lockstep, each row stopping at its first clear bit.
#include "common.cuh"

namespace {

constexpr int64_t kSmemMaxWords = (48 * 1024) / sizeof(uint32_t);
constexpr int kMaxHashes = 8;
constexpr int kSmallThreads = 128;
// from this many rows on, 4 rows a thread
constexpr int64_t kVecRows = int64_t{4} * repro::kThreads * repro::kSms;

template <int kVec>
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ h,
                                          int64_t i, int64_t n,
                                          uint32_t (&x)[kVec]) {
  if constexpr (kVec == 4) {
    if (i + 4 <= n) {
      const uint4 q = *reinterpret_cast<const uint4*>(h + i);
      x[0] = q.x;
      x[1] = q.y;
      x[2] = q.z;
      x[3] = q.w;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) x[v] = i + v < n ? h[i + v] : 0u;
}

template <int kVec>
__device__ __forceinline__ void store_rows(uint8_t* __restrict__ out,
                                           int64_t i, int64_t n,
                                           const bool (&ok)[kVec]) {
  if constexpr (kVec == 4) {
    if (i + 4 <= n) {
      *reinterpret_cast<uint32_t*>(out + i) =
          uint32_t{ok[0]} | uint32_t{ok[1]} << 8 | uint32_t{ok[2]} << 16 |
          uint32_t{ok[3]} << 24;
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    if (i + v < n) out[i + v] = ok[v] ? 1 : 0;
}

template <int kVec, bool kStage>
__global__ void __launch_bounds__(repro::kThreads)
    bloom_probe_kernel(const uint32_t* __restrict__ h1,
                       const uint32_t* __restrict__ h2,
                       const uint32_t* __restrict__ bits, int64_t words,
                       int k, uint32_t mask, int64_t n,
                       uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint64_t bar;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x * kVec;
  int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if constexpr (kStage) repro::stage_begin(smem, bits, words, &bar);
  uint32_t a[kVec], b[kVec];
  load_rows<kVec>(h1, i, n, a);  // beside the bitset's copy
  load_rows<kVec>(h2, i, n, b);
  if constexpr (kStage) repro::stage_wait(&bar);
  const uint32_t* set = kStage ? smem : bits;
  for (; i < n; i += step) {
    uint32_t na[kVec], nb[kVec];
    load_rows<kVec>(h1, i + step, n, na);
    load_rows<kVec>(h2, i + step, n, nb);
    bool ok[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) ok[v] = true;
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (ok[v]) {
          const uint32_t pos = (a[v] + static_cast<uint32_t>(j) * b[v]) & mask;
          ok[v] = (set[pos >> 5] >> (pos & 31u)) & 1u;
        }
      }
    }
    store_rows<kVec>(out, i, n, ok);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      a[v] = na[v];
      b[v] = nb[v];
    }
  }
}

}  // namespace

REPRO_API int bloom_probe_launch(const void* h1, const void* h2,
                                 const void* bits, int64_t words,
                                 int num_hashes, uint32_t mask, int64_t n,
                                 void* out, void* stream) {
  if (num_hashes < 1 || num_hashes > kMaxHashes || words < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const uint32_t*>(h1);
  auto b = static_cast<const uint32_t*>(h2);
  auto w = static_cast<const uint32_t*>(bits);
  auto o = static_cast<uint8_t*>(out);
  const int k = num_hashes;
  if (n >= kVecRows && repro::aligned16(a) && repro::aligned16(b) &&
      (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    const int blocks = repro::grid_for(n, 4, repro::kSms * 8);
    bloom_probe_kernel<4, false><<<blocks, repro::kThreads, 0, s>>>(
        a, b, w, words, k, mask, n, o);
  } else if (words <= kSmemMaxWords) {
    // the bulk copy reads 16-byte units (the wrapper aligns the bitset)
    if (!repro::aligned16(w))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const int blocks = repro::grid_for(n, 1, repro::kSms * 16, kSmallThreads);
    bloom_probe_kernel<1, true><<<blocks, kSmallThreads,
                                  static_cast<size_t>(words) * 4, s>>>(
        a, b, w, words, k, mask, n, o);
  } else {
    const int blocks = repro::grid_for(n, 1, repro::kSms * 16, kSmallThreads);
    bloom_probe_kernel<1, false><<<blocks, kSmallThreads, 0, s>>>(
        a, b, w, words, k, mask, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int bloom_probe_trip(REPRO_TRIP_PARAMS, const void* h1,
                               const void* h2, const void* bits,
                               int64_t words, int num_hashes, uint32_t mask,
                               int64_t n, void* out, void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream, [&] {
    return bloom_probe_launch(h1, h2, bits, words, num_hashes, mask, n, out,
                              stream);
  });
}
