// Bloom-filter probe: out[i] = AND_{j<k} bit((h1[i] + j*h2[i]) & (B-1)).
//
// Replaces the TPU kernel bloom_probe_pallas / _probe_kernel in
// src/repro/kernels/bloom/bloom.py (paper §4.6 semijoin reducers: every
// fact-table stripe is probed against a runtime bloom filter built from the
// dimension side).  Positions are Kirsch-Mitzenmacher double hashing in
// uint32 over a power-of-two bitset of B bits held as uint32 words; bit pos
// is bit pos&31 of word pos>>5.  The result equals the host
// BloomFilter.might_contain exactly (its uint64 positions agree in the low
// bits that the mask keeps, and its uint64 words are these words in pairs on
// a little-endian host).
//
// Bound on this card: bytes (8 read and 1 written per row, plus the bitset
// once).  The k bit tests are dependent random reads into the bitset, so
// each block first stages the bitset in shared memory when it fits in 48 KB
// (393,216 bits; SSB's runtime filters have 64 to 32,768); a larger bitset
// is read from device memory through the read-only path.  This is the TPU
// kernel's copy of the whole bitset in VMEM, on Hopper.  A row stops at its
// first clear bit.
#include "common.cuh"

namespace {

constexpr int64_t kSmemMaxWords = (48 * 1024) / sizeof(uint32_t);
constexpr int kMaxHashes = 8;

template <bool kStage>
__global__ void bloom_probe_kernel(const uint32_t* __restrict__ h1,
                                   const uint32_t* __restrict__ h2,
                                   const uint32_t* __restrict__ bits,
                                   int64_t words, int k, uint32_t mask,
                                   int64_t n, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const uint32_t* set = bits;
  if (kStage) {
    for (int64_t j = threadIdx.x; j < words; j += blockDim.x)
      smem[j] = __ldg(bits + j);
    __syncthreads();
    set = smem;
  }
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    uint32_t a = __ldg(h1 + i), b = __ldg(h2 + i);
    bool ok = true;
    for (int j = 0; j < k && ok; ++j) {
      uint32_t pos = (a + static_cast<uint32_t>(j) * b) & mask;
      uint32_t word = kStage ? set[pos >> 5] : __ldg(set + (pos >> 5));
      ok = (word >> (pos & 31u)) & 1u;
    }
    out[i] = ok ? 1 : 0;
  }
}

}  // namespace

REPRO_API int bloom_probe_launch(const void* h1, const void* h2,
                                 const void* bits, int64_t words,
                                 int num_hashes, uint32_t mask, int64_t n,
                                 void* out, void* stream) {
  if (num_hashes < 1 || num_hashes > kMaxHashes || words < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const uint32_t*>(h1);
  auto b = static_cast<const uint32_t*>(h2);
  auto w = static_cast<const uint32_t*>(bits);
  auto o = static_cast<uint8_t*>(out);
  if (words <= kSmemMaxWords) {
    // staging costs the bitset's reads per block: use fewer, fuller blocks
    int blocks = repro::grid_for(n, 8, repro::kSms * 4);
    bloom_probe_kernel<true><<<blocks, repro::kThreads,
                               words * sizeof(uint32_t), s>>>(
        a, b, w, words, num_hashes, mask, n, o);
  } else {
    int blocks = repro::grid_for(n, 4, repro::kSms * 16);
    bloom_probe_kernel<false><<<blocks, repro::kThreads, 0, s>>>(
        a, b, w, words, num_hashes, mask, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}
