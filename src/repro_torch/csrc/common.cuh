// Shared definitions of the port's CUDA kernels.
//
// Every entry point has a plain C interface (device pointers, sizes and the
// CUDA stream as void*), launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#define REPRO_API extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr int kThreads = 256;
constexpr int kSms = 132;  // H100 SXM

// The SMs of the current device, asked once (grids sized to one wave).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = kSms;
    return n;
  }();
  return sms;
}

// Blocks for a grid-stride loop over n items: enough to cover n with
// `per_thread` items a thread of `threads`, capped at `cap` blocks.
inline int grid_for(int64_t n, int per_thread, int cap,
                    int threads = kThreads) {
  int64_t per_block = static_cast<int64_t>(threads) * per_thread;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// One executor call in one native call (the Python side makes it through
// ctypes, which releases the interpreter lock once for all of it): the
// morsel's arrays copied into the calling thread's page-locked staging
// buffer and from there, in one asynchronous copy on the thread's own
// stream, into its device staging buffer; the kernel's launch; the results
// back to the page-locked buffer, asynchronously; a synchronisation of that
// stream alone; and the results copied out into the caller's arrays.
// `plan` lists the copies: the count of inputs, then (source, offset in
// host_in, bytes) for each; the count of outputs, then (destination, offset
// in host_out, bytes) for each.
template <typename Launch>
inline int trip(const int64_t* plan, void* host_in, void* dev_in,
                int64_t in_bytes, const void* dev_out, void* host_out,
                int64_t out_bytes, void* stream, Launch launch) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t* p = plan;
  for (int64_t i = 0, count = *p++; i < count; ++i, p += 3)
    std::memcpy(static_cast<char*>(host_in) + p[1],
                reinterpret_cast<const void*>(p[0]), p[2]);
  cudaError_t err = cudaSuccess;
  if (in_bytes > 0)
    err = cudaMemcpyAsync(dev_in, host_in, in_bytes, cudaMemcpyHostToDevice,
                          s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int launched = launch();
  if (launched != 0) return launched;
  if (out_bytes > 0)
    err = cudaMemcpyAsync(host_out, dev_out, out_bytes,
                          cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int64_t i = 0, count = *p++; i < count; ++i, p += 3)
    std::memcpy(reinterpret_cast<void*>(p[0]),
                static_cast<const char*>(host_out) + p[1], p[2]);
  return 0;
}

// the leading parameters of every kernel's *_trip entry point
#define REPRO_TRIP_PARAMS                                               \
  const int64_t *plan, void *host_in, void *dev_in, int64_t in_bytes,   \
      const void *dev_out, void *host_out, int64_t out_bytes
#define REPRO_TRIP_ARGS \
  plan, host_in, dev_in, in_bytes, dev_out, host_out, out_bytes

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Staging of a small read-only table (a join's dictionary, a bloom
// filter's bitset) into a block's shared memory by Hopper's bulk
// asynchronous copy: thread 0 issues one cp.async.bulk global -> shared of
// the table's whole 16-byte units, whose completion the copy engine counts
// in bytes on an mbarrier; the block's threads copy the last words, and
// are free to load their own rows before stage_wait.  `src` and `dst` must
// be 16-byte aligned; `bar` is a shared 8-byte barrier used once.
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <typename T>
__device__ __forceinline__ void stage_begin(T* dst, const T* src,
                                            int64_t count, uint64_t* bar) {
  static_assert(sizeof(T) == 4, "staging copies 32-bit words");
  const uint32_t body = static_cast<uint32_t>((count * 4) & ~int64_t{15});
  const uint32_t b = shared_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (body > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
          "r"(body)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
          "l"(src), "r"(body), "r"(b)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(b)
                   : "memory");
    }
  }
  for (int64_t i = body / 4 + threadIdx.x; i < count; i += blockDim.x)
    dst[i] = src[i];
}

// Wait until the bulk copy has landed (phase 0 of `bar`) and every thread's
// last words are in place.
__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  const uint32_t b = shared_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  } while (!done);
  __syncthreads();
}

}  // namespace repro
