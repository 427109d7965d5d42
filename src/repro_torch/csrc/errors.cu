// Error text for the codes the kernel entry points return, and an empty
// kernel: the floor of one executor call (chip_smoke.py launches it through
// registry.host_call, the way the executor calls every SQL kernel).
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

REPRO_API int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int repro_empty_trip(REPRO_TRIP_PARAMS, void* stream) {
  return repro::trip(REPRO_TRIP_ARGS, stream,
                     [&] { return repro_empty_launch(stream); });
}
