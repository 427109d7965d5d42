// Error text for the codes the kernel entry points return, an empty
// kernel: the floor of one executor call (chip_smoke.py launches it through
// registry.host_call, the way the executor calls every SQL kernel), and the
// count of a captured CUDA graph's kernel nodes (the card tests count a
// wrapper's launches from it).
#include <vector>

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

REPRO_API int repro_graph_kernel_nodes(void* graph, int64_t* kernels) {
  auto g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  std::vector<cudaGraphNode_t> nodes(count);
  if (err == cudaSuccess && count > 0)
    err = cudaGraphGetNodes(g, nodes.data(), &count);
  int64_t found = 0;
  for (size_t i = 0; err == cudaSuccess && i < count; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    found += type == cudaGraphNodeTypeKernel;
  }
  *kernels = found;
  return static_cast<int>(err);
}
