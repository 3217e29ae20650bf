// Error text for the cudaError_t codes the kernel entry points return, so
// the Python wrappers can raise with a readable message; and an empty kernel,
// the shortest launch of the library, whose device time is the floor under
// every kernel's (chip_smoke.py reads it beside the latency-bound kernels).

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
