// Error text for the cudaError_t codes the kernel entry points return, so
// the Python wrappers can raise with a readable message.

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
