// Error text for the cudaError_t codes the launchers of this library return.
#include <cuda_runtime.h>

extern "C" const char* gstk_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
