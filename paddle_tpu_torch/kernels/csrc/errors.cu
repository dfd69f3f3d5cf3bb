// Error text for the CUDA error codes the kernel entry points return.
#include <cuda_runtime.h>

extern "C" const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
