// Error text for the codes the kernel entry points return.
#include "kft_common.cuh"

extern "C" const char* kft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
