// The text of a CUDA error code, for the Python wrappers' messages.
#include <cuda_runtime.h>

extern "C" const char* smd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
