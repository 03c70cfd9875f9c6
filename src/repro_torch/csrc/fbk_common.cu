// Shared C entry points of libfbkernels.so.
#include <cuda_runtime.h>

extern "C" const char* fbk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
