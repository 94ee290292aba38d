// Shared C entry points of the port's kernel library.
#include <cuda_runtime.h>

extern "C" const char* wct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
