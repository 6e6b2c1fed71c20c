// The CUDA runtime's message for an error code that a kernel entry returned.
#include <cuda_runtime.h>

extern "C" const char* vcd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
