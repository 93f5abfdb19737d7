// Error text for the launchers' return codes (each returns cudaError_t).
#include <cuda_runtime.h>

extern "C" const char* gnnk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
