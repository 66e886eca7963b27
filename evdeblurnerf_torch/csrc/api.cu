// Error text for the codes the entry points return (cudaError_t values).
#include "common.cuh"

EVDN_API const char* evdn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
