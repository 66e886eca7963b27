// Shared helpers of the evdeblurnerf_torch kernel library.
//
// Every entry point has a plain C signature (loaded with ctypes, see
// kernels/build.py), launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so that a
// refused launch (bad grid, too much shared memory) reaches the Python
// wrapper, which raises.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define EVDN_API extern "C" __attribute__((visibility("default")))

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: select the tensors' device before every launch.
#define EVDN_SET_DEVICE(device)                                  \
  do {                                                           \
    cudaError_t err_ = cudaSetDevice(device);                    \
    if (err_ != cudaSuccess) return static_cast<int>(err_);      \
  } while (0)

namespace evdn {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t work, int64_t per_block) {
  return static_cast<unsigned int>((work + per_block - 1) / per_block);
}

}  // namespace evdn
