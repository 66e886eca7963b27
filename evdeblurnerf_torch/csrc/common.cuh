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
// PyTorch's: make the tensors' device current before a launch. Asking
// which device is current costs a fraction of setting it, so the device
// is set only when another one is current.
#define EVDN_SET_DEVICE(device)                                  \
  do {                                                           \
    int current_ = -1;                                           \
    cudaError_t err_ = cudaGetDevice(&current_);                 \
    if (err_ == cudaSuccess && current_ != (device))             \
      err_ = cudaSetDevice(device);                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_);      \
  } while (0)

namespace evdn {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t work, int64_t per_block) {
  return static_cast<unsigned int>((work + per_block - 1) / per_block);
}

constexpr int kMaxDevices = 64;

// Multiprocessors of a device and the dynamic shared memory a block can
// opt in to (bytes), asked once per device.
inline cudaError_t device_limits(int device, int* sms, int* smem_optin) {
  static int cached_sms[kMaxDevices], cached_smem[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[device] == 0) {
    int n_sm = 0, optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &n_sm, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cached_smem[device] = optin;
    cached_sms[device] = n_sm;
  }
  *sms = cached_sms[device];
  *smem_optin = cached_smem[device];
  return cudaSuccess;
}

// Lets `kernel` use up to `bytes` of dynamic shared memory on `device`;
// `raised` is the kernel's own flag array, one entry a device.
template <typename Kernel>
cudaError_t raise_shared_memory(Kernel kernel, int bytes, int device,
                                bool* raised) {
  if (raised[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) raised[device] = true;
  return err;
}

}  // namespace evdn
