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

// bf16 as the kernels store it: the upper 16 bits of the f32 value.
using bf16_bits = uint16_t;

// f32 -> the nearest bf16 value (ties to even), as an f32: one hardware
// conversion (cvt.rn.bf16.f32, sm_80 and later) in inline PTX, so the
// sources need no cuda_bf16.h and build the same under any conversion
// macros. For every value but NaN this is bit for bit PyTorch's float ->
// BFloat16 conversion (c10::detail::round_to_nearest_even); a NaN stays a
// NaN, with other payload bits.
__device__ __forceinline__ float round_bf16(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(h) : "f"(x));
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// A bf16 value (its 16 bits) widened to f32: exact.
__device__ __forceinline__ float bf16_to_float(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// An f32 value that is a bf16 value already (round_bf16's result) -> its
// 16 bits.
__device__ __forceinline__ unsigned bf16_bits_of(float x) {
  return __float_as_uint(x) >> 16;
}

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
