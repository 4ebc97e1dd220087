// Shared helpers of the divided-attention kernels: dtype codes, float
// conversion of the two supported element types, warp reductions, and the
// device limits that size a launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace egovlp {

// dtype codes passed by the Python wrappers (kernels/cuda_attention.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// bodies of the head-split time kernels K5, the `body` argument of their
// entry points (kernels/cuda_attention.py, time_hs_body): the 16-byte
// streaming body of time_attention_stream.cuh, or the scalar shared-memory
// body, which takes the shapes the streaming body does not
constexpr int kStreamBody = 0;
constexpr int kScalarBody = 1;

// K1's softmax runs in base 2, as the Pallas space bodies do: log2(e) is
// folded into the q scaling before q is rounded, and ln(2) restores dK
constexpr double kLog2e = 1.4426950408889634;
constexpr float kLn2 = 0.6931471805599453f;

// Limits of a device that size a launch, read from the runtime once per
// device (the values do not change while a process runs).  Host threads may
// launch at once (the ctypes calls release the GIL): std::call_once fills
// each device's entry exactly once, and every caller sees it complete.  An
// error reading the limits is kept and returned on every later call.
struct DeviceLimits {
  int smem_optin;      // dynamic shared memory one block may opt in to
  int smem_per_sm;     // shared memory of one SM
  int smem_reserved;   // shared memory the runtime reserves per block
  int threads_per_sm;  // resident threads of one SM
  int sms;             // streaming multiprocessors
};

constexpr int kMaxDevices = 64;

inline cudaError_t read_device_limits(int device, DeviceLimits* lim) {
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&lim->smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&lim->smem_per_sm,
                                    cudaDevAttrMaxSharedMemoryPerMultiprocessor, device)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&lim->smem_reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                    device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&lim->threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                                    device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&lim->sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  return cudaSuccess;
}

inline cudaError_t device_limits(int device, DeviceLimits* out) {
  static DeviceLimits cache[kMaxDevices];
  static cudaError_t errs[kMaxDevices];
  static std::once_flag once[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device],
                 [device] { errs[device] = read_device_limits(device, &cache[device]); });
  if (errs[device] != cudaSuccess) return errs[device];
  *out = cache[device];
  return cudaSuccess;
}

// Launch configuration of a kernel whose CTA stages `smem` bytes and loops
// over its work with a blockDim-strided loop: refused (cudaErrorInvalidValue)
// above the device's opt-in limit; otherwise as many CTAs as the SM's shared
// memory holds, each with enough threads that together they fill the SM's
// thread slots (a multiple of 32, from 128 to kMaxThreads).
constexpr int kMaxThreads = 1024;

inline cudaError_t threads_for_smem(size_t smem, int device, int* threads) {
  DeviceLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(lim.smem_optin)) return cudaErrorInvalidValue;
  const size_t per_cta = smem + static_cast<size_t>(lim.smem_reserved);
  const int ctas = std::max(1, static_cast<int>(lim.smem_per_sm / per_cta));
  *threads = std::min(kMaxThreads, std::max(128, lim.threads_per_sm / ctas / 32 * 32));
  return cudaSuccess;
}

// Patch columns one CTA of the head-split time kernels (K5) takes: as many as
// fit in kColumnSmemBudget bytes of shared memory beside `fixed` bytes, at
// most kMaxColumns and N, at least one.  The budget leaves room for three
// CTAs an SM; a shape whose one column passes the opt-in limit is refused by
// threads_for_smem.
constexpr int kMaxColumns = 32;
constexpr size_t kColumnSmemBudget = 64 * 1024;

inline int columns_for_smem(size_t per_column, size_t fixed, int N) {
  const size_t room = kColumnSmemBudget > fixed ? kColumnSmemBudget - fixed : 0;
  const int nb = static_cast<int>(std::min<size_t>(room / per_column, kMaxColumns));
  return std::max(1, std::min(nb, N));
}

// Refuses `smem` above the device's opt-in limit.
inline cudaError_t check_smem(size_t smem, int device) {
  DeviceLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  return smem > static_cast<size_t>(lim.smem_optin) ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round to nearest even, as jnp/torch casts do
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16_rn(x);
  }
};

// round a float to T and back: models a cast to the input dtype
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::to_f(Cvt<T>::from_f(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace egovlp
