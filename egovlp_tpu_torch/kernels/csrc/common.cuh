// Shared helpers of the divided-attention kernels: dtype codes, float
// conversion of the two supported element types, warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace egovlp {

// dtype codes passed by the Python wrappers (kernels/cuda_attention.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// usable dynamic shared memory of one block on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;

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
