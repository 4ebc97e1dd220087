// Shared pieces of the LayerNorm kernels K3-fwd and K3-bwd
// (layer_norm_fwd.cu, layer_norm_bwd.cu): 16-byte row slices of the two
// activation types widened to float32 and narrowed back, float32 parameter
// slices, and the launch limits.
//
// A row of D values is cut into D / kN slices of 16 bytes (kN = 8 at bf16,
// 4 at float32); lane l of the warp that owns the row takes slices l,
// l + 32, l + 64, ...  The float32 arithmetic uses the _rn intrinsics, so
// nvcc contracts no product and sum into an FMA that the plain twin
// (kernels/fused_ln.py) does not make.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace egovlp {
namespace k3 {

constexpr int kWarps = 8;          // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 1024;        // the widest row the backward holds
constexpr int kBwdRowsPerBlock = 32;  // rows a backward block sums

// blocks of a backward launch over `rows` rows: the rows of its partial sums
inline int bwd_blocks(int rows) { return (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock; }

template <typename T>
struct Slice {
  static constexpr int kN = 16 / sizeof(T);
};

// 16 bytes of T at p (16-byte aligned) as kN floats
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// kN floats rounded to nearest even as 16 bytes of T
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return r;
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& r) {
  *reinterpret_cast<uint4*>(p) = r;
}

// kN float32 parameters from p (16-byte aligned)
template <int kN>
__device__ __forceinline__ void load_params(const float* p, float (&f)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    f[i] = t.x;
    f[i + 1] = t.y;
    f[i + 2] = t.z;
    f[i + 3] = t.w;
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace k3
}  // namespace egovlp
