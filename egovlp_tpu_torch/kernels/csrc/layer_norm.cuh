// Shared pieces of the LayerNorm kernels K3-fwd and K3-bwd
// (layer_norm_fwd.cu, layer_norm_bwd.cu): 16-byte row slices of the two
// activation types widened to float32 and narrowed back, float32 parameter
// slices, the two row segments of a launch, and the persistent grid.
//
// A launch takes two row segments of one width D that share the
// parameters: segment a ([rows_a, D]) and segment b ([rows_b, D]), row r of
// the launch being row r of a for r < rows_a and row r - rows_a of b
// after it.  The video tower's CLS + patch pair is one launch, the patch
// rows as a and the CLS rows as b (the tail of the grid); a single tensor
// is segment a with rows_b 0.
//
// A row of D values is cut into D / kN slices of 16 bytes (kN = 8 at bf16,
// 4 at float32); lane l of the warp that owns the row takes slices l,
// l + 32, l + 64, ...  The float32 arithmetic uses the _rn intrinsics, so
// nvcc contracts no product and sum into an FMA that the plain twin
// (kernels/fused_ln.py) does not make.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace egovlp {
namespace k3 {

constexpr int kWarps = 8;  // warps a block, one row a warp at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 1024;  // the widest row the backward holds

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

// row r of the launch in a tensor of `width` values a row, laid out as the
// two segments a (rows_a rows) and b
template <typename P>
__device__ __forceinline__ P row_of(P a, P b, int r, int rows_a, int width) {
  return r < rows_a ? a + static_cast<size_t>(r) * width
                    : b + static_cast<size_t>(r - rows_a) * width;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// The grid of a persistent launch of `kernel` (kThreads threads, `smem`
// bytes of dynamic shared memory a block) over `rows` rows: one warp a row,
// so ceil(rows / kWarps) blocks, but no more than min(cap, what one SM
// holds) blocks on each SM; the blocks then walk their rows.  What one SM
// holds is read from the runtime once per device and kept in `per_sm` (0:
// not read yet; the caller keys the slot by anything that changes `smem`).
template <typename K>
cudaError_t persistent_grid(K kernel, int rows, size_t smem, int cap, int device,
                            std::atomic<int>* per_sm, int* grid) {
  DeviceLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  int n = per_sm->load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (n == 0) return cudaErrorInvalidConfiguration;
    per_sm->store(n, std::memory_order_relaxed);
  }
  *grid = std::min((rows + kWarps - 1) / kWarps, std::min(n, cap) * lim.sms);
  return cudaSuccess;
}

}  // namespace k3
}  // namespace egovlp
