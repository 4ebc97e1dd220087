// Shared pieces of the bias add + exact GELU kernels K7-fwd and K7-bwd
// (bias_gelu_fwd.cu, bias_gelu_bwd.cu): the rounding chain of
// core/precision.py, 16-byte row slices, the bf16 tables and the launch
// checks.
//
// The rounding chain.  With h = rnd(y + rnd(b)) (or h = y without a bias),
// s = sqrt(0.5) rounded to the activation type T and rnd() a round to T:
//   a = rnd(0.5 h),  c = rnd(h * -s),  e = rnd(erfcf(c)),  g = rnd(a e),
// each product computed in float32, as PyTorch's CUDA ops compute a bf16
// op (kernels/bias_gelu.py holds the same ops in PyTorch).  Its slope,
// dg / dh = 0.5 e + a (s 2 / sqrt(pi)) exp(-c^2), is computed in float32
// from the rounded a, c and e and not rounded.  The _rn intrinsics keep
// nvcc from contracting a product and a sum into an FMA that the PyTorch
// ops do not make.
//
// The tables.  At bf16 g and the slope depend on h alone, and h is one of
// 65,536 bf16 values: each block first evaluates the chain for every h
// with |h| in [2^-16, 16), both signs (kTable entries), into shared
// memory, and then looks g or the slope up by h's bits.  Any other h
// (zeros, tiny values, |h| >= 16, Inf, NaN) takes the chain itself, so a
// table entry and the chain never disagree: both are the same code.  A
// float32 h has no table; the chain runs for every element.
//
// Each kernel's file says how it walks the rows: the forward one contiguous
// chunk of rows a block, as a copy does; the backward column slabs of a
// chunk, so that a lane keeps its columns' bias gradient sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace egovlp {
namespace k7 {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;

// the bf16 tables: h's biased exponent in [kE0, kE0 + kNE), both signs
constexpr uint32_t kE0 = 127 - 16;
constexpr uint32_t kNE = 20;
constexpr uint32_t kHalf = kNE * 128;  // entries of one sign
constexpr int kTable = 2 * kHalf;

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

// x rounded to T to nearest even, as float
template <typename T>
__device__ __forceinline__ float rnd(float x);

template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// g of h by the rounding chain
template <typename T>
__device__ __forceinline__ float gelu_chain(float h, float s) {
  const float a = rnd<T>(__fmul_rn(0.5f, h));
  const float c = rnd<T>(__fmul_rn(h, -s));
  const float e = rnd<T>(erfcf(c));
  return rnd<T>(__fmul_rn(a, e));
}

// dg / dh of h by the rounding chain (ks = s 2 / sqrt(pi) in float32)
template <typename T>
__device__ __forceinline__ float slope_chain(float h, float s, float ks) {
  const float a = rnd<T>(__fmul_rn(0.5f, h));
  const float c = rnd<T>(__fmul_rn(h, -s));
  const float e = rnd<T>(erfcf(c));
  return __fadd_rn(__fmul_rn(0.5f, e), __fmul_rn(__fmul_rn(a, ks), expf(-__fmul_rn(c, c))));
}

// the chains out of line, for a bf16 h outside the tables (rare): one copy
// of erfcf's code a kernel instead of one a vector element
static __device__ __noinline__ float gelu_rare(float h, float s) {
  return gelu_chain<__nv_bfloat16>(h, s);
}

static __device__ __noinline__ float slope_rare(float h, float s, float ks) {
  return slope_chain<__nv_bfloat16>(h, s, ks);
}

// the table entry of a bf16 h (a float whose low 16 bits are 0), or
// kTable where h has none
__device__ __forceinline__ uint32_t table_index(float h) {
  const uint32_t u = __float_as_uint(h);
  const uint32_t m = ((u >> 16) & 0x7fffu) - (kE0 << 7);  // wraps below kE0
  return m < kHalf ? m + (u >> 31) * kHalf : static_cast<uint32_t>(kTable);
}

// the bf16 h of table entry i
__device__ __forceinline__ float table_h(uint32_t i) {
  const uint32_t sign = i >= kHalf ? 0x8000u : 0u;
  const uint32_t bits = sign | ((i % kHalf) + (kE0 << 7));
  return __uint_as_float(bits << 16);
}

// 16 bytes of T as kN floats, and kN floats (already rounded to T) back
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// bf16 values as the high halves of float bits: two a word
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// the launch's checks: rows >= 0, width a multiple of 8, chunks >= 1, the
// `n` row pointers and the bias (or nullptr) 16-byte aligned
inline cudaError_t check_launch(int rows, int width, int chunks, const void* const* ptrs, int n,
                                const void* bias) {
  if (rows < 0 || width <= 0 || width % 8 != 0 || chunks < 1) return cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i)
    if (!aligned16(ptrs[i])) return cudaErrorMisalignedAddress;
  if (bias != nullptr && !aligned16(bias)) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// rows of chunk `chunk`: [r0, r1)
__device__ __forceinline__ void chunk_rows(int rows, int chunks, int chunk, int& r0, int& r1) {
  const int per = (rows + chunks - 1) / chunks;
  r0 = min(rows, chunk * per);
  r1 = min(rows, r0 + per);
}

}  // namespace k7
}  // namespace egovlp
