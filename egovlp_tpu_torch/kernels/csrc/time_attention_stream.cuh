// Shared pieces of the K2 time-attention kernels (time_attention_fwd.cu,
// time_attention_bwd.cu): the 16-byte lane slice of a row, the warp's
// place in the [B, F, N, D] grid, and the head-group reduction.
//
// Layout of the work.  Each frame row of a patch column is a contiguous
// D-wide row in memory.  A lane owns one 16-byte slice of a row: 8
// channels at bf16, 4 at float32.  P lanes (a power of two, 8 to 32) hold
// one head: hd / (16 bytes) of them carry channels, the rest of the P (hd
// not a power of two) hold zeros.  A warp so covers 32 / P heads of one
// patch column (4 heads of hd 64 at bf16: 512 contiguous bytes a row), and
// every lane of a head group ends a dot product with the group's whole sum
// after log2(P) xor shuffles, so all of them run the softmax.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egovlp {
namespace k2 {

constexpr int kWarps = 4;  // warps a CTA
constexpr int kFrameCap = 16;  // the most frames an instantiation holds

// One lane's 16-byte slice of a row, as raw bits; kN channels.
template <typename T>
struct Slice;

// to_f widens a slice to floats.  Its `salt` (the query or key the caller
// is working on) enters the unpacking as an operand, so the compiler
// neither hoists a held row's unpacking out of a loop nor keeps one
// unpacking live across the unrolled iterations: it unpacks each row where
// it is used, and the rows stay in registers as raw bits (at bf16, half
// the registers of floats).
template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void to_f(const uint4& u, float* f, int salt) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float is exact: the high half
      asm("// %2\n\tshl.b32 %0, %1, 16;" : "=f"(f[2 * i]) : "r"(w[i]), "r"(salt));
      asm("// %2\n\tand.b32 %0, %1, 0xffff0000;" : "=f"(f[2 * i + 1]) : "r"(w[i]), "r"(salt));
    }
  }
  // round to nearest even, as torch's casts do
  static __device__ __forceinline__ uint4 from_f(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Slice<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_f(const uint4& u, float* f, int salt) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) asm("// %2\n\tmov.b32 %0, %1;" : "=f"(f[i]) : "r"(w[i]), "r"(salt));
  }
  static __device__ __forceinline__ uint4 from_f(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 load(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the slice at `p` if `in`, else zeros (a lane without channels, a frame
// past F)
template <typename T>
__device__ __forceinline__ uint4 load_if(bool in, const T* p) {
  return in ? load(p) : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// lanes a head takes: a power of two from 8 to 32 that holds hd / kN slices
__host__ __device__ inline int lanes_per_head(int hd, int kn) {
  int p = 8;
  while (p * kn < hd) p <<= 1;
  return p;
}

// A shape the streaming bodies take: F from 1 to kFrameCap, hd a multiple of
// the lane's kN channels and at most 32 of them, 16-byte aligned pointers.
inline bool takes(int F, int hd, int kn) {
  return F >= 1 && F <= kFrameCap && hd % kn == 0 && hd / kn <= 32;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The lane's place: head group `g` of the warp's head slice, lane `r` in it,
// first channel `c`; `active` if it carries channels of a head.
struct Lane {
  int r, g, c;
  bool active;
  __device__ __forceinline__ Lane(int slice, int P, int H, int hd, int kn) {
    const int lane = threadIdx.x & 31;
    g = lane / P;
    r = lane % P;
    const int h = slice * (32 / P) + g;
    c = h * hd + r * kn;
    active = h < H && r * kn < hd;
  }
};

// sums of each of x[0..n) over the P lanes of a head group (aligned groups
// of a power of two): the n shuffles of one step are independent, so they
// overlap
template <int n>
__device__ __forceinline__ void group_sums(float* x, int P) {
  for (int o = P >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], o);
  }
}

template <int N>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// makes `device` current if it is not, so the launch goes to its stream
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace k2
}  // namespace egovlp
