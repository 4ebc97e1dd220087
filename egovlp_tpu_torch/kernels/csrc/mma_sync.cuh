// Primitives of the bf16 tensor-core attention bodies on sm_90a, shared by
// the forward (attention_fwd_mma.cuh) and the backward
// (attention_bwd_mma.cuh): the rounding policies of the two Pallas kernel
// families, 16-byte cp.async, ldmatrix, mma.sync m16n8k16 (bf16 in,
// float32 accumulate), bf16 packing and the 4-lane row reductions of the
// m16n8 accumulator layout.
//
// Fragment layouts of mma.sync.m16n8k16.row.col, for lane = 4 * gq + tq:
//   A (16 x 16): a0 = (row gq, k 2tq..+1), a1 = (row gq + 8, k 2tq..+1),
//                a2 = (row gq, k 8 + 2tq..+1), a3 = (row gq + 8, k 8 + 2tq..+1)
//   B (16 x 8):  b0 = (k 2tq..+1, col gq), b1 = (k 8 + 2tq..+1, col gq)
//   C (16 x 8):  c0, c1 = (row gq, col 2tq..+1), c2, c3 = (row gq + 8, ...)
// so the C tiles of two neighbouring 8-column slices, packed as bf16
// pairs, are the A fragment of a product over those 16 columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace egovlp {

// kSpace: K1, the space bodies of pallas_attention.py (q scaled by
// scale * log2(e) and rounded; base-2 softmax; p = e * (1 / rowsum)).
// kGrouped: K4, _fwd_kernel / _bwd_kernel (q already scaled; natural
// softmax; p = e / rowsum).
enum class Rounding { kSpace, kGrouped };

namespace mma {

using bf16 = __nv_bfloat16;

// staged row stride in elements: a row plus 16 bytes, so the 8 rows an
// ldmatrix reads start in 8 distinct 16-byte bank groups
__host__ __device__ constexpr int row_stride(int hd) { return hd + 8; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x; results below 2^-126 flush to zero (under a bf16 ulp of any row
// sum, which holds the row max's term 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b, correctly rounded for a in [0, 1] and b >= 1, from r = 1 / b
// (correctly rounded) and one FMA correction of the remainder
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float y = a * r;
  return fmaf(fmaf(-y, b, a), r, y);
}

}  // namespace mma
}  // namespace egovlp
