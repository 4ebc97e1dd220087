// Grouped attention forward (K4-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_fwd_kernel, launched by
// _fwd_call (the forward of the grouped_attention custom_vjp).
//
// What it computes: q, k, v, out are [BH, G, L, hd] (heads already split, q
// already scaled); cls_k, cls_v are [BH, 1, hd].  For each (bh, group g) the
// L queries attend over the L + 1 keys [cls_k[bh]; k[bh, g]] and return the
// softmax-weighted sum of [cls_v[bh]; v[bh, g]].
//
// Rounding follows the Pallas body (:40-51): logits, the row max and the row
// sum are float32; the probabilities are normalised (p / rowsum) and THEN
// rounded to the input dtype; the P.V sum is float32 up to the one cast of
// the output.  (K1-fwd rounds the unnormalised exponentials instead and
// scales after the sum, and rounds q * scale: a K1 launch with one head and
// scale 1 is not this kernel at bf16.)
//
// What bounds it on an H100: as K1-fwd, not device memory (at L 196, hd 64
// each CTA reads its (L+1) x hd K/V tile once, ~100 FLOP per byte moved)
// but the CUDA-core FMA rate and shared-memory bandwidth: both products run
// as scalar FMAs over shared memory.
//
// Design: one CTA per (bh, g), any L.  A group's rows are contiguous
// (L x hd elements), so the CTA stages [cls; k] and [cls; v] with coalesced
// loads into shared memory (rows padded by 4 bytes so the lanes of a warp,
// which each walk a different key row, hit distinct banks); then each of its
// 8 warps takes query rows in turn: the lanes split the L + 1 keys for the
// logits and the hd output columns for P.V.  One float32 softmax pass per
// row, with no online rescale, since the whole key row fits.  The ragged
// edge of L needs no mask: every loop is bounded by L exactly, and a group
// of fewer than 8 rows leaves warps idle.  Shared memory at L 196, hd 64:
// 59 KB (bf16), 108 KB (float32).  Tensor-core and TMA versions are later
// work.

#include <math.h>

#include "common.cuh"

namespace egovlp {
namespace {

constexpr int kGroupedWarps = 8;

template <typename T>
__host__ __device__ inline int grouped_row_stride(int hd) {
  return hd + 4 / static_cast<int>(sizeof(T));
}

template <typename T>
inline size_t grouped_smem_bytes(int L, int hd) {
  const size_t lk = static_cast<size_t>(L) + 1;
  return 2 * lk * grouped_row_stride<T>(hd) * sizeof(T) +
         static_cast<size_t>(kGroupedWarps) * (hd + lk) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kGroupedWarps * 32)
grouped_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ cls_k,
                             const T* __restrict__ cls_v, T* __restrict__ out, int G,
                             int L, int hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lk = L + 1;
  const int ks = grouped_row_stride<T>(hd);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(lk) * ks;
  // 2 * lk * ks * sizeof(T) is a multiple of 4 bytes for both dtypes
  float* warp_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(lk) * ks);

  const int bh = blockIdx.x / G;  // blockIdx.x = bh * G + g
  const size_t grp_off = static_cast<size_t>(blockIdx.x) * L * hd;
  const size_t cls_off = static_cast<size_t>(bh) * hd;

  // key/value row 0 is the CLS token, rows 1..L this group's tokens
  for (int t = threadIdx.x; t < lk * hd; t += blockDim.x) {
    const int r = t / hd, d = t % hd;
    if (r == 0) {
      k_s[d] = cls_k[cls_off + d];
      v_s[d] = cls_v[cls_off + d];
    } else {
      const size_t src = grp_off + static_cast<size_t>(t - hd);
      k_s[r * ks + d] = k[src];
      v_s[r * ks + d] = v[src];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q_s = warp_s + static_cast<size_t>(warp) * (hd + lk);  // [hd]
  float* p_s = q_s + hd;                                        // [L + 1]

  for (int i = warp; i < L; i += kGroupedWarps) {
    const size_t row = grp_off + static_cast<size_t>(i) * hd;
    for (int d = lane; d < hd; d += 32) q_s[d] = Cvt<T>::to_f(q[row + d]);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      const T* kr = k_s + j * ks;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(q_s[d], Cvt<T>::to_f(kr[d]), s);
      p_s[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
    for (int j = lane; j < lk; j += 32) {
      const float e = expf(p_s[j] - m);
      p_s[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // each lane rounds the entries it wrote: p = round(e / rowsum)
    for (int j = lane; j < lk; j += 32) p_s[j] = round_to<T>(p_s[j] / sum);
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < lk; ++j) acc = fmaf(p_s[j], Cvt<T>::to_f(v_s[j * ks + d]), acc);
      out[row + d] = Cvt<T>::from_f(acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_grouped(const void* q, const void* k, const void* v, const void* ck,
                   const void* cv, void* out, int BH, int G, int L, int hd, int device,
                   cudaStream_t stream) {
  const size_t smem = grouped_smem_bytes<T>(L, hd);
  cudaError_t err = check_smem(smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(grouped_attention_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH) * G);
  grouped_attention_fwd_kernel<T><<<grid, kGroupedWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<T*>(out), G, L,
      hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_grouped_attention_fwd(const void* q, const void* k, const void* v,
                                            const void* cls_k, const void* cls_v, void* out,
                                            int BH, int G, int L, int hd, int dtype,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_grouped<__nv_bfloat16>(q, k, v, cls_k, cls_v, out, BH, G, L, hd,
                                                 device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_grouped<float>(q, k, v, cls_k, cls_v, out, BH, G, L, hd, device,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}
