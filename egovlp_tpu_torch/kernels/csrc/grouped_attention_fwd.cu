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
// scales after the sum, and rounds q * scale * log2(e): a K1 launch with
// one head and scale 1 is not this kernel at bf16.)
//
// bf16 launches run the tensor-core body of attention_fwd_mma.cuh (the
// kGrouped policy, with H 1 and D = hd), which says what bounds this
// kernel and what its design does about it.  float32 launches keep the
// scalar body below (tensor cores at float32 would be TF32): one CTA per
// (bh, g), any L; a group's rows are contiguous (L x hd elements), so the
// CTA stages [cls; k] and [cls; v] with coalesced loads into shared memory
// (rows padded by one float so the lanes of a warp, which each walk a
// different key row, hit distinct banks); then each of its 8 warps takes
// query rows in turn: the lanes split the L + 1 keys for the logits and the
// hd output columns for P.V, as scalar FMAs over shared memory.  One
// float32 softmax pass per row, with no online rescale, since the whole key
// row fits.  Shared memory at L 196, hd 64: 108 KB.

#include <math.h>

#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace egovlp {
namespace {

constexpr int kGroupedWarps = 8;

// rows of the staged keys and values padded by one float
__host__ __device__ inline int grouped_row_stride(int hd) { return hd + 1; }

inline size_t grouped_smem_bytes(int L, int hd) {
  const size_t lk = static_cast<size_t>(L) + 1;
  return (2 * lk * grouped_row_stride(hd) + static_cast<size_t>(kGroupedWarps) * (hd + lk)) *
         sizeof(float);
}

__global__ void __launch_bounds__(kGroupedWarps * 32)
grouped_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ cls_k,
                             const float* __restrict__ cls_v, float* __restrict__ out,
                             int G, int L, int hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lk = L + 1;
  const int ks = grouped_row_stride(hd);
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + static_cast<size_t>(lk) * ks;
  float* warp_s = v_s + static_cast<size_t>(lk) * ks;

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
    for (int d = lane; d < hd; d += 32) q_s[d] = q[row + d];
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < lk; j += 32) {
      const float* kr = k_s + j * ks;
      float s = 0.f;
      for (int d = 0; d < hd; ++d) s = fmaf(q_s[d], kr[d], s);
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
    // each lane normalises the entries it wrote: p = e / rowsum
    for (int j = lane; j < lk; j += 32) p_s[j] = p_s[j] / sum;
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < lk; ++j) acc = fmaf(p_s[j], v_s[j * ks + d], acc);
      out[row + d] = acc;
    }
    __syncwarp();
  }
}

int launch_grouped_f32(const void* q, const void* k, const void* v, const void* ck,
                       const void* cv, void* out, int BH, int G, int L, int hd, int device,
                       cudaStream_t stream) {
  const size_t smem = grouped_smem_bytes(L, hd);
  cudaError_t err = check_smem(smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(grouped_attention_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH) * G);
  grouped_attention_fwd_kernel<<<grid, kGroupedWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ck),
      static_cast<const float*>(cv), static_cast<float*>(out), G, L, hd);
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
    return egovlp::launch_attention_fwd_mma<egovlp::FwdRounding::kGrouped>(
        q, k, v, cls_k, cls_v, out, BH, G, L, hd, 1, 1.f, device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_grouped_f32(q, k, v, cls_k, cls_v, out, BH, G, L, hd, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and shared memory of the
// bf16 kernel a launch at (L, hd) takes; returns a cudaError_t code.
extern "C" int egovlp_grouped_attention_fwd_attributes(int L, int hd, int* regs,
                                                       int* local_bytes, int* smem) {
  return egovlp::attention_fwd_mma_attributes<egovlp::FwdRounding::kGrouped>(
      L, hd, regs, local_bytes, smem);
}
