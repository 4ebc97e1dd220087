// Space attention forward (K1-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_mk_space_fwd_bsd_v3
// (and _v2 at one head per lane block), launched by _space_fwd_bsd_call.
//
// What it computes: q, k, v, out are [B, G, L, D] (G frames of L patch
// tokens, D = H * hd, heads sliced from D by stride); cls_k, cls_v are
// [B, 1, D].  For each (b, frame g, head h) the L patch queries, scaled by
// `scale`, attend over the L + 1 keys [cls_k; k[b, g]] and return the
// softmax-weighted sum of [cls_v; v[b, g]].
//
// Rounding points of the Pallas bodies (:473-480, :590-602): q is scaled by
// scale * log2(e) and rounded to the input dtype; logits (in log2 units),
// the row max and the row sum are float32; the exponentials exp2(s - max)
// are rounded to the input dtype before the P.V sum, and the float32 sum is
// multiplied by 1 / rowsum before the final cast.
//
// bf16 launches run the tensor-core body of attention_fwd_mma.cuh (the
// kSpace policy), which says what bounds this kernel and what its design
// does about it.  float32 launches keep the scalar body below (tensor
// cores at float32 would be TF32): one CTA per (b, g, h) stages [cls; k]
// and [cls; v] for its head in shared memory (rows padded by one float so the
// lanes of a warp, which each walk a different key row, hit distinct
// banks), then each of its 8 warps takes query rows in turn: the lanes split
// the L + 1 keys for the logits and the hd output columns for P.V, as
// scalar FMAs over shared memory.  One float32 softmax pass per row, with
// no online rescale, since the whole key row fits.

#include <math.h>

#include "attention_fwd_mma.cuh"
#include "common.cuh"

namespace egovlp {
namespace {

constexpr int kSpaceWarps = 8;

// rows of the staged keys and values padded by one float
__host__ __device__ inline int space_row_stride(int hd) { return hd + 1; }

inline size_t space_smem_bytes(int L, int hd) {
  const size_t lk = static_cast<size_t>(L) + 1;
  return (2 * lk * space_row_stride(hd) + static_cast<size_t>(kSpaceWarps) * (hd + lk)) *
         sizeof(float);
}

__global__ void __launch_bounds__(kSpaceWarps * 32)
space_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ cls_k,
                           const float* __restrict__ cls_v, float* __restrict__ out,
                           int G, int L, int D, int H, float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = D / H;
  const int lk = L + 1;
  const int ks = space_row_stride(hd);
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + static_cast<size_t>(lk) * ks;
  float* warp_s = v_s + static_cast<size_t>(lk) * ks;

  const int h = blockIdx.x % H;
  const int bg = blockIdx.x / H;  // b * G + g
  const int b = bg / G;
  const size_t grid_off = static_cast<size_t>(bg) * L * D + static_cast<size_t>(h) * hd;
  const size_t cls_off = static_cast<size_t>(b) * D + static_cast<size_t>(h) * hd;

  // key/value row 0 is the CLS token, rows 1..L this frame's patches
  for (int t = threadIdx.x; t < lk * hd; t += blockDim.x) {
    const int r = t / hd, d = t % hd;
    if (r == 0) {
      k_s[d] = cls_k[cls_off + d];
      v_s[d] = cls_v[cls_off + d];
    } else {
      const size_t src = grid_off + static_cast<size_t>(r - 1) * D + d;
      k_s[r * ks + d] = k[src];
      v_s[r * ks + d] = v[src];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q_s = warp_s + static_cast<size_t>(warp) * (hd + lk);  // [hd]
  float* p_s = q_s + hd;                                        // [L + 1]

  for (int i = warp; i < L; i += kSpaceWarps) {
    const size_t row = grid_off + static_cast<size_t>(i) * D;
    for (int d = lane; d < hd; d += 32) q_s[d] = q[row + d] * qscale;
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
      const float e = exp2f(p_s[j] - m);
      sum += e;
      p_s[j] = e;
    }
    sum = warp_sum(sum);
    __syncwarp();

    const float inv = 1.f / sum;
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < lk; ++j) acc = fmaf(p_s[j], v_s[j * ks + d], acc);
      out[row + d] = acc * inv;
    }
    __syncwarp();
  }
}

int launch_space_f32(const void* q, const void* k, const void* v, const void* ck,
                     const void* cv, void* out, int B, int G, int L, int D, int H,
                     float scale, int device, cudaStream_t stream) {
  const size_t smem = space_smem_bytes(L, D / H);
  cudaError_t err = check_smem(smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(space_attention_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * G * H);
  space_attention_fwd_kernel<<<grid, kSpaceWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ck),
      static_cast<const float*>(cv), static_cast<float*>(out), G, L, D, H,
      static_cast<float>(static_cast<double>(scale) * kLog2e));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_space_attention_fwd(const void* q, const void* k, const void* v,
                                          const void* cls_k, const void* cls_v, void* out,
                                          int B, int G, int L, int D, int H, float scale,
                                          int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_attention_fwd_mma<egovlp::FwdRounding::kSpace>(
        q, k, v, cls_k, cls_v, out, B, G, L, D, H, scale, device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_space_f32(q, k, v, cls_k, cls_v, out, B, G, L, D, H, scale,
                                    device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and shared memory of the
// bf16 kernel a launch at (L, hd) takes; returns a cudaError_t code.
extern "C" int egovlp_space_attention_fwd_attributes(int L, int hd, int* regs,
                                                     int* local_bytes, int* smem) {
  return egovlp::attention_fwd_mma_attributes<egovlp::FwdRounding::kSpace>(L, hd, regs,
                                                                           local_bytes, smem);
}
