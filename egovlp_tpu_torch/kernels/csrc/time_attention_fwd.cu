// Time attention forward (K2-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_mk_time_fwd_bsd_v2,
// which runs _mk_time_fwd_bsd_v3 at f <= 8, launched by _time_fwd_bsd_call.
//
// What it computes: q, k, v, out are [B, F, N, D] (F frames of N patch
// columns, D = H * hd, heads sliced from D by stride); cls_k, cls_v are
// [B, 1, D].  For each (b, patch column j, head h) the F frame queries of
// that column, scaled by `scale`, attend over the F + 1 keys
// [cls_k; k[b, :, j]] and return the softmax-weighted sum of
// [cls_v; v[b, :, j]].  As in the Pallas body, every value is widened to
// float32 on load; logits, softmax and accumulation stay float32 and the
// sum is divided by the row sum before the one cast to the output dtype.
//
// What bounds it on an H100: device memory.  The groups are tiny (F 4 to 16
// frames, hd 64), so each element of q, k and v takes part in only F + 1
// multiply-adds per product; the kernel has to read q, k, v and write out
// once, with coalesced accesses.
//
// Design: one CTA per (b, patch column j), covering all H heads.  Each of
// the F frame rows of that column is a contiguous D-wide row in memory, so
// the CTA stages q (pre-scaled), [cls_k; k] and [cls_v; v] as whole rows in
// shared memory with coalesced loads (rows padded by one float so threads
// on different rows hit different banks).  Threads then take (head, query,
// key) logits, (head, query) softmax rows, and (query, channel) outputs in
// turn, and the stores are contiguous D-wide rows again.  The grid is
// exactly B x N, so the TPU kernel's n padding is not needed.  Shared
// memory grows as (3F + 2) D floats: 167 KB at F 16, D 768.
//
// Launch configuration (counterpart of the VMEM n-block probe,
// _time_kernel_compiles / time_n_block): the CTA's shared memory is checked
// against the device's opt-in limit, read once per device, and a shape
// above it is refused (the wrapper raises).  The CTA size follows from the
// same limits (threads_for_smem in common.cuh): as many CTAs as the SM's
// shared memory holds, with enough threads to fill the SM between them.

#include <math.h>

#include "common.cuh"

namespace egovlp {
namespace {

inline size_t time_smem_bytes(int F, int D, int H) {
  const size_t dp = static_cast<size_t>(D) + 1;
  const size_t f = static_cast<size_t>(F);
  return ((3 * f + 2) * dp + H * f * (f + 1) + H * f) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
time_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ cls_k,
                          const T* __restrict__ cls_v, T* __restrict__ out, int F,
                          int N, int D, int H, float scale) {
  extern __shared__ __align__(16) float tsm[];
  const int dp = D + 1;
  const int f1 = F + 1;
  const int hd = D / H;
  float* q_s = tsm;                                 // [F][dp], scaled
  float* k_s = q_s + static_cast<size_t>(F) * dp;   // [F + 1][dp], row 0 CLS
  float* v_s = k_s + static_cast<size_t>(f1) * dp;  // [F + 1][dp], row 0 CLS
  float* e_s = v_s + static_cast<size_t>(f1) * dp;  // [H][F][F + 1]
  float* s_s = e_s + static_cast<size_t>(H) * F * f1;  // [H][F] row sums

  const int b = blockIdx.x / N, j = blockIdx.x % N;

  for (int t = threadIdx.x; t < F * D; t += blockDim.x) {
    const int g = t / D, c = t % D;
    const size_t src = (static_cast<size_t>(b * F + g) * N + j) * D + c;
    q_s[g * dp + c] = Cvt<T>::to_f(q[src]) * scale;
    k_s[(g + 1) * dp + c] = Cvt<T>::to_f(k[src]);
    v_s[(g + 1) * dp + c] = Cvt<T>::to_f(v[src]);
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    k_s[c] = Cvt<T>::to_f(cls_k[static_cast<size_t>(b) * D + c]);
    v_s[c] = Cvt<T>::to_f(cls_v[static_cast<size_t>(b) * D + c]);
  }
  __syncthreads();

  // logits: t = (h * F + fi) * (F + 1) + key
  for (int t = threadIdx.x; t < H * F * f1; t += blockDim.x) {
    const int key = t % f1, row = t / f1;
    const int fi = row % F, h = row / F;
    const float* qr = q_s + fi * dp + h * hd;
    const float* kr = k_s + key * dp + h * hd;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
    e_s[t] = s;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < H * F; r += blockDim.x) {
    float* er = e_s + r * f1;
    float m = -INFINITY;
    for (int key = 0; key < f1; ++key) m = fmaxf(m, er[key]);
    float sum = 0.f;
    for (int key = 0; key < f1; ++key) {
      const float e = expf(er[key] - m);
      er[key] = e;
      sum += e;
    }
    s_s[r] = sum;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < F * D; t += blockDim.x) {
    const int fi = t / D, c = t % D;
    const int r = (c / hd) * F + fi;
    const float* er = e_s + r * f1;
    float acc = 0.f;
    for (int key = 0; key < f1; ++key) acc = fmaf(er[key], v_s[key * dp + c], acc);
    out[(static_cast<size_t>(b * F + fi) * N + j) * D + c] = Cvt<T>::from_f(acc / s_s[r]);
  }
}

template <typename T>
int launch_time(const void* q, const void* k, const void* v, const void* ck,
                const void* cv, void* out, int B, int F, int N, int D, int H, float scale,
                int device, cudaStream_t stream) {
  const size_t smem = time_smem_bytes(F, D, H);
  int threads = 0;
  cudaError_t err = threads_for_smem(smem, device, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(time_attention_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * N);
  time_attention_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<T*>(out), F, N, D,
      H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_time_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* cls_k, const void* cls_v, void* out,
                                         int B, int F, int N, int D, int H, float scale,
                                         int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_time<__nv_bfloat16>(q, k, v, cls_k, cls_v, out, B, F, N, D, H,
                                              scale, device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_time<float>(q, k, v, cls_k, cls_v, out, B, F, N, D, H, scale,
                                      device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The CTA size a launch at (F, D, H) on `device` takes, written to
// `threads`; returns a cudaError_t code (the launch's refusal, if any).
extern "C" int egovlp_time_attention_fwd_threads(int F, int D, int H, int device,
                                                 int* threads) {
  return static_cast<int>(
      egovlp::threads_for_smem(egovlp::time_smem_bytes(F, D, H), device, threads));
}

// Message of a cudaError_t code, for the wrappers' exceptions.
extern "C" const char* egovlp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
