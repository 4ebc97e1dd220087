// Time attention backward (K2-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_mk_time_bwd_bsd_v2,
// which runs _mk_time_bwd_bsd_v3(force_batched=True) at f <= 8, launched by
// _time_bwd_bsd_call.
//
// What it computes: q, k, v, do, dq, dk, dv are [B, F, N, D] (F frames of N
// patch columns, D = H * hd, heads sliced from D by stride); cls_k, cls_v
// are [B, 1, D].  For each (b, patch column j, head h), with qa = q * scale,
// K = [cls_k; k[b, :, j]] and V = [cls_v; v[b, :, j]] (F + 1 rows):
//
//   p  = softmax(qa K^T),  dp = do V^T,  dl = p * (dp - rowsum(dp * p))
//   dq = dl K * scale,     dK = dl^T qa, dV = p^T do
//
// As in the Pallas body every value is widened to float32 on load and the
// math stays float32 up to one cast per output.  dq and the F frame rows of
// dK and dV are written in the input dtype; the CLS rows, this column's
// share of the CLS gradients, go to float32 scratch [B, N, D] that the
// wrapper sums over the N columns and casts once.  (The Pallas small-f body
// _time_bwd_small_f accumulates with += in the output dtype, rounding at
// every frame in bf16; this kernel and its plain twin round once.)
//
// What bounds it on an H100: device memory.  Each element of q, k, v and do
// takes part in only F + 1 multiply-adds per product; the kernel has to
// read those four and write dq, dk, dv once, with coalesced accesses.
//
// Design: one CTA per (b, patch column j), covering all H heads, as in the
// forward.  Each frame row of the column is a contiguous D-wide row in
// memory, so the CTA stages q (pre-scaled), do, [cls_k; k] and [cls_v; v]
// as whole float32 rows in shared memory with coalesced loads (rows padded
// by one float so threads on different rows hit different banks).  Threads
// then take (head, query, key) logit and dp entries, (head, query) softmax
// rows, and (frame, channel) outputs in turn; the stores are contiguous
// D-wide rows again.  Shared memory grows as (4F + 2)(D + 1) + 2 H F (F + 1)
// floats: 56 KB at F 4 and 224 KB at F 16 (D 768, 12 heads).
//
// Launch configuration (counterpart of the VMEM n-block probe,
// _time_kernel_compiles / time_n_block): the CTA's shared memory is checked
// against the device's opt-in limit, read once per device, and a shape
// above it is refused (the wrapper raises).  The CTA size follows from the
// same limits (threads_for_smem in common.cuh).

#include <math.h>

#include "common.cuh"

namespace egovlp {
namespace {

inline size_t time_bwd_smem_bytes(int F, int D, int H) {
  const size_t dp = static_cast<size_t>(D) + 1;
  const size_t f = static_cast<size_t>(F);
  return ((4 * f + 2) * dp + 2 * H * f * (f + 1)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
time_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ cls_k,
                          const T* __restrict__ cls_v, const T* __restrict__ dout,
                          T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dcls_k, float* __restrict__ dcls_v, int F,
                          int N, int D, int H, float scale) {
  extern __shared__ __align__(16) float tsm[];
  const int dp = D + 1;
  const int f1 = F + 1;
  const int hd = D / H;
  float* q_s = tsm;                                    // [F][dp], scaled
  float* do_s = q_s + static_cast<size_t>(F) * dp;     // [F][dp]
  float* k_s = do_s + static_cast<size_t>(F) * dp;     // [F + 1][dp], row 0 CLS
  float* v_s = k_s + static_cast<size_t>(f1) * dp;     // [F + 1][dp], row 0 CLS
  float* p_s = v_s + static_cast<size_t>(f1) * dp;     // [H][F][F + 1] logits, then p
  float* dl_s = p_s + static_cast<size_t>(H) * F * f1;  // [H][F][F + 1] dp, then dl

  const int b = blockIdx.x / N, j = blockIdx.x % N;

  for (int t = threadIdx.x; t < F * D; t += blockDim.x) {
    const int g = t / D, c = t % D;
    const size_t src = (static_cast<size_t>(b * F + g) * N + j) * D + c;
    q_s[g * dp + c] = Cvt<T>::to_f(q[src]) * scale;
    do_s[g * dp + c] = Cvt<T>::to_f(dout[src]);
    k_s[(g + 1) * dp + c] = Cvt<T>::to_f(k[src]);
    v_s[(g + 1) * dp + c] = Cvt<T>::to_f(v[src]);
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    k_s[c] = Cvt<T>::to_f(cls_k[static_cast<size_t>(b) * D + c]);
    v_s[c] = Cvt<T>::to_f(cls_v[static_cast<size_t>(b) * D + c]);
  }
  __syncthreads();

  // logits and dp: t = (h * F + fi) * (F + 1) + key
  for (int t = threadIdx.x; t < H * F * f1; t += blockDim.x) {
    const int key = t % f1, row = t / f1;
    const int fi = row % F, h = row / F;
    const float* qr = q_s + fi * dp + h * hd;
    const float* gr = do_s + fi * dp + h * hd;
    const float* kr = k_s + key * dp + h * hd;
    const float* vr = v_s + key * dp + h * hd;
    float s = 0.f, g = 0.f;
    for (int d = 0; d < hd; ++d) {
      s = fmaf(qr[d], kr[d], s);
      g = fmaf(gr[d], vr[d], g);
    }
    p_s[t] = s;
    dl_s[t] = g;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < H * F; r += blockDim.x) {
    float* pr = p_s + r * f1;
    float* dr = dl_s + r * f1;
    float m = -INFINITY;
    for (int key = 0; key < f1; ++key) m = fmaxf(m, pr[key]);
    float sum = 0.f;
    for (int key = 0; key < f1; ++key) {
      const float e = expf(pr[key] - m);
      pr[key] = e;
      sum += e;
    }
    float inner = 0.f;
    for (int key = 0; key < f1; ++key) {
      const float p = pr[key] / sum;
      pr[key] = p;
      inner = fmaf(dr[key], p, inner);
    }
    for (int key = 0; key < f1; ++key) dr[key] = pr[key] * (dr[key] - inner);
  }
  __syncthreads();

  // dq rows, then the column's dK / dV rows for its F frame keys
  for (int t = threadIdx.x; t < F * D; t += blockDim.x) {
    const int g = t / D, c = t % D;
    const int h = c / hd;
    const float* dr = dl_s + (h * F + g) * f1;
    float acc = 0.f;
    for (int key = 0; key < f1; ++key) acc = fmaf(dr[key], k_s[key * dp + c], acc);
    float ak = 0.f, av = 0.f;
    for (int fi = 0; fi < F; ++fi) {
      const int e = (h * F + fi) * f1 + g + 1;
      ak = fmaf(dl_s[e], q_s[fi * dp + c], ak);
      av = fmaf(p_s[e], do_s[fi * dp + c], av);
    }
    const size_t dst = (static_cast<size_t>(b * F + g) * N + j) * D + c;
    dq[dst] = Cvt<T>::from_f(acc * scale);
    dk[dst] = Cvt<T>::from_f(ak);
    dv[dst] = Cvt<T>::from_f(av);
  }
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    const int h = c / hd;
    float ak = 0.f, av = 0.f;
    for (int fi = 0; fi < F; ++fi) {
      const int e = (h * F + fi) * f1;
      ak = fmaf(dl_s[e], q_s[fi * dp + c], ak);
      av = fmaf(p_s[e], do_s[fi * dp + c], av);
    }
    const size_t dst = (static_cast<size_t>(b) * N + j) * D + c;
    dcls_k[dst] = ak;
    dcls_v[dst] = av;
  }
}

template <typename T>
int launch_time_bwd(const void* q, const void* k, const void* v, const void* ck,
                    const void* cv, const void* dout, void* dq, void* dk, void* dv, void* dck,
                    void* dcv, int B, int F, int N, int D, int H, float scale, int device,
                    cudaStream_t stream) {
  const size_t smem = time_bwd_smem_bytes(F, D, H);
  int threads = 0;
  cudaError_t err = threads_for_smem(smem, device, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(time_attention_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * N);
  time_attention_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dck), static_cast<float*>(dcv), F, N, D, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
// dcls_k, dcls_v: float32 [B, N, D], each patch column's share of the CLS
// grads.
extern "C" int egovlp_time_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* cls_k, const void* cls_v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* dcls_k, void* dcls_v, int B, int F, int N,
                                         int D, int H, float scale, int dtype, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_time_bwd<__nv_bfloat16>(q, k, v, cls_k, cls_v, dout, dq, dk, dv,
                                                  dcls_k, dcls_v, B, F, N, D, H, scale,
                                                  device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_time_bwd<float>(q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k,
                                          dcls_v, B, F, N, D, H, scale, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
