// Head-split time attention forward (K5-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_time_fwd_kernel,
// launched by _time_fwd_call (the forward of the time_attention custom_vjp).
//
// What it computes: q, k, v, out are [BH, F, N, hd] (heads already split, q
// already scaled, the natural frame-major layout); cls_k, cls_v are
// [BH, 1, hd].  For each (bh, patch column j) the F frame queries of that
// column attend over the F + 1 keys [cls_k[bh]; k[bh, :, j]] and return the
// softmax-weighted sum of [cls_v[bh]; v[bh, :, j]].  As in the Pallas body,
// every value is widened to float32 on load; logits, softmax (p = e /
// rowsum) and the P.V sum stay float32 up to the one cast of the output.
//
// What bounds it on an H100: device memory.  The groups are tiny (F 4 to 16
// frames), so each element of q, k and v takes part in only F + 1
// multiply-adds per product; the kernel has to read q, k, v and write out
// once, with coalesced accesses.
//
// Design: two bodies; the wrapper picks one by shape, dtype and alignment
// before the launch (cuda_attention.py, time_hs_body) and passes it here.
//  - kStreamBody: the 16-byte streaming body of time_attention_stream.cuh
//    (fwd_kernel, K5's layout), which K2 shares.  For one bh and one frame
//    the rows of consecutive patch columns are contiguous hd-wide rows, so
//    a warp takes 32 / P adjacent columns (P lanes of 16 bytes a row: 4
//    columns of hd 64 at bf16, 512 contiguous bytes a row), holds their
//    key, value (and, up to 8 frames, query) rows in registers, runs each
//    softmax in registers after xor shuffles over the column's P lanes,
//    and stores each output slice as one 16-byte store.  All columns read
//    the one CLS row.  It takes F from 1 to 16, hd a multiple of 8 (bf16)
//    or 4 (float32) up to 32 slices, and 16-byte aligned tensors, and
//    refuses the rest.
//  - kScalarBody, for the shapes outside that set: the Pallas program owns
//    the whole [F, N, hd] slab of one bh (~800 KB of float32 per tensor at
//    F 16, N 196, hd 64), far over the 227 KB a CTA can use.  The patch
//    column is the independent unit, so the columns are split across CTAs:
//    one CTA per (bh, block of NB columns), NB as many as fit in a 64 KB
//    budget (columns_for_smem in common.cuh: 20 at F 4, 4 at F 16, hd 64).
//    A frame's rows of the block are NB x hd contiguous elements, so the
//    CTA stages q, k and v as float32 with coalesced loads (rows padded by
//    one float so threads on different rows hit different banks), with the
//    CLS key and value once.  Threads then take (column, query, key)
//    logits, (column, query) softmax rows and (frame, column, channel)
//    outputs in turn; the stores are contiguous per frame again.  The last
//    block's ragged edge is bounded by its own column count.  The CTA size
//    follows from its shared memory (threads_for_smem).  It refuses a
//    shape whose one column passes the opt-in shared memory.

#include <math.h>

#include "common.cuh"
#include "time_attention_stream.cuh"

namespace egovlp {
namespace {

// floats of one column: q, k, v rows (F each, padded) and its F x (F + 1)
// probabilities; and of the CLS key and value
inline size_t time_hs_column_bytes(int F, int hd) {
  const size_t f = static_cast<size_t>(F);
  return (3 * f * (hd + 1) + f * (f + 1)) * sizeof(float);
}

inline size_t time_hs_fixed_bytes(int hd) { return 2 * static_cast<size_t>(hd) * sizeof(float); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
time_attention_hs_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ cls_k,
                             const T* __restrict__ cls_v, T* __restrict__ out, int F, int N,
                             int hd, int NB) {
  extern __shared__ __align__(16) float tsm[];
  const int hdp = hd + 1;
  const int f1 = F + 1;
  const size_t rows = static_cast<size_t>(F) * NB * hdp;
  float* q_s = tsm;          // [F][NB][hdp]
  float* k_s = q_s + rows;   // [F][NB][hdp]
  float* v_s = k_s + rows;   // [F][NB][hdp]
  float* ck_s = v_s + rows;  // [hd]
  float* cv_s = ck_s + hd;   // [hd]
  float* p_s = cv_s + hd;    // [NB][F][F + 1] logits, then p

  const int nblk = (N + NB - 1) / NB;
  const int bh = blockIdx.x / nblk;
  const int j0 = (blockIdx.x % nblk) * NB;
  const int nb = min(NB, N - j0);  // this CTA's columns
  const int row_len = nb * hd;     // one frame's contiguous elements
  // element (g, j0 + c, d) of a [BH, F, N, hd] tensor is at frame_off(g) + c * hd + d
  const size_t bh_off = static_cast<size_t>(bh) * F * N * hd + static_cast<size_t>(j0) * hd;
  const size_t frame_stride = static_cast<size_t>(N) * hd;

  for (int t = threadIdx.x; t < F * row_len; t += blockDim.x) {
    const int g = t / row_len, r = t % row_len;
    const int c = r / hd, d = r % hd;
    const size_t src = bh_off + g * frame_stride + r;
    const int dst = (g * NB + c) * hdp + d;
    q_s[dst] = Cvt<T>::to_f(q[src]);
    k_s[dst] = Cvt<T>::to_f(k[src]);
    v_s[dst] = Cvt<T>::to_f(v[src]);
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    ck_s[d] = Cvt<T>::to_f(cls_k[static_cast<size_t>(bh) * hd + d]);
    cv_s[d] = Cvt<T>::to_f(cls_v[static_cast<size_t>(bh) * hd + d]);
  }
  __syncthreads();

  // logits: t = (c * F + fi) * (F + 1) + key; key 0 is the CLS token
  for (int t = threadIdx.x; t < nb * F * f1; t += blockDim.x) {
    const int key = t % f1, row = t / f1;
    const int fi = row % F, c = row / F;
    const float* qr = q_s + (fi * NB + c) * hdp;
    const float* kr = key == 0 ? ck_s : k_s + ((key - 1) * NB + c) * hdp;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
    p_s[t] = s;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < nb * F; r += blockDim.x) {
    float* pr = p_s + r * f1;
    float m = -INFINITY;
    for (int key = 0; key < f1; ++key) m = fmaxf(m, pr[key]);
    float sum = 0.f;
    for (int key = 0; key < f1; ++key) {
      const float e = expf(pr[key] - m);
      pr[key] = e;
      sum += e;
    }
    for (int key = 0; key < f1; ++key) pr[key] = pr[key] / sum;
  }
  __syncthreads();

  // out[fi] = p_0 cv + sum_g p_{g+1} v[g], in the Pallas body's order
  for (int t = threadIdx.x; t < F * row_len; t += blockDim.x) {
    const int fi = t / row_len, r = t % row_len;
    const int c = r / hd, d = r % hd;
    const float* pr = p_s + (c * F + fi) * f1;
    float acc = pr[0] * cv_s[d];
    for (int g = 0; g < F; ++g) acc = fmaf(pr[g + 1], v_s[(g * NB + c) * hdp + d], acc);
    out[bh_off + fi * frame_stride + r] = Cvt<T>::from_f(acc);
  }
}

template <typename T>
int launch_time_hs(const void* q, const void* k, const void* v, const void* ck,
                   const void* cv, void* out, int BH, int F, int N, int hd, int device,
                   cudaStream_t stream) {
  const int NB = columns_for_smem(time_hs_column_bytes(F, hd), time_hs_fixed_bytes(hd), N);
  const size_t smem = time_hs_fixed_bytes(hd) + NB * time_hs_column_bytes(F, hd);
  int threads = 0;
  cudaError_t err = threads_for_smem(smem, device, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(time_attention_hs_fwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH) * ((N + NB - 1) / NB));
  time_attention_hs_fwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<T*>(out), F, N, hd,
      NB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches `body` (kStreamBody or kScalarBody) on `stream` of device
// `device`; returns a cudaError_t code.
extern "C" int egovlp_time_attention_hs_fwd(const void* q, const void* k, const void* v,
                                            const void* cls_k, const void* cls_v, void* out,
                                            int BH, int F, int N, int hd, int body, int dtype,
                                            int device, void* stream) {
  const cudaError_t err = egovlp::k2::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using egovlp::k2::launch_fwd;
  if (body == egovlp::kStreamBody) {  // q comes scaled: scale 1
    if (dtype == egovlp::kBFloat16)
      return launch_fwd<__nv_bfloat16, true>(q, k, v, cls_k, cls_v, out, BH, F, N, hd, 1, 1.0f,
                                             s);
    if (dtype == egovlp::kFloat32)
      return launch_fwd<float, true>(q, k, v, cls_k, cls_v, out, BH, F, N, hd, 1, 1.0f, s);
  } else if (body == egovlp::kScalarBody) {
    if (dtype == egovlp::kBFloat16)
      return egovlp::launch_time_hs<__nv_bfloat16>(q, k, v, cls_k, cls_v, out, BH, F, N, hd,
                                                   device, s);
    if (dtype == egovlp::kFloat32)
      return egovlp::launch_time_hs<float>(q, k, v, cls_k, cls_v, out, BH, F, N, hd, device,
                                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the streaming
// instantiation a launch with F frames at `dtype` takes (`smem`: 0, it uses
// none); returns a cudaError_t code.
extern "C" int egovlp_time_attention_hs_fwd_attributes(int F, int dtype, int* regs,
                                                       int* local_bytes, int* smem) {
  return egovlp::k2::attributes<true, false>(F, dtype, regs, local_bytes, smem);
}
