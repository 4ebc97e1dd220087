// Head-split time attention backward (K5-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_time_bwd_kernel,
// launched by _time_bwd_call (the backward of the time_attention
// custom_vjp).
//
// What it computes: q, k, v, do, dq, dk, dv are [BH, F, N, hd] (heads
// already split, q already scaled); cls_k, cls_v are [BH, 1, hd].  For each
// (bh, patch column j), with K = [cls_k[bh]; k[bh, :, j]] and
// V = [cls_v[bh]; v[bh, :, j]] (F + 1 rows):
//
//   p  = softmax(q K^T) = e / rowsum,  dp = do V^T,
//   dl = p * (dp - rowsum(dp * p)),
//   dq = dl K,  dK = dl^T q,  dV = p^T do
//
// As in the Pallas body every value is widened to float32 on load and the
// math stays float32 up to one cast per output.  dq and the F frame rows of
// dK and dV are written in the input dtype.  The Pallas body sums the CLS
// rows of dK and dV over all F x N queries of a bh (:242-243); here the
// kernel writes float32 shares of them to scratch, which the wrapper sums
// and casts once: deterministic, no atomics.
//
// What bounds it on an H100: device memory.  Each element of q, k, v and do
// takes part in only F + 1 multiply-adds per product; the kernel has to
// read those four and write dq, dk, dv once, with coalesced accesses.
//
// Design: two bodies, picked as for K5-fwd (cuda_attention.py,
// time_hs_body).
//  - kStreamBody: the 16-byte streaming body of time_attention_stream.cuh
//    (bwd_kernel, K5's layout), which K2-bwd shares.  A warp takes one
//    block of 32 / P adjacent patch columns of one bh (4 columns of hd 64
//    at bf16): p, dl and dq's 16-byte slices per query, p and dl kept in a
//    per-warp shared table, then dK and dV a key at a time.  The warp sums
//    its columns' CLS grads over its column groups with xor shuffles, and
//    one lane a slice writes the block's share to scratch
//    [BH, ceil(N / (32 / P)), hd].  (K2's warps walk runs of 4 columns in
//    turn; one block a warp puts more warps in flight, and the scratch is
//    still 1/32 of the bytes the kernel moves at hd 64.)
//    Shapes as K5-fwd's streaming body.  K5 takes q already scaled and gives dq = dl K, so the
//    body runs at scale 1, where K2's products with the scale are exact.
//  - kScalarBody, for the other shapes: as K5-fwd's scalar body, one CTA
//    per (bh, block of NB patch columns), NB as many as fit in a 64 KB
//    budget (columns_for_smem: 15 at F 4, 3 at F 16, hd 64), because the
//    Pallas program's whole [F, N, hd] slab per bh does not fit in a CTA.
//    A frame's rows of the block are NB x hd contiguous elements: the CTA
//    stages q, do, k and v as float32 with coalesced loads (rows padded by
//    one float), the CLS key and value once.  Threads then take (column,
//    query, key) logit and dp entries, (column, query) softmax rows, and
//    (frame, column, channel) outputs in turn: frame g's dq row and its dK
//    and dV rows (sums over the F query frames of the column); the stores
//    are contiguous per frame again.  Each column's share of the CLS grads
//    goes to scratch [BH, N, hd].  The CTA size follows from its shared
//    memory (threads_for_smem).

#include <math.h>

#include "common.cuh"
#include "time_attention_stream.cuh"

namespace egovlp {
namespace {

// floats of one column: q, do, k, v rows (F each, padded), its p and dl
// [F][F + 1]; and of the CLS key and value
inline size_t time_hs_bwd_column_bytes(int F, int hd) {
  const size_t f = static_cast<size_t>(F);
  return (4 * f * (hd + 1) + 2 * f * (f + 1)) * sizeof(float);
}

inline size_t time_hs_bwd_fixed_bytes(int hd) {
  return 2 * static_cast<size_t>(hd) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
time_attention_hs_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ cls_k,
                             const T* __restrict__ cls_v, const T* __restrict__ dout,
                             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ dcls_k, float* __restrict__ dcls_v, int F,
                             int N, int hd, int NB) {
  extern __shared__ __align__(16) float tsm[];
  const int hdp = hd + 1;
  const int f1 = F + 1;
  const size_t rows = static_cast<size_t>(F) * NB * hdp;
  const size_t probs = static_cast<size_t>(NB) * F * f1;
  float* q_s = tsm;           // [F][NB][hdp]
  float* do_s = q_s + rows;   // [F][NB][hdp]
  float* k_s = do_s + rows;   // [F][NB][hdp]
  float* v_s = k_s + rows;    // [F][NB][hdp]
  float* ck_s = v_s + rows;   // [hd]
  float* cv_s = ck_s + hd;    // [hd]
  float* p_s = cv_s + hd;     // [NB][F][F + 1] logits, then p
  float* dl_s = p_s + probs;  // [NB][F][F + 1] dp, then dl

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
    do_s[dst] = Cvt<T>::to_f(dout[src]);
    k_s[dst] = Cvt<T>::to_f(k[src]);
    v_s[dst] = Cvt<T>::to_f(v[src]);
  }
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    ck_s[d] = Cvt<T>::to_f(cls_k[static_cast<size_t>(bh) * hd + d]);
    cv_s[d] = Cvt<T>::to_f(cls_v[static_cast<size_t>(bh) * hd + d]);
  }
  __syncthreads();

  // logits and dp: t = (c * F + fi) * (F + 1) + key; key 0 is the CLS token
  for (int t = threadIdx.x; t < nb * F * f1; t += blockDim.x) {
    const int key = t % f1, row = t / f1;
    const int fi = row % F, c = row / F;
    const float* qr = q_s + (fi * NB + c) * hdp;
    const float* gr = do_s + (fi * NB + c) * hdp;
    const float* kr = key == 0 ? ck_s : k_s + ((key - 1) * NB + c) * hdp;
    const float* vr = key == 0 ? cv_s : v_s + ((key - 1) * NB + c) * hdp;
    float s = 0.f, g = 0.f;
    for (int d = 0; d < hd; ++d) {
      s = fmaf(qr[d], kr[d], s);
      g = fmaf(gr[d], vr[d], g);
    }
    p_s[t] = s;
    dl_s[t] = g;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < nb * F; r += blockDim.x) {
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

  // frame g of column c: its dq row (query g), and its dK / dV rows (key
  // g + 1, summed over the column's F query frames)
  for (int t = threadIdx.x; t < F * row_len; t += blockDim.x) {
    const int g = t / row_len, r = t % row_len;
    const int c = r / hd, d = r % hd;
    const float* dr = dl_s + (c * F + g) * f1;
    float acc = dr[0] * ck_s[d];
    for (int key = 1; key < f1; ++key)
      acc = fmaf(dr[key], k_s[((key - 1) * NB + c) * hdp + d], acc);
    float ak = 0.f, av = 0.f;
    for (int fi = 0; fi < F; ++fi) {
      const int e = (c * F + fi) * f1 + g + 1;
      const int x = (fi * NB + c) * hdp + d;
      ak = fmaf(dl_s[e], q_s[x], ak);
      av = fmaf(p_s[e], do_s[x], av);
    }
    const size_t dst = bh_off + g * frame_stride + r;
    dq[dst] = Cvt<T>::from_f(acc);
    dk[dst] = Cvt<T>::from_f(ak);
    dv[dst] = Cvt<T>::from_f(av);
  }
  // each column's share of the CLS grads (key 0), float32
  for (int t = threadIdx.x; t < row_len; t += blockDim.x) {
    const int c = t / hd, d = t % hd;
    float ak = 0.f, av = 0.f;
    for (int fi = 0; fi < F; ++fi) {
      const int e = (c * F + fi) * f1;
      const int x = (fi * NB + c) * hdp + d;
      ak = fmaf(dl_s[e], q_s[x], ak);
      av = fmaf(p_s[e], do_s[x], av);
    }
    const size_t dst = (static_cast<size_t>(bh) * N + j0) * hd + t;
    dcls_k[dst] = ak;
    dcls_v[dst] = av;
  }
}

template <typename T>
int launch_time_hs_bwd(const void* q, const void* k, const void* v, const void* ck,
                       const void* cv, const void* dout, void* dq, void* dk, void* dv,
                       void* dck, void* dcv, int BH, int F, int N, int hd, int device,
                       cudaStream_t stream) {
  const int NB =
      columns_for_smem(time_hs_bwd_column_bytes(F, hd), time_hs_bwd_fixed_bytes(hd), N);
  const size_t smem = time_hs_bwd_fixed_bytes(hd) + NB * time_hs_bwd_column_bytes(F, hd);
  int threads = 0;
  cudaError_t err = threads_for_smem(smem, device, &threads);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(time_attention_hs_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH) * ((N + NB - 1) / NB));
  time_attention_hs_bwd_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dck), static_cast<float*>(dcv), F, N, hd, NB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches `body` (kStreamBody or kScalarBody) on `stream` of device
// `device`; returns a cudaError_t code.  dcls_k, dcls_v: float32 scratch,
// the CLS grads' shares: [BH, ceil(N / (32 / P)), hd], one row a block of
// 32 / P patch columns of the streaming body (P = k2::lanes_per_head(hd,
// 16-byte slice's channels)), or [BH, N, hd], one row a patch column of the
// scalar body.
extern "C" int egovlp_time_attention_hs_bwd(const void* q, const void* k, const void* v,
                                            const void* cls_k, const void* cls_v,
                                            const void* dout, void* dq, void* dk, void* dv,
                                            void* dcls_k, void* dcls_v, int BH, int F, int N,
                                            int hd, int body, int dtype, int device,
                                            void* stream) {
  const cudaError_t err = egovlp::k2::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using egovlp::k2::launch_bwd;
  if (body == egovlp::kStreamBody) {  // q comes scaled: scale 1
    if (dtype == egovlp::kBFloat16)
      return launch_bwd<__nv_bfloat16, true>(q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k,
                                             dcls_v, BH, F, N, hd, 1, 1.0f, s);
    if (dtype == egovlp::kFloat32)
      return launch_bwd<float, true>(q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k, dcls_v,
                                     BH, F, N, hd, 1, 1.0f, s);
  } else if (body == egovlp::kScalarBody) {
    if (dtype == egovlp::kBFloat16)
      return egovlp::launch_time_hs_bwd<__nv_bfloat16>(q, k, v, cls_k, cls_v, dout, dq, dk,
                                                       dv, dcls_k, dcls_v, BH, F, N, hd,
                                                       device, s);
    if (dtype == egovlp::kFloat32)
      return egovlp::launch_time_hs_bwd<float>(q, k, v, cls_k, cls_v, dout, dq, dk, dv,
                                               dcls_k, dcls_v, BH, F, N, hd, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the streaming
// instantiation a launch with F frames at `dtype` takes, and the shared
// memory a CTA of it takes at hd 64; returns a cudaError_t code.
extern "C" int egovlp_time_attention_hs_bwd_attributes(int F, int dtype, int* regs,
                                                       int* local_bytes, int* smem) {
  return egovlp::k2::attributes<true, true>(F, dtype, regs, local_bytes, smem);
}
