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
// What bounds it on an H100: device memory.  Each query meets F + 1 keys,
// so the work is ~2.5 FLOP a byte, far below the ~295 at which the tensor
// cores would be the limit: the kernel's only job is to read q, k, v and
// write out once at the card's memory rate.
//
// Design: a 16-byte streaming body (time_attention_stream.cuh).  One warp
// takes one patch column of one b and a slice of 32 / P heads (4 heads of
// hd 64 at bf16); each lane owns one 16-byte slice of every row.  A lane
// issues its loads of the column's F + 1 key and value rows (and, up to 8
// frames, its F query rows) before the first use, and keeps them in
// registers as raw bits: no shared memory and no block barrier.  Per
// query it takes its partial dot products with the F + 1 keys, completes
// them with xor shuffles over its head group, runs the softmax in
// registers (every lane of the group holds the row), and writes its slice
// of the output row as one 16-byte store.  Past 8 frames the query rows
// are loaded one ahead of their use instead, which keeps the 16-frame
// instantiation within the register file.
//
// Shapes: F from 1 to 16 (instantiations hold 4, 8 or 16 frames), any N, hd
// a multiple of 8 (bf16) or 4 (float32) up to 32 lanes a head, 16-byte
// aligned tensors.  The launcher refuses any other shape (the wrapper
// raises); there is no other body.

#include <math.h>

#include "common.cuh"
#include "time_attention_stream.cuh"

namespace egovlp {
namespace {

using k2::kWarps;
using k2::Slice;

template <typename T, int FC>
__global__ void __launch_bounds__(kWarps * 32)
time_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ cls_k,
                          const T* __restrict__ cls_v, T* __restrict__ out, int F, int N,
                          int D, int H, int P, int slices, long long warps, float scale) {
  constexpr int kN = Slice<T>::kN;
  constexpr bool kHoldQ = FC <= 8;  // all query rows in registers
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (warp >= warps) return;
  const int s = static_cast<int>(warp % slices);
  const long long col = warp / slices;  // b * N + j
  const int b = static_cast<int>(col / N), j = static_cast<int>(col % N);
  const k2::Lane ln(s, P, H, D / H, kN);
  const size_t frame = static_cast<size_t>(N) * D;  // stride of one frame row
  const size_t row0 = (static_cast<size_t>(b) * F * N + j) * D + ln.c;

  uint4 kr[FC + 1], vr[FC + 1], qr[kHoldQ ? FC : 1];
  kr[0] = k2::load_if(ln.active, cls_k + static_cast<size_t>(b) * D + ln.c);
  vr[0] = k2::load_if(ln.active, cls_v + static_cast<size_t>(b) * D + ln.c);
#pragma unroll
  for (int f = 0; f < FC; ++f) {
    const bool in = ln.active && f < F;
    kr[f + 1] = k2::load_if(in, k + row0 + f * frame);
    vr[f + 1] = k2::load_if(in, v + row0 + f * frame);
    if (kHoldQ) qr[f] = k2::load_if(in, q + row0 + f * frame);
  }

  // one query row: logits, softmax and the output slice
  auto query = [&](int fi, const uint4& qv) {
    float qf[kN];
    Slice<T>::to_f(qv, qf, fi);
#pragma unroll
    for (int i = 0; i < kN; ++i) qf[i] *= scale;
    float e[FC + 1];
#pragma unroll
    for (int key = 0; key <= FC; ++key) {
      float kf[kN];
      Slice<T>::to_f(kr[key], kf, fi);
      e[key] = k2::dot<kN>(qf, kf);  // 0 past F
    }
    k2::group_sums<FC + 1>(e, P);
    float m = -INFINITY;
#pragma unroll
    for (int key = 0; key <= FC; ++key)
      if (key <= F) m = fmaxf(m, e[key]);
    float sum = 0.f;
    float acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.f;
#pragma unroll
    for (int key = 0; key <= FC; ++key) {
      if (key <= F) {
        const float p = expf(e[key] - m);
        sum += p;
        float vf[kN];
        Slice<T>::to_f(vr[key], vf, fi);
#pragma unroll
        for (int i = 0; i < kN; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] /= sum;
    if (ln.active) k2::store(out + row0 + fi * frame, Slice<T>::from_f(acc));
  };

  if constexpr (kHoldQ) {
#pragma unroll
    for (int fi = 0; fi < FC; ++fi)
      if (fi < F) query(fi, qr[fi]);
  } else {  // each query row loaded one ahead of its use
    qr[0] = k2::load_if(ln.active, q + row0);
#pragma unroll 1
    for (int fi = 0; fi < F; ++fi) {
      const uint4 qv = qr[0];
      qr[0] = k2::load_if(ln.active && fi + 1 < F, q + row0 + (fi + 1) * frame);
      query(fi, qv);
    }
  }
}

template <typename T, int FC>
int launch_fc(const void* q, const void* k, const void* v, const void* ck, const void* cv,
              void* out, int B, int F, int N, int D, int H, float scale, cudaStream_t stream) {
  const int P = k2::lanes_per_head(D / H, Slice<T>::kN);
  const int slices = (H + 32 / P - 1) / (32 / P);
  const long long warps = static_cast<long long>(B) * N * slices;
  if (warps == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  time_attention_fwd_kernel<T, FC><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<T*>(out), F, N, D, H,
      P, slices, warps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_time(const void* q, const void* k, const void* v, const void* ck,
                const void* cv, void* out, int B, int F, int N, int D, int H, float scale,
                cudaStream_t stream) {
  if (H <= 0 || D % H != 0 || !k2::takes(F, D / H, Slice<T>::kN) ||
      !(k2::aligned16(q) && k2::aligned16(k) && k2::aligned16(v) && k2::aligned16(ck) &&
        k2::aligned16(cv) && k2::aligned16(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (F <= 4) return launch_fc<T, 4>(q, k, v, ck, cv, out, B, F, N, D, H, scale, stream);
  if (F <= 8) return launch_fc<T, 8>(q, k, v, ck, cv, out, B, F, N, D, H, scale, stream);
  return launch_fc<T, 16>(q, k, v, ck, cv, out, B, F, N, D, H, scale, stream);
}

template <typename T>
cudaError_t fwd_attributes(int F, cudaFuncAttributes* attr) {
  if (F <= 4) return cudaFuncGetAttributes(attr, time_attention_fwd_kernel<T, 4>);
  if (F <= 8) return cudaFuncGetAttributes(attr, time_attention_fwd_kernel<T, 8>);
  return cudaFuncGetAttributes(attr, time_attention_fwd_kernel<T, 16>);
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_time_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* cls_k, const void* cls_v, void* out,
                                         int B, int F, int N, int D, int H, float scale,
                                         int dtype, int device, void* stream) {
  const cudaError_t err = egovlp::k2::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_time<__nv_bfloat16>(q, k, v, cls_k, cls_v, out, B, F, N, D, H,
                                              scale, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_time<float>(q, k, v, cls_k, cls_v, out, B, F, N, D, H, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the instantiation a
// launch with F frames at `dtype` takes (`smem`: 0, it uses none); returns a
// cudaError_t code.
extern "C" int egovlp_time_attention_fwd_attributes(int F, int dtype, int* regs,
                                                    int* local_bytes, int* smem) {
  if (F < 1 || F > egovlp::k2::kFrameCap) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err;
  if (dtype == egovlp::kBFloat16)
    err = egovlp::fwd_attributes<__nv_bfloat16>(F, &attr);
  else if (dtype == egovlp::kFloat32)
    err = egovlp::fwd_attributes<float>(F, &attr);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}

// Message of a cudaError_t code, for the wrappers' exceptions.
extern "C" const char* egovlp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
