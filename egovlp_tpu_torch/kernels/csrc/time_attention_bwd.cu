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
// dK and dV are written in the input dtype; the CLS rows, summed over a run
// of kRun consecutive patch columns in float32, go to float32 scratch
// [B, ceil(N / kRun), D] that the wrapper sums over the runs and casts
// once.  (The Pallas wrapper rounds each n-block's share to the output
// dtype before its sum; this kernel and its plain twin round once.)
//
// What bounds it on an H100: device memory.  Each query meets F + 1 keys:
// ~2.5 FLOP a byte.  The kernel has to read q, k, v, do and write dq, dk,
// dv once at the card's memory rate.
//
// Design: the 16-byte streaming body of time_attention_stream.cuh, as in
// the forward.  One warp walks a run of kRun consecutive patch columns of
// one b, in a fixed order, for a slice of 32 / P heads; each lane owns one
// 16-byte slice of every row.  For each column:
//  1. a lane loads its slices of the F + 1 key and value rows (and, up to 4
//     frames, the F query and output-gradient rows) before their first
//     use, and keeps them in registers as raw bits;
//  2. per query, the partial logits and dp of its F + 1 keys, completed
//     with xor shuffles over its head group; the softmax, p and dl in
//     registers; dq's slice written as one 16-byte store; p and dl kept in
//     a small per-warp table in shared memory (F (F + 1) floats each a
//     head, the rows of a head group at an odd stride, so the groups read
//     it without bank conflicts);
//  3. per key, dK = sum over queries of dl qa and dV of p do, from the
//     table and the query and output-gradient rows (past 4 frames
//     reloaded here, from the cache, instead of held), written as 16-byte
//     stores; the CLS key's rows are added to the run's float32 sums.
// Only the warp itself reads its table (__syncwarp, no block barrier).  No
// atomics: every output element has one writer, and two launches give the
// same bits.
//
// Shapes: those of the forward (F from 1 to 16, any N, hd a multiple of 8
// at bf16 or 4 at float32, up to 32 lanes a head, 16-byte aligned tensors);
// the launcher refuses any other (the wrapper raises).

#include <math.h>

#include "common.cuh"
#include "time_attention_stream.cuh"

namespace egovlp {
namespace {

using k2::kWarps;
using k2::Slice;

// patch columns a warp walks; the wrapper's CLS scratch has ceil(N / kRun)
// rows a b (kernels/cuda_attention.py, TIME_BWD_RUN)
constexpr int kRun = 4;

// floats of one head's p (or dl) table: F (F + 1), made odd
__host__ __device__ inline int table_stride(int F) { return (F * (F + 1)) | 1; }

inline size_t bwd_smem_bytes(int F, int P) {
  return static_cast<size_t>(kWarps) * 2 * (32 / P) * table_stride(F) * sizeof(float);
}

template <typename T, int FC>
__global__ void __launch_bounds__(kWarps * 32)
time_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ cls_k,
                          const T* __restrict__ cls_v, const T* __restrict__ dout,
                          T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dcls_k, float* __restrict__ dcls_v, int F,
                          int N, int D, int H, int P, int slices, int runs, long long warps,
                          float scale) {
  extern __shared__ float tables[];
  constexpr int kN = Slice<T>::kN;
  constexpr bool kHold = FC <= 4;  // the query and do rows held from step 1
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (warp >= warps) return;
  const int s = static_cast<int>(warp % slices);
  const long long rest = warp / slices;  // b * runs + run
  const int run = static_cast<int>(rest % runs), b = static_cast<int>(rest / runs);
  const k2::Lane ln(s, P, H, D / H, kN);
  const int hpw = 32 / P;
  const int stride = table_stride(F);
  float* p_tab = tables + (threadIdx.x / 32) * 2 * hpw * stride + ln.g * stride;
  float* dl_tab = p_tab + hpw * stride;
  const size_t frame = static_cast<size_t>(N) * D;

  float cls_dk[kN], cls_dv[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) cls_dk[i] = cls_dv[i] = 0.f;
  const uint4 kc = k2::load_if(ln.active, cls_k + static_cast<size_t>(b) * D + ln.c);
  const uint4 vc = k2::load_if(ln.active, cls_v + static_cast<size_t>(b) * D + ln.c);

#pragma unroll 1
  for (int t = 0; t < kRun; ++t) {
    const int j = run * kRun + t;
    if (j >= N) break;
    const size_t row0 = (static_cast<size_t>(b) * F * N + j) * D + ln.c;

    // 1. the column's rows
    uint4 kr[FC + 1], vr[FC + 1], qr[FC], gr[FC];
    kr[0] = kc;
    vr[0] = vc;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      const bool in = ln.active && f < F;
      kr[f + 1] = k2::load_if(in, k + row0 + f * frame);
      vr[f + 1] = k2::load_if(in, v + row0 + f * frame);
      if (kHold) {
        qr[f] = k2::load_if(in, q + row0 + f * frame);
        gr[f] = k2::load_if(in, dout + row0 + f * frame);
      }
    }

    // 2. per query: p, dl, dq
    auto query = [&](int fi, const uint4& qv, const uint4& gv) {
      float qf[kN], gf[kN];
      Slice<T>::to_f(qv, qf, fi);
      Slice<T>::to_f(gv, gf, fi);
#pragma unroll
      for (int i = 0; i < kN; ++i) qf[i] *= scale;
      float sums[2 * (FC + 1)];  // the logits, then dp; 0 past F
      float* lg = sums;
      float* dp = sums + FC + 1;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        float kf[kN], vf[kN];
        Slice<T>::to_f(kr[key], kf, 2 * fi);
        Slice<T>::to_f(vr[key], vf, 2 * fi);
        lg[key] = k2::dot<kN>(qf, kf);
        dp[key] = k2::dot<kN>(gf, vf);
      }
      k2::group_sums<2 * (FC + 1)>(sums, P);
      float m = -INFINITY;
#pragma unroll
      for (int key = 0; key <= FC; ++key)
        if (key <= F) m = fmaxf(m, lg[key]);
      float sum = 0.f;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          lg[key] = expf(lg[key] - m);
          sum += lg[key];
        }
      }
      float inner = 0.f;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          lg[key] = lg[key] / sum;  // p
          inner = fmaf(dp[key], lg[key], inner);
        }
      }
      float acc[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = 0.f;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          const float dl = lg[key] * (dp[key] - inner);
          float kf[kN];
          Slice<T>::to_f(kr[key], kf, 2 * fi + 1);
#pragma unroll
          for (int i = 0; i < kN; ++i) acc[i] = fmaf(dl, kf[i], acc[i]);
          if (ln.r == 0) {
            p_tab[fi * (F + 1) + key] = lg[key];
            dl_tab[fi * (F + 1) + key] = dl;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] *= scale;
      if (ln.active) k2::store(dq + row0 + fi * frame, Slice<T>::from_f(acc));
    };
    if constexpr (kHold) {
#pragma unroll
      for (int fi = 0; fi < FC; ++fi)
        if (fi < F) query(fi, qr[fi], gr[fi]);
    } else {  // each query's rows loaded one ahead of their use
      uint4 qn = k2::load_if(ln.active, q + row0);
      uint4 gn = k2::load_if(ln.active, dout + row0);
#pragma unroll 1
      for (int fi = 0; fi < F; ++fi) {
        const uint4 qv = qn, gv = gn;
        const bool next = ln.active && fi + 1 < F;
        qn = k2::load_if(next, q + row0 + (fi + 1) * frame);
        gn = k2::load_if(next, dout + row0 + (fi + 1) * frame);
        query(fi, qv, gv);
      }
    }
    __syncwarp();

    // 3. per key: dK and dV
    if (!kHold) {
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        const bool in = ln.active && f < F;
        qr[f] = k2::load_if(in, q + row0 + f * frame);
        gr[f] = k2::load_if(in, dout + row0 + f * frame);
      }
    }
#pragma unroll 1
    for (int key = 0; key <= F; ++key) {
      float ak[kN], av[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) ak[i] = av[i] = 0.f;
#pragma unroll
      for (int fi = 0; fi < FC; ++fi) {
        if (fi < F) {
          const float dl = dl_tab[fi * (F + 1) + key];
          const float p = p_tab[fi * (F + 1) + key];
          float qf[kN], gf[kN];
          Slice<T>::to_f(qr[fi], qf, key);
          Slice<T>::to_f(gr[fi], gf, key);
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            ak[i] = fmaf(dl, qf[i] * scale, ak[i]);
            av[i] = fmaf(p, gf[i], av[i]);
          }
        }
      }
      if (key == 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          cls_dk[i] += ak[i];
          cls_dv[i] += av[i];
        }
      } else if (ln.active) {
        k2::store(dk + row0 + (key - 1) * frame, Slice<T>::from_f(ak));
        k2::store(dv + row0 + (key - 1) * frame, Slice<T>::from_f(av));
      }
    }
    __syncwarp();  // the next column rewrites the tables
  }

  if (ln.active) {
    const size_t dst = (static_cast<size_t>(b) * runs + run) * D + ln.c;
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      *reinterpret_cast<float4*>(dcls_k + dst + i) =
          make_float4(cls_dk[i], cls_dk[i + 1], cls_dk[i + 2], cls_dk[i + 3]);
      *reinterpret_cast<float4*>(dcls_v + dst + i) =
          make_float4(cls_dv[i], cls_dv[i + 1], cls_dv[i + 2], cls_dv[i + 3]);
    }
  }
}

template <typename T, int FC>
int launch_fc(const void* q, const void* k, const void* v, const void* ck, const void* cv,
              const void* dout, void* dq, void* dk, void* dv, void* dck, void* dcv, int B,
              int F, int N, int D, int H, float scale, cudaStream_t stream) {
  const int P = k2::lanes_per_head(D / H, Slice<T>::kN);
  const int slices = (H + 32 / P - 1) / (32 / P);
  const int runs = (N + kRun - 1) / kRun;
  const long long warps = static_cast<long long>(B) * runs * slices;
  if (warps == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  time_attention_bwd_kernel<T, FC><<<blocks, kWarps * 32, bwd_smem_bytes(F, P), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dck),
      static_cast<float*>(dcv), F, N, D, H, P, slices, runs, warps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_time_bwd(const void* q, const void* k, const void* v, const void* ck,
                    const void* cv, const void* dout, void* dq, void* dk, void* dv, void* dck,
                    void* dcv, int B, int F, int N, int D, int H, float scale,
                    cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, ck, cv, dout, dq, dk, dv, dck, dcv};
  bool aligned = true;
  for (const void* p : ptrs) aligned = aligned && k2::aligned16(p);
  if (H <= 0 || D % H != 0 || !k2::takes(F, D / H, Slice<T>::kN) || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F <= 4)
    return launch_fc<T, 4>(q, k, v, ck, cv, dout, dq, dk, dv, dck, dcv, B, F, N, D, H, scale,
                           stream);
  if (F <= 8)
    return launch_fc<T, 8>(q, k, v, ck, cv, dout, dq, dk, dv, dck, dcv, B, F, N, D, H, scale,
                           stream);
  return launch_fc<T, 16>(q, k, v, ck, cv, dout, dq, dk, dv, dck, dcv, B, F, N, D, H, scale,
                          stream);
}

template <typename T>
cudaError_t bwd_attributes(int F, cudaFuncAttributes* attr) {
  if (F <= 4) return cudaFuncGetAttributes(attr, time_attention_bwd_kernel<T, 4>);
  if (F <= 8) return cudaFuncGetAttributes(attr, time_attention_bwd_kernel<T, 8>);
  return cudaFuncGetAttributes(attr, time_attention_bwd_kernel<T, 16>);
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
// dcls_k, dcls_v: float32 [B, ceil(N / 4), D], each run of 4 patch columns'
// share of the CLS grads.
extern "C" int egovlp_time_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* cls_k, const void* cls_v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* dcls_k, void* dcls_v, int B, int F, int N,
                                         int D, int H, float scale, int dtype, int device,
                                         void* stream) {
  const cudaError_t err = egovlp::k2::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_time_bwd<__nv_bfloat16>(q, k, v, cls_k, cls_v, dout, dq, dk, dv,
                                                  dcls_k, dcls_v, B, F, N, D, H, scale, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_time_bwd<float>(q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k,
                                          dcls_v, B, F, N, D, H, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the instantiation a
// launch with F frames at `dtype` takes, and the shared memory a CTA of it
// takes at hd 64; returns a cudaError_t code.
extern "C" int egovlp_time_attention_bwd_attributes(int F, int dtype, int* regs,
                                                    int* local_bytes, int* smem) {
  if (F < 1 || F > egovlp::k2::kFrameCap) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err;
  int kn;
  if (dtype == egovlp::kBFloat16) {
    err = egovlp::bwd_attributes<__nv_bfloat16>(F, &attr);
    kn = egovlp::k2::Slice<__nv_bfloat16>::kN;
  } else if (dtype == egovlp::kFloat32) {
    err = egovlp::bwd_attributes<float>(F, &attr);
    kn = egovlp::k2::Slice<float>::kN;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(egovlp::bwd_smem_bytes(F, egovlp::k2::lanes_per_head(64, kn)));
  return static_cast<int>(cudaSuccess);
}
