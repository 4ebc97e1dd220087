// Space attention backward (K1-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_mk_space_bwd_bsd_v3,
// launched by _space_bwd_bsd_call.
//
// What it computes: q, k, v, do, dq, dk, dv are [B, G, L, D] (G frames of L
// patch tokens, D = H * hd, heads sliced from D by stride); cls_k, cls_v are
// [B, 1, D].  For each (b, frame g, head h), with qs = round(q * scale *
// log2(e)), K = [cls_k; k[b, g]] and V = [cls_v; v[b, g]] (L + 1 rows):
//
//   p  = exp2(s - rowmax(s)) / rowsum,  s = qs K^T   recomputed, float32
//   dp = do V^T
//   dl = round(p * (dp - rowsum(dp * p)))
//   dq = dl K * scale,   dK = dl^T qs * ln(2),   dV = round(p)^T do
//
// where round() is a cast to the input dtype: the base-2 softmax and the
// rounding points of the Pallas bodies (_v2 :509-530, _v3 :625-666; ln(2)
// undoes the log2(e) folded into qs).  dq and the patch rows of dK and
// dV are written in the input dtype.  The CLS rows of dK and dV, this
// frame's share of the CLS gradients, go to float32 scratch [B, G, D]
// that the wrapper sums over frames and casts once.  (The Pallas body casts
// each frame's share to the input dtype before the sum, :663-665; keeping
// it float32 rounds once instead of G + 1 times.)
//
// bf16 launches run the tensor-core body of attention_bwd_mma.cuh (the
// kSpace policy), which says what bounds this kernel and what its design
// does about it.  float32 launches keep the scalar body below (tensor cores
// at float32 would be TF32).  It is bound by the CUDA-core FMA rate and
// shared-memory bandwidth, not device memory: per query row it runs five
// (L + 1) x hd products (logits, dp, dq, dK, dV) against the forward's two,
// all as scalar FMAs over shared memory.
//
// Design of the scalar body: one CTA per (b, g, h) with 16 warps, or 8
// where 16 warps' row buffers would pass the device's opt-in shared-memory limit (float32 at
// L 196).  The CTA stages K and V for its head in shared memory once (rows
// padded by 4 bytes so lanes that walk different key rows hit distinct
// banks) and keeps float32 dK and dV accumulators [L + 1][hd] there too.
// Query rows go in chunks, one row per warp: the warp recomputes its row's
// logits and dp with each lane holding 8 keys in registers (one load of
// q_d / do_d serves 8 FMAs), takes one float32 softmax pass (the whole key
// row fits; no online rescale), writes its dq row, and leaves
// qs, do, round(p) and dl in its own slice of shared memory.
// After a block barrier every thread adds the chunk's rows into the
// accumulator entries it owns, one channel d and every (blockDim / hd)-th
// key, with that channel's q and do values of the chunk in registers; the
// sums need no atomics and come out in a fixed order (the result does not
// change from run to run).  Shared memory at L 196, hd 64: 215 KB (float32,
// 8 warps).  Limits: L + 1 <= 256 keys, hd <= 128.

#include <math.h>

#include "attention_bwd_mma.cuh"
#include "common.cuh"

namespace egovlp {
namespace {

constexpr int kKeysPerLane = 8;              // keys a lane holds in registers
constexpr int kMaxKeys = 32 * kKeysPerLane;  // so L + 1 <= 256
constexpr int kColsPerLane = 4;              // dq channels a lane holds: hd <= 128
constexpr int kMaxWarps = 16;

template <typename T>
__host__ __device__ inline int space_bwd_row_stride(int hd) {
  return hd + 4 / static_cast<int>(sizeof(T));
}

template <typename T>
inline size_t space_bwd_smem_bytes(int L, int hd, int warps) {
  const size_t lk = static_cast<size_t>(L) + 1;
  return 2 * lk * space_bwd_row_stride<T>(hd) * sizeof(T)  // K, V
         + 2 * lk * hd * sizeof(float)                      // dK, dV sums
         + static_cast<size_t>(warps) * (2 * hd + 2 * lk) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
space_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ cls_k,
                           const T* __restrict__ cls_v, const T* __restrict__ dout,
                           T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ dcls_k, float* __restrict__ dcls_v,
                           int G, int L, int D, int H, float scale, float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int hd = D / H;
  const int lk = L + 1;
  const int ks = space_bwd_row_stride<T>(hd);
  const int ws = 2 * hd + 2 * lk;  // floats of one warp's slice
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(lk) * ks;
  // 2 * lk * ks * sizeof(T) is a multiple of 4 bytes for both dtypes
  float* dk_acc = reinterpret_cast<float*>(v_s + static_cast<size_t>(lk) * ks);
  float* dv_acc = dk_acc + static_cast<size_t>(lk) * hd;
  float* warp_s = dv_acc + static_cast<size_t>(lk) * hd;

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
    dk_acc[t] = 0.f;
    dv_acc[t] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q_w = warp_s + static_cast<size_t>(warp) * ws;  // [hd] qs
  float* do_w = q_w + hd;                                // [hd] do
  float* p_w = do_w + hd;                                // [lk] round(p)
  float* dl_w = p_w + lk;                                // [lk] dl
  // this lane's keys lane + 32 c; slots past the last key read row lk - 1
  int key_off[kKeysPerLane];
#pragma unroll
  for (int c = 0; c < kKeysPerLane; ++c) key_off[c] = min(lane + 32 * c, lk - 1) * ks;

  // the update's ownership: channel d, keys j0, j0 + jstep, ...
  const int jstep = blockDim.x / hd;
  const int own_d = threadIdx.x % hd, own_j0 = threadIdx.x / hd;

  for (int i0 = 0; i0 < L; i0 += warps) {
    const int i = i0 + warp;
    if (i < L) {  // the whole warp takes one branch
      const size_t row = grid_off + static_cast<size_t>(i) * D;
      for (int d = lane; d < hd; d += 32) {
        q_w[d] = round_to<T>(Cvt<T>::to_f(q[row + d]) * qscale);
        do_w[d] = Cvt<T>::to_f(dout[row + d]);
      }
      __syncwarp();

      float s[kKeysPerLane], g[kKeysPerLane];  // logits, then p; dp
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) s[c] = g[c] = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float qd = q_w[d], od = do_w[d];
#pragma unroll
        for (int c = 0; c < kKeysPerLane; ++c) {
          s[c] = fmaf(qd, Cvt<T>::to_f(k_s[key_off[c] + d]), s[c]);
          g[c] = fmaf(od, Cvt<T>::to_f(v_s[key_off[c] + d]), g[c]);
        }
      }
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c)
        if (lane + 32 * c < lk) m = fmaxf(m, s[c]);
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        s[c] = lane + 32 * c < lk ? exp2f(s[c] - m) : 0.f;
        sum += s[c];
      }
      const float inv = 1.f / warp_sum(sum);
      float inner = 0.f;  // sum_j dp_j * p_j
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        s[c] *= inv;
        inner = fmaf(g[c], s[c], inner);
      }
      inner = warp_sum(inner);
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < lk) {
          dl_w[j] = round_to<T>(s[c] * (g[c] - inner));
          p_w[j] = round_to<T>(s[c]);
        }
      }
      __syncwarp();

      float acc[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;
      for (int j = 0; j < lk; ++j) {
        const float dlj = dl_w[j];
        const T* kr = k_s + j * ks;
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          if (lane + 32 * c < hd) acc[c] = fmaf(dlj, Cvt<T>::to_f(kr[lane + 32 * c]), acc[c]);
      }
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        if (lane + 32 * c < hd) dq[row + lane + 32 * c] = Cvt<T>::from_f(acc[c] * scale);
    }
    __syncthreads();

    // dK += dl^T qs (times ln(2) when written), dV += round(p)^T do over
    // this chunk's rows
    const int nr = min(warps, L - i0);
    if (own_j0 < jstep) {
      float qr[kMaxWarps], gr[kMaxWarps];
#pragma unroll
      for (int r = 0; r < kMaxWarps; ++r) {
        const float* w = warp_s + static_cast<size_t>(r) * ws;
        qr[r] = r < nr ? w[own_d] : 0.f;
        gr[r] = r < nr ? w[hd + own_d] : 0.f;
      }
      for (int j = own_j0; j < lk; j += jstep) {
        const int e = j * hd + own_d;
        float ak = dk_acc[e], av = dv_acc[e];
#pragma unroll
        for (int r = 0; r < kMaxWarps; ++r) {
          if (r < nr) {
            const float* w = warp_s + static_cast<size_t>(r) * ws;
            ak = fmaf(w[2 * hd + lk + j], qr[r], ak);
            av = fmaf(w[2 * hd + j], gr[r], av);
          }
        }
        dk_acc[e] = ak;
        dv_acc[e] = av;
      }
    }
    __syncthreads();
  }

  const size_t part_off = static_cast<size_t>(bg) * D + static_cast<size_t>(h) * hd;
  for (int t = threadIdx.x; t < lk * hd; t += blockDim.x) {
    const int j = t / hd, d = t % hd;
    if (j == 0) {
      dcls_k[part_off + d] = dk_acc[t] * kLn2;
      dcls_v[part_off + d] = dv_acc[t];
    } else {
      const size_t dst = grid_off + static_cast<size_t>(j - 1) * D + d;
      dk[dst] = Cvt<T>::from_f(dk_acc[t] * kLn2);
      dv[dst] = Cvt<T>::from_f(dv_acc[t]);
    }
  }
}

template <typename T>
int launch_space_bwd(const void* q, const void* k, const void* v, const void* ck,
                     const void* cv, const void* dout, void* dq, void* dk, void* dv,
                     void* dck, void* dcv, int B, int G, int L, int D, int H, float scale,
                     int device, cudaStream_t stream) {
  const int hd = D / H;
  if (L + 1 > kMaxKeys || hd > 32 * kColsPerLane) return static_cast<int>(cudaErrorInvalidValue);
  DeviceLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = kMaxWarps;
  size_t smem = space_bwd_smem_bytes<T>(L, hd, warps);
  if (smem > static_cast<size_t>(lim.smem_optin)) {
    warps = kMaxWarps / 2;
    smem = space_bwd_smem_bytes<T>(L, hd, warps);
  }
  if (smem > static_cast<size_t>(lim.smem_optin) || hd > warps * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(space_attention_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * G * H);
  space_attention_bwd_kernel<T><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dck), static_cast<float*>(dcv), G, L, D, H, scale,
      static_cast<float>(static_cast<double>(scale) * kLog2e));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
// dcls_k, dcls_v: float32 [B, G, D], each frame's share of the CLS grads.
extern "C" int egovlp_space_attention_bwd(const void* q, const void* k, const void* v,
                                          const void* cls_k, const void* cls_v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          void* dcls_k, void* dcls_v, int B, int G, int L,
                                          int D, int H, float scale, int dtype, int device,
                                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_attention_bwd_mma<egovlp::Rounding::kSpace>(
        q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k, dcls_v, B, G, L, D, H, scale, device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_space_bwd<float>(q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k,
                                           dcls_v, B, G, L, D, H, scale, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and shared memory of the
// bf16 kernel a launch at (L, hd) takes; returns a cudaError_t code.
extern "C" int egovlp_space_attention_bwd_attributes(int L, int hd, int* regs,
                                                     int* local_bytes, int* smem) {
  return egovlp::attention_bwd_mma_attributes<egovlp::Rounding::kSpace>(L, hd, regs,
                                                                        local_bytes, smem);
}
