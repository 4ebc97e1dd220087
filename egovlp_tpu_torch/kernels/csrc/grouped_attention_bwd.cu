// Grouped attention backward (K4-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_bwd_kernel, launched by
// _bwd_call (the backward of the grouped_attention custom_vjp), including
// the sum of the per-group CLS gradients (:150-152).
//
// What it computes: q, k, v, do, dq, dk, dv are [BH, G, L, hd] (heads
// already split, q already scaled); cls_k, cls_v are [BH, 1, hd].  For each
// (bh, group g), with K = [cls_k[bh]; k[bh, g]] and V = [cls_v[bh]; v[bh, g]]
// (L + 1 rows):
//
//   p  = softmax(q K^T)                  recomputed, float32, e / rowsum
//   dp = do V^T                          do widened to float32
//   dl = round(p * (dp - rowsum(dp * p)))
//   dq = dl K,   dK = dl^T q,   dV = p^T do
//
// where round() is a cast to the input dtype: the Pallas body rounds dl
// before the dq, dK and CLS dK products (:84-93), but widens do to float32
// (:61), so `p.astype(do.dtype)` is float32 and dV and the CLS dV take the
// UNROUNDED probabilities (:90, :94) (K1-bwd rounds p there).  dq and the
// group rows of dK and dV are written in the input dtype.  The CLS rows of
// dK and dV, this group's share of the CLS gradients, go to float32 scratch
// [BH, G, hd] that the wrapper sums over the groups and casts once.  (The
// Pallas body writes each group's share in the input dtype and sums those,
// :139-152; keeping them float32 rounds once instead of G + 1 times.)
//
// bf16 launches run the tensor-core body of attention_bwd_mma.cuh (the
// kGrouped policy), which says what bounds this kernel and what its design
// does about it.  float32 launches keep the scalar body below (tensor cores
// at float32 would be TF32), bound as K1-bwd's by the CUDA-core FMA rate and
// shared-memory bandwidth: per query row it runs five (L + 1) x hd
// products (logits, dp, dq, dK, dV), all as scalar FMAs over shared memory.
//
// Design of the scalar body: K1-bwd's, on contiguous [L, hd] groups.  One
// CTA per (bh, g) with 16 warps, or 8 where 16 warps' row buffers would pass the device's
// opt-in shared-memory limit (float32 at L 196).  The CTA stages K and V in
// shared memory once (rows padded by 4 bytes) and keeps float32 dK and dV
// accumulators [L + 1][hd] there too: at L 196 the [L, L + 1] float32
// probability tile (154 KB) does not fit beside them, so it is never
// formed.  Query rows go in chunks, one row per warp: the warp recomputes
// its row's logits and dp with each lane holding 8 keys in registers, takes
// one float32 softmax pass, writes its dq row, and leaves q, do, p and
// round(dl) in its own slice of shared memory.  After a block barrier every
// thread adds the chunk's rows into the accumulator entries it owns (one
// channel d and every (blockDim / hd)-th key): no atomics, and the sums come
// out in a fixed order.  Any L from 1 to 255 (the ragged edge is masked in
// the key slots; a chunk of fewer rows than warps leaves warps idle);
// hd <= 128.  Shared memory at L 196, hd 64: 215 KB (float32, 8 warps).

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
__host__ __device__ inline int grouped_bwd_row_stride(int hd) {
  return hd + 4 / static_cast<int>(sizeof(T));
}

template <typename T>
inline size_t grouped_bwd_smem_bytes(int L, int hd, int warps) {
  const size_t lk = static_cast<size_t>(L) + 1;
  return 2 * lk * grouped_bwd_row_stride<T>(hd) * sizeof(T)  // K, V
         + 2 * lk * hd * sizeof(float)                        // dK, dV sums
         + static_cast<size_t>(warps) * (2 * hd + 2 * lk) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
grouped_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ cls_k,
                             const T* __restrict__ cls_v, const T* __restrict__ dout,
                             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ dcls_k, float* __restrict__ dcls_v, int G,
                             int L, int hd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int lk = L + 1;
  const int ks = grouped_bwd_row_stride<T>(hd);
  const int ws = 2 * hd + 2 * lk;  // floats of one warp's slice
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(lk) * ks;
  // 2 * lk * ks * sizeof(T) is a multiple of 4 bytes for both dtypes
  float* dk_acc = reinterpret_cast<float*>(v_s + static_cast<size_t>(lk) * ks);
  float* dv_acc = dk_acc + static_cast<size_t>(lk) * hd;
  float* warp_s = dv_acc + static_cast<size_t>(lk) * hd;

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
    dk_acc[t] = 0.f;
    dv_acc[t] = 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q_w = warp_s + static_cast<size_t>(warp) * ws;  // [hd] q
  float* do_w = q_w + hd;                                // [hd] do
  float* p_w = do_w + hd;                                // [lk] p
  float* dl_w = p_w + lk;                                // [lk] round(dl)
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
      const size_t row = grp_off + static_cast<size_t>(i) * hd;
      for (int d = lane; d < hd; d += 32) {
        q_w[d] = Cvt<T>::to_f(q[row + d]);
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
        s[c] = lane + 32 * c < lk ? expf(s[c] - m) : 0.f;
        sum += s[c];
      }
      sum = warp_sum(sum);
      float inner = 0.f;  // sum_j dp_j * p_j
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        s[c] = s[c] / sum;
        inner = fmaf(g[c], s[c], inner);
      }
      inner = warp_sum(inner);
#pragma unroll
      for (int c = 0; c < kKeysPerLane; ++c) {
        const int j = lane + 32 * c;
        if (j < lk) {
          dl_w[j] = round_to<T>(s[c] * (g[c] - inner));
          p_w[j] = s[c];
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
        if (lane + 32 * c < hd) dq[row + lane + 32 * c] = Cvt<T>::from_f(acc[c]);
    }
    __syncthreads();

    // dK += round(dl)^T q, dV += p^T do over this chunk's rows
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

  const size_t part_off = static_cast<size_t>(blockIdx.x) * hd;
  for (int t = threadIdx.x; t < lk * hd; t += blockDim.x) {
    if (t < hd) {
      dcls_k[part_off + t] = dk_acc[t];
      dcls_v[part_off + t] = dv_acc[t];
    } else {
      const size_t dst = grp_off + static_cast<size_t>(t - hd);
      dk[dst] = Cvt<T>::from_f(dk_acc[t]);
      dv[dst] = Cvt<T>::from_f(dv_acc[t]);
    }
  }
}

template <typename T>
int launch_grouped_bwd(const void* q, const void* k, const void* v, const void* ck,
                       const void* cv, const void* dout, void* dq, void* dk, void* dv,
                       void* dck, void* dcv, int BH, int G, int L, int hd, int device,
                       cudaStream_t stream) {
  if (L + 1 > kMaxKeys || hd > 32 * kColsPerLane) return static_cast<int>(cudaErrorInvalidValue);
  DeviceLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = kMaxWarps;
  size_t smem = grouped_bwd_smem_bytes<T>(L, hd, warps);
  if (smem > static_cast<size_t>(lim.smem_optin)) {
    warps = kMaxWarps / 2;
    smem = grouped_bwd_smem_bytes<T>(L, hd, warps);
  }
  if (smem > static_cast<size_t>(lim.smem_optin) || hd > warps * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(grouped_attention_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(BH) * G);
  grouped_attention_bwd_kernel<T><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dck), static_cast<float*>(dcv), G, L, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace egovlp

// Launches on `stream` of device `device`; returns a cudaError_t code.
// dcls_k, dcls_v: float32 [BH, G, hd], each group's share of the CLS grads.
extern "C" int egovlp_grouped_attention_bwd(const void* q, const void* k, const void* v,
                                            const void* cls_k, const void* cls_v,
                                            const void* dout, void* dq, void* dk, void* dv,
                                            void* dcls_k, void* dcls_v, int BH, int G, int L,
                                            int hd, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::launch_attention_bwd_mma<egovlp::Rounding::kGrouped>(
        q, k, v, cls_k, cls_v, dout, dq, dk, dv, dcls_k, dcls_v, BH, G, L, hd, 1, 1.f, device,
        s);
  if (dtype == egovlp::kFloat32)
    return egovlp::launch_grouped_bwd<float>(q, k, v, cls_k, cls_v, dout, dq, dk, dv,
                                             dcls_k, dcls_v, BH, G, L, hd, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and shared memory of the
// bf16 kernel a launch at (L, hd) takes; returns a cudaError_t code.
extern "C" int egovlp_grouped_attention_bwd_attributes(int L, int hd, int* regs,
                                                       int* local_bytes, int* smem) {
  return egovlp::attention_bwd_mma_attributes<egovlp::Rounding::kGrouped>(
      L, hd, regs, local_bytes, smem);
}
