// LayerNorm forward (K3-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/fused_ln.py::fused_layer_norm, the forward
// half of its custom VJP (_ln_fwd_math; plain jnp there, which XLA fuses
// into one pass on the TPU), and the pair of calls with one set of
// parameters on a block's CLS and patch parts at
// egovlp_tpu/models/video_tower.py:308-330 (norm3, norm1, norm2).
//
// What it computes: over the rows of two segments a and b of width D
// (layer_norm.cuh; bf16 or float32), scale and bias [D] float32.  Per row,
// in float32: mu = mean(x), var = max(mean(x * x) - mu * mu, 0), rstd = 1 /
// sqrt(var + eps), and y = (x - mu) * (rstd * scale) + bias, rounded once
// to x's type.  mu and rstd are written for the backward, which saves
// nothing else but x and scale: each segment's stats [2, rows] float32, mu
// then rstd.
//
// What bounds it on an H100: device memory.  A row element costs ~8
// FLOPs against 4 bytes moved at bf16 (x read, y written): the kernel's
// job is to read x and write y once at the card's memory rate.  At the
// 32 CLS rows of a block no launch comes near that: the launch itself
// bounds it, so the CLS rows ride at the tail of the patch rows' launch.
//
// Design: one warp a row; a persistent grid of at most as many blocks of 8
// warps as the SMs hold, each warp walking rows warp, warp + (all warps),
// ...; a lane takes every 32nd 16-byte slice of the row (8 bf16 or 4
// float32 values), sums x and x * x in float32 and the warp adds its lanes
// with xor shuffles; then a second sweep over the same slices, which the
// first left in L1, writes y with one 16-byte store a slice.
//
// Shapes: D a multiple of 8 (bf16) or 4 (float32), every pointer of x, y,
// scale and bias on a 16-byte boundary; the launcher refuses any other
// (the wrapper raises).

#include "layer_norm.cuh"

namespace egovlp {
namespace k3 {

// no cap of the forward's grid but what an SM holds (32 blocks at most)
constexpr int kFwdBlocksPerSm = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ ya, T* __restrict__ yb, float* __restrict__ stats_a,
               float* __restrict__ stats_b, int rows_a, int rows_b, int D, float eps) {
  constexpr int kN = Slice<T>::kN;
  const int lane = threadIdx.x & 31;
  const int rows = rows_a + rows_b;
  const int warps = gridDim.x * kWarps;
  const int slices = D / kN;
  const float d = static_cast<float>(D);

  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows; row += warps) {
    const T* xr = row_of(xa, xb, row, rows_a, D);
    T* yr = row_of(ya, yb, row, rows_a, D);
    float s = 0.f, ss = 0.f;
    for (int v = lane; v < slices; v += 32) {
      float f[kN];
      unpack(load16(xr + v * kN), f);
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        s = __fadd_rn(s, f[i]);
        ss = __fadd_rn(ss, __fmul_rn(f[i], f[i]));
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = __fdiv_rn(s, d);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, d), __fmul_rn(mu, mu)), 0.f);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (lane == 0) {
      const bool in_a = row < rows_a;
      float* st = in_a ? stats_a + row : stats_b + (row - rows_a);
      st[0] = mu;
      st[in_a ? rows_a : rows_b] = rstd;
    }
    for (int v = lane; v < slices; v += 32) {
      float f[kN], sc[kN], b[kN];
      unpack(load16(xr + v * kN), f);
      load_params(scale + v * kN, sc);
      load_params(bias + v * kN, b);
#pragma unroll
      for (int i = 0; i < kN; ++i)
        f[i] = __fadd_rn(__fmul_rn(__fsub_rn(f[i], mu), __fmul_rn(rstd, sc[i])), b[i]);
      store16(yr + v * kN, pack(f));
    }
  }
}

template <typename T>
int launch_fwd(const void* xa, const void* xb, const void* scale, const void* bias, void* ya,
               void* yb, void* stats_a, void* stats_b, int rows_a, int rows_b, int D, float eps,
               int device, cudaStream_t stream) {
  if (rows_a < 0 || rows_b < 0 || D <= 0 || D % Slice<T>::kN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(xa) || !aligned16(scale) || !aligned16(bias) || !aligned16(ya) ||
      (rows_b > 0 && (!aligned16(xb) || !aligned16(yb))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows_a + rows_b == 0) return static_cast<int>(cudaSuccess);
  static std::atomic<int> per_sm[kMaxDevices];
  int grid = 0;
  const cudaError_t err = persistent_grid(fwd_kernel<T>, rows_a + rows_b, 0, kFwdBlocksPerSm,
                                          device, &per_sm[device], &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xa), static_cast<const T*>(xb), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(ya), static_cast<T*>(yb),
      static_cast<float*>(stats_a), static_cast<float*>(stats_b), rows_a, rows_b, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k3
}  // namespace egovlp

// Segments a: xa, ya [rows_a, D], stats_a [2, rows_a]; b: xb, yb [rows_b,
// D], stats_b [2, rows_b] (ignored where rows_b is 0); x, y of `dtype`,
// scale, bias [D] and the stats (mu, then rstd) float32.  Launches on
// `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_layer_norm_fwd(const void* xa, const void* xb, const void* scale,
                                     const void* bias, void* ya, void* yb, void* stats_a,
                                     void* stats_b, int rows_a, int rows_b, int D, float eps,
                                     int dtype, int device, void* stream) {
  if (device < 0 || device >= egovlp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t err = egovlp::k3::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k3::launch_fwd<__nv_bfloat16>(xa, xb, scale, bias, ya, yb, stats_a, stats_b,
                                                 rows_a, rows_b, D, eps, device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::k3::launch_fwd<float>(xa, xb, scale, bias, ya, yb, stats_a, stats_b, rows_a,
                                         rows_b, D, eps, device, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and shared memory a
// block of K3-fwd at `dtype`; returns a cudaError_t code.
extern "C" int egovlp_layer_norm_fwd_attributes(int dtype, int* regs, int* local_bytes,
                                                int* smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (dtype == egovlp::kBFloat16)
    err = cudaFuncGetAttributes(&a, egovlp::k3::fwd_kernel<__nv_bfloat16>);
  else if (dtype == egovlp::kFloat32)
    err = cudaFuncGetAttributes(&a, egovlp::k3::fwd_kernel<float>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}
