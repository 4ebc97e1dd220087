// LayerNorm forward (K3-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/fused_ln.py::fused_layer_norm, the forward
// half of its custom VJP (_ln_fwd_math; plain jnp there, which XLA fuses
// into one pass on the TPU).
//
// What it computes: x, y are [rows, D] (bf16 or float32), scale and bias
// [D] float32.  Per row, in float32: mu = mean(x), var = max(mean(x * x)
// - mu * mu, 0), rstd = 1 / sqrt(var + eps), and y = (x - mu) * (rstd *
// scale) + bias, rounded once to x's type.  mu and rstd ([rows] float32)
// are written for the backward, which saves nothing else but x and scale.
//
// What bounds it on an H100: device memory.  A row element costs ~8
// FLOPs against 4 bytes moved at bf16 (x read, y written): the kernel's
// job is to read x and write y once at the card's memory rate.
//
// Design: one warp a row, 8 rows a block; a lane takes every 32nd 16-byte
// slice of the row (8 bf16 or 4 float32 values), sums x and x * x in
// float32 and the warp adds its lanes with xor shuffles; then a second
// sweep over the same slices, which the first left in L1, writes y with
// one 16-byte store a slice.
//
// Shapes: D a multiple of 8 (bf16) or 4 (float32), every pointer on a
// 16-byte boundary; the launcher refuses any other (the wrapper raises).

#include "layer_norm.cuh"

namespace egovlp {
namespace k3 {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ mu_out,
               float* __restrict__ rstd_out, int rows, int D, float eps) {
  constexpr int kN = Slice<T>::kN;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int slices = D / kN;
  const T* xr = x + static_cast<size_t>(row) * D;
  T* yr = y + static_cast<size_t>(row) * D;

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
  const float d = static_cast<float>(D);
  const float mu = __fdiv_rn(s, d);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, d), __fmul_rn(mu, mu)), 0.f);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  if (lane == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rstd;
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

template <typename T>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y, void* mu,
               void* rstd, int rows, int D, float eps, cudaStream_t stream) {
  if (rows < 0 || D <= 0 || D % Slice<T>::kN != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(scale) || !aligned16(bias) || !aligned16(y))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (rows + kWarps - 1) / kWarps;
  fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<float*>(mu),
      static_cast<float*>(rstd), rows, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k3
}  // namespace egovlp

// x, y [rows, D] of `dtype`; scale, bias [D] and mu, rstd [rows] float32.
// Launches on `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_layer_norm_fwd(const void* x, const void* scale, const void* bias,
                                     void* y, void* mu, void* rstd, int rows, int D,
                                     float eps, int dtype, int device, void* stream) {
  const cudaError_t err = egovlp::k3::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k3::launch_fwd<__nv_bfloat16>(x, scale, bias, y, mu, rstd, rows, D, eps, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::k3::launch_fwd<float>(x, scale, bias, y, mu, rstd, rows, D, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and static shared memory
// of K3-fwd at `dtype`; returns a cudaError_t code.
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
