// LayerNorm backward (K3-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/fused_ln.py::_ln_bwd, the backward of the
// fused_layer_norm custom VJP (plain jnp there).
//
// What it computes: from x, dy [rows, D] (bf16 or float32), scale [D] and
// the forward's mu, rstd [rows] (float32), per row in float32, with x_hat
// = (x - mu) * rstd and g = dy * scale:
//     dx = rstd * ((g - mean(g)) - x_hat * mean(g * x_hat)), rounded to x's
//     type;
// and each block's share of the column sums dscale = sum_rows(dy * x_hat)
// and dbias = sum_rows(dy), float32, into part [2, blocks, D].  The wrapper
// adds the blocks' shares (one reduction over a fixed shape, so two
// launches give the same bits: no atomics anywhere).
//
// What bounds it on an H100: device memory.  A row element costs ~15
// FLOPs against 6 bytes moved at bf16 (x and dy read, dx written); the
// partial sums add 8 * D bytes a block of 32 rows (4% at D 1024).
//
// Design: one warp a row, 8 warps a block, each block 32 consecutive rows
// (4 a warp).  A lane takes every 32nd 16-byte slice of the row in two
// sweeps: the first sums g and g * x_hat (xor shuffles add the lanes), the
// second reads the slices again (from L1) to write dx and add dy * x_hat
// and dy into the lane's column sums, which stay in registers across the
// warp's rows.  At the end the 8 warps' column sums meet in shared memory
// and are added in warp order.
//
// Shapes: D a multiple of 8 (bf16) or 4 (float32) up to 1024, every
// pointer of x, dy, scale, dx on a 16-byte boundary; the launcher refuses
// any other (the wrapper raises).

#include "layer_norm.cuh"

namespace egovlp {
namespace k3 {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale, const float* __restrict__ mu,
               const float* __restrict__ rstd, T* __restrict__ dx, float* __restrict__ part,
               int rows, int D) {
  constexpr int kN = Slice<T>::kN;
  constexpr int kV = kMaxD / (32 * kN);  // slices a lane holds: 4 (bf16), 8 (float32)
  __shared__ __align__(16) float red[kWarps][kMaxD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slices = D / kN;
  const float d = static_cast<float>(D);

  float ds[kV][kN], db[kV][kN];
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int i = 0; i < kN; ++i) ds[j][i] = db[j][i] = 0.f;

  const int row0 = blockIdx.x * kBwdRowsPerBlock;
  const int row_end = min(row0 + kBwdRowsPerBlock, rows);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const float m = mu[r], rs = rstd[r];
    const size_t off = static_cast<size_t>(r) * D;
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = j * 32 + lane;
      if (v < slices) {
        float xf[kN], g[kN], sc[kN];
        unpack(load16(x + off + v * kN), xf);
        unpack(load16(dy + off + v * kN), g);
        load_params(scale + v * kN, sc);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xf[i], m), rs);
          const float gg = __fmul_rn(g[i], sc[i]);
          sg = __fadd_rn(sg, gg);
          sgx = __fadd_rn(sgx, __fmul_rn(gg, xh));
        }
      }
    }
    const float m1 = __fdiv_rn(warp_sum(sg), d);
    const float m2 = __fdiv_rn(warp_sum(sgx), d);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = j * 32 + lane;
      if (v < slices) {
        float xf[kN], g[kN], sc[kN], out[kN];
        unpack(load16(x + off + v * kN), xf);
        unpack(load16(dy + off + v * kN), g);
        load_params(scale + v * kN, sc);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float xh = __fmul_rn(__fsub_rn(xf[i], m), rs);
          const float gg = __fmul_rn(g[i], sc[i]);
          out[i] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gg, m1), __fmul_rn(xh, m2)));
          ds[j][i] = __fadd_rn(ds[j][i], __fmul_rn(g[i], xh));
          db[j][i] = __fadd_rn(db[j][i], g[i]);
        }
        store16(dx + off + v * kN, pack(out));
      }
    }
  }

  // the block's column sums: the 8 warps' shares added in warp order
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = j * 32 + lane;
      if (v < slices) {
#pragma unroll
        for (int i = 0; i < kN; i += 4)
          *reinterpret_cast<float4*>(&red[warp][v * kN + i]) =
              which ? make_float4(db[j][i], db[j][i + 1], db[j][i + 2], db[j][i + 3])
                    : make_float4(ds[j][i], ds[j][i + 1], ds[j][i + 2], ds[j][i + 3]);
      }
    }
    __syncthreads();
    float* out = part + (static_cast<size_t>(which) * gridDim.x + blockIdx.x) * D;
    for (int c = threadIdx.x; c < D; c += kThreads) {
      float t = red[0][c];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, red[w][c]);
      out[c] = t;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* scale, const void* mu,
               const void* rstd, void* dx, void* part, int rows, int D, cudaStream_t stream) {
  if (rows < 0 || D <= 0 || D > kMaxD || D % Slice<T>::kN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(dy) || !aligned16(scale) || !aligned16(dx))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  bwd_kernel<T><<<bwd_blocks(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(scale),
      static_cast<const float*>(mu), static_cast<const float*>(rstd), static_cast<T*>(dx),
      static_cast<float*>(part), rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k3
}  // namespace egovlp

// x, dy, dx [rows, D] of `dtype`; scale [D], mu, rstd [rows] and part [2,
// ceil(rows / 32), D] float32.  Launches on `stream` of device `device`;
// returns a cudaError_t code.
extern "C" int egovlp_layer_norm_bwd(const void* x, const void* dy, const void* scale,
                                     const void* mu, const void* rstd, void* dx, void* part,
                                     int rows, int D, int dtype, int device, void* stream) {
  const cudaError_t err = egovlp::k3::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k3::launch_bwd<__nv_bfloat16>(x, dy, scale, mu, rstd, dx, part, rows, D, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::k3::launch_bwd<float>(x, dy, scale, mu, rstd, dx, part, rows, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread, local (spill) bytes a thread and static shared memory
// of K3-bwd at `dtype`; returns a cudaError_t code.
extern "C" int egovlp_layer_norm_bwd_attributes(int dtype, int* regs, int* local_bytes,
                                                int* smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (dtype == egovlp::kBFloat16)
    err = cudaFuncGetAttributes(&a, egovlp::k3::bwd_kernel<__nv_bfloat16>);
  else if (dtype == egovlp::kFloat32)
    err = cudaFuncGetAttributes(&a, egovlp::k3::bwd_kernel<float>);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem = static_cast<int>(a.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}
