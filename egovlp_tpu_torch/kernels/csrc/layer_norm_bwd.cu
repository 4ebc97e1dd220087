// LayerNorm backward (K3-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/fused_ln.py::_ln_bwd, the backward of the
// fused_layer_norm custom VJP (plain jnp there), and the sum of the two
// VJPs of the pair of calls with one set of parameters on a block's CLS
// and patch parts at egovlp_tpu/models/video_tower.py:308-330.
//
// What it computes: over the rows of two segments a and b of width D
// (layer_norm.cuh), from x, dy (bf16 or float32), scale [D] and the
// forward's mu, rstd (float32, one a row), per row in float32, with x_hat
// = (x - mu) * rstd and g = dy * scale:
//     dx = rstd * ((g - mean(g)) - x_hat * mean(g * x_hat)), rounded to x's
//     type;
// and the column sums over the rows of both segments dscale =
// sum_rows(dy * x_hat) and dbias = sum_rows(dy), float32, into dparams
// [2, D].  Two launches give the same bits: every sum has one fixed order
// for a given shape and device, and there are no atomics.
//
// What bounds it on an H100: device memory, the bytes of x and dy read and
// dx written (6 a row element at bf16), but only just: the ~15 float32
// operations an element, at JAX's rounding points (no FMA), and the
// unpacking take the card about as long as those bytes do, so the design
// spends as few instructions a row as it can and overlaps them with the
// copies.  At a few rows (the 32 CLS rows, the 960 text rows) nothing comes
// near that: the launch, one row's latency and the grid sync do.
//
// Design:
// * A persistent grid of 8-warp blocks sized by the rows and the SM count
//   (persistent_grid, one block an SM): ceil(rows / 8) blocks up to 132 on
//   an H100, one warp a row at a time.  32 rows spread over 32 warps on 4
//   SMs, 960 rows over 120 SMs; 25,088 rows give each warp ~24 rows, whose
//   column sums it keeps in registers across all of them.
// * A lane holds its slices of scale in registers for every row, and the
//   row's x_hat and dy from the first sweep (the sums of g and g * x_hat)
//   to the second (dx and the column sums): ~220 registers a thread, so
//   one block an SM.  Loading scale in every sweep and reading the row
//   twice, at two blocks an SM, took a quarter more time at 25,088 rows
//   (egovlp_tpu_torch/tools/ln_bwd_sweep.py, row_smem+scale_l1+blocks=2).
// * Each warp stages its rows of x and dy in a ring of kStages rows in
//   shared memory with 16-byte cp.async copies (each lane copies, and
//   reads, its own slices), kStages - 1 = 2 rows ahead of the row it
//   computes; mu and rstd of the next row are loaded one row ahead.  The
//   first sweep reads the row from shared memory: nothing relies on L1.
// * The block's 8 warps add their column sums in warp order in shared
//   memory (aliasing the ring) and write one float32 row of [dscale;
//   dbias] a block to the scratch `part` [grid, 2 * D].
// * The launch is cooperative, so every block is resident: after a grid
//   sync the warps take 32-column chunks of [dscale; dbias], P warps of a
//   block to a chunk (1 up to 32 blocks, ..., 8 above 128), each adding
//   every P-th block's row in block order, 8 loads at once, and the P
//   sums meeting in warp order; they write dparams.  No second launch and
//   no reduction by PyTorch follows.
//
// Shapes: D a multiple of 8 (bf16) or 4 (float32) up to 1024, every
// pointer of x, dy, scale, dx on a 16-byte boundary; the launcher refuses
// any other (the wrapper raises).

#include <cooperative_groups.h>

#include <mutex>

#include "layer_norm.cuh"
#include "mma_sync.cuh"

namespace egovlp {
namespace k3 {

constexpr int kStages = 3;          // rows of x and dy a warp stages
constexpr int kBwdBlocksPerSm = 1;  // blocks an SM takes (~220 registers a thread)
constexpr int kChunk = 32;          // columns of [dscale; dbias] a warp sums at once
constexpr int kLoads = 8;           // rows of partial sums a lane loads at once

// dynamic shared memory of a block: each warp's ring of x and dy rows,
// which the block's column sums (2 * kWarps * D floats, at most 2 / 3 of
// the ring) and then the chunk sums (kWarps * kChunk floats) reuse
template <typename T>
constexpr size_t bwd_smem_bytes(int D) {
  return std::max(static_cast<size_t>(kWarps) * kStages * 2 * D * sizeof(T),
                  kWarps * kChunk * sizeof(float));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    bwd_kernel(const T* __restrict__ xa, const T* __restrict__ xb, const T* __restrict__ dya,
               const T* __restrict__ dyb, const float* __restrict__ scale,
               const float* __restrict__ mua, const float* __restrict__ rstda,
               const float* __restrict__ mub, const float* __restrict__ rstdb,
               T* __restrict__ dxa, T* __restrict__ dxb, float* __restrict__ part,
               float* __restrict__ dparams, int rows_a, int rows_b, int D) {
  using mma::cp_async16;
  using mma::cp_async_commit;
  using mma::cp_async_wait;
  using mma::smem_addr;
  constexpr int kN = Slice<T>::kN;
  constexpr int kV = kMaxD / (32 * kN);  // slices a lane holds: 4 (bf16), 8 (float32)
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slices = D / kN;
  const float d = static_cast<float>(D);
  const int rows = rows_a + rows_b;
  const int first = blockIdx.x * kWarps + warp;  // the warp's rows: first + k * stride
  const int stride = gridDim.x * kWarps;
  const int n = first < rows ? (rows - 1 - first) / stride + 1 : 0;
  T* ring = reinterpret_cast<T*>(smem) + static_cast<size_t>(warp) * kStages * 2 * D;

  float ds[kV][kN], db[kV][kN];
#pragma unroll
  for (int j = 0; j < kV; ++j)
#pragma unroll
    for (int i = 0; i < kN; ++i) ds[j][i] = db[j][i] = 0.f;

  // the warp's k-th row of x and dy into stage k % kStages (one commit
  // group a row, empty past the last row, so that the count of groups in
  // flight stays kStages - 1)
  auto stage_row = [&](int k) {
    if (k < n) {
      const int r = first + k * stride;
      const T* xr = row_of(xa, xb, r, rows_a, D);
      const T* dyr = row_of(dya, dyb, r, rows_a, D);
      T* sx = ring + static_cast<size_t>(k % kStages) * 2 * D;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int v = j * 32 + lane;
        if (v < slices) {
          cp_async16(smem_addr(sx + v * kN), xr + v * kN);
          cp_async16(smem_addr(sx + D + v * kN), dyr + v * kN);
        }
      }
    }
    cp_async_commit();
  };

  // the lane's slices of scale, held in registers for every row
  float sc[kV][kN];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    if (j * 32 + lane < slices) {
      load_params(scale + (j * 32 + lane) * kN, sc[j]);
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) sc[j][i] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) stage_row(k);
  float m_next = 0.f, rs_next = 0.f;
  if (n > 0) {
    m_next = *row_of(mua, mub, first, rows_a, 1);
    rs_next = *row_of(rstda, rstdb, first, rows_a, 1);
  }
  for (int k = 0; k < n; ++k) {
    const int r = first + k * stride;
    const float m = m_next, rs = rs_next;
    if (k + 1 < n) {
      m_next = *row_of(mua, mub, r + stride, rows_a, 1);
      rs_next = *row_of(rstda, rstdb, r + stride, rows_a, 1);
    }
    stage_row(k + kStages - 1);
    cp_async_wait<kStages - 1>();  // row k has landed (this lane's slices)
    const T* sx = ring + static_cast<size_t>(k % kStages) * 2 * D;
    const T* sdy = sx + D;
    // first sweep: the row's x_hat and dy, kept in registers for the
    // second, and the lane's sums of g and g * x_hat
    float xh[kV][kN], g[kV][kN];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = j * 32 + lane;
      if (v < slices) {
        float xf[kN];
        unpack(load16(sx + v * kN), xf);
        unpack(load16(sdy + v * kN), g[j]);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          xh[j][i] = __fmul_rn(__fsub_rn(xf[i], m), rs);
          const float gg = __fmul_rn(g[j][i], sc[j][i]);
          sg = __fadd_rn(sg, gg);
          sgx = __fadd_rn(sgx, __fmul_rn(gg, xh[j][i]));
        }
      }
    }
    const float m1 = __fdiv_rn(warp_sum(sg), d);
    const float m2 = __fdiv_rn(warp_sum(sgx), d);
    // second sweep: dx, and the column sums
    T* dxr = row_of(dxa, dxb, r, rows_a, D);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = j * 32 + lane;
      if (v < slices) {
        float out[kN];
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float gg = __fmul_rn(g[j][i], sc[j][i]);
          out[i] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gg, m1), __fmul_rn(xh[j][i], m2)));
          ds[j][i] = __fadd_rn(ds[j][i], __fmul_rn(g[j][i], xh[j][i]));
          db[j][i] = __fadd_rn(db[j][i], g[j][i]);
        }
        store16(dxr + v * kN, pack(out));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's column sums: the 8 warps' shares added in warp order, one
  // row [dscale; dbias] of `part` a block
  const int C = 2 * D;
  float* red = reinterpret_cast<float*>(smem);  // [2][kWarps][D]
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int v = j * 32 + lane;
    if (v < slices) {
#pragma unroll
      for (int i = 0; i < kN; i += 4) {
        *reinterpret_cast<float4*>(&red[warp * D + v * kN + i]) =
            make_float4(ds[j][i], ds[j][i + 1], ds[j][i + 2], ds[j][i + 3]);
        *reinterpret_cast<float4*>(&red[(kWarps + warp) * D + v * kN + i]) =
            make_float4(db[j][i], db[j][i + 1], db[j][i + 2], db[j][i + 3]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float* col = red + (c < D ? c : kWarps * D + (c - D));
    float t = col[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, col[w * D]);
    part[static_cast<size_t>(blockIdx.x) * C + c] = t;
  }

  // every block's row is written (the grid sync fences memory); the blocks
  // then add the rows in block order, 32 columns a warp: P warps share a
  // chunk (P grows with the grid so that a warp reads at most ~32 rows,
  // kLoads at once), warp q of the P adding rows q, q + P, ... and the P
  // sums meeting in warp order
  cooperative_groups::this_grid().sync();
  const int G = gridDim.x;
  const int P = G <= 32 ? 1 : G <= 64 ? 2 : G <= 128 ? 4 : kWarps;
  const int q = warp % P;
  float* sums = reinterpret_cast<float*>(smem);  // [kWarps][kChunk]
  for (int base = blockIdx.x * (kWarps / P); base * kChunk < C; base += G * (kWarps / P)) {
    const int c = (base + warp / P) * kChunk + lane;
    float t = 0.f;
    if (c < C) {
      for (int b0 = q; b0 < G; b0 += kLoads * P) {
        float v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int b = b0 + u * P;
          v[u] = b < G ? __ldcg(part + static_cast<size_t>(b) * C + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) t = __fadd_rn(t, v[u]);
      }
    }
    sums[warp * kChunk + lane] = t;
    __syncthreads();
    if (q == 0 && c < C) {
      float s = t;
      for (int w = 1; w < P; ++w) s = __fadd_rn(s, sums[(warp + w) * kChunk + lane]);
      dparams[c] = s;
    }
    __syncthreads();
  }
}

// blocks a launch over `rows` rows at width D takes (persistent_grid),
// the SM's capacity read once per device and D
template <typename T>
cudaError_t bwd_grid(int rows, int D, int device, int* grid) {
  static std::atomic<int> per_sm[kMaxDevices][kMaxD / 4 + 1];
  static std::once_flag once[kMaxDevices];
  static cudaError_t errs[kMaxDevices];
  DeviceLimits lim;
  cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  // the ring passes 48 KB from D 512 (bf16) or 256 (float32) on: allow the
  // opt-in limit once per device
  std::call_once(once[device], [device, &lim] {
    errs[device] = cudaFuncSetAttribute(bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        lim.smem_optin);
  });
  if (errs[device] != cudaSuccess) return errs[device];
  const size_t smem = bwd_smem_bytes<T>(D);
  if (smem > static_cast<size_t>(lim.smem_optin)) return cudaErrorInvalidValue;
  return persistent_grid(bwd_kernel<T>, rows, smem, kBwdBlocksPerSm, device,
                         &per_sm[device][D / 4], grid);
}

template <typename T>
int launch_bwd(const void* xa, const void* xb, const void* dya, const void* dyb, const void* scale,
               const void* mua, const void* rstda, const void* mub, const void* rstdb, void* dxa,
               void* dxb, void* part, void* dparams, int rows_a, int rows_b, int D,
               int part_rows, int device, cudaStream_t stream) {
  if (rows_a < 0 || rows_b < 0 || D <= 0 || D > kMaxD || D % Slice<T>::kN != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(xa) || !aligned16(dya) || !aligned16(scale) || !aligned16(dxa) ||
      (rows_b > 0 && (!aligned16(xb) || !aligned16(dyb) || !aligned16(dxb))))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int rows = rows_a + rows_b;
  if (rows == 0) return static_cast<int>(cudaErrorInvalidValue);  // no rows: no dparams
  int grid = 0;
  cudaError_t err = bwd_grid<T>(rows, D, device, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > part_rows) return static_cast<int>(cudaErrorInvalidValue);
  const T *x_a = static_cast<const T*>(xa), *x_b = static_cast<const T*>(xb);
  const T *dy_a = static_cast<const T*>(dya), *dy_b = static_cast<const T*>(dyb);
  const float* sc = static_cast<const float*>(scale);
  const float *mu_a = static_cast<const float*>(mua), *rs_a = static_cast<const float*>(rstda);
  const float *mu_b = static_cast<const float*>(mub), *rs_b = static_cast<const float*>(rstdb);
  T *dx_a = static_cast<T*>(dxa), *dx_b = static_cast<T*>(dxb);
  float *pt = static_cast<float*>(part), *dp = static_cast<float*>(dparams);
  void* args[] = {&x_a, &x_b,  &dy_a, &dy_b, &sc, &mu_a,   &rs_a,   &mu_b, &rs_b,
                  &dx_a, &dx_b, &pt,   &dp,   &rows_a, &rows_b, &D};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(bwd_kernel<T>), dim3(grid),
                                    dim3(kThreads), args, bwd_smem_bytes<T>(D), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k3
}  // namespace egovlp

// Segments a: xa, dya, dxa [rows_a, D], mua, rstda [rows_a]; b: the same
// with rows_b rows (ignored where rows_b is 0); x, dy, dx of `dtype`, the
// rest float32: scale [D], the scratch part [part_rows, 2 * D] (part_rows
// at least the grid, egovlp_layer_norm_bwd_grid) and dparams [2, D]
// (dscale, dbias).  Launches on `stream` of device `device`; returns a
// cudaError_t code.
extern "C" int egovlp_layer_norm_bwd(const void* xa, const void* xb, const void* dya,
                                     const void* dyb, const void* scale, const void* mua,
                                     const void* rstda, const void* mub, const void* rstdb,
                                     void* dxa, void* dxb, void* part, void* dparams, int rows_a,
                                     int rows_b, int D, int part_rows, int dtype, int device,
                                     void* stream) {
  if (device < 0 || device >= egovlp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t err = egovlp::k3::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k3::launch_bwd<__nv_bfloat16>(xa, xb, dya, dyb, scale, mua, rstda, mub, rstdb,
                                                 dxa, dxb, part, dparams, rows_a, rows_b, D,
                                                 part_rows, device, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::k3::launch_bwd<float>(xa, xb, dya, dyb, scale, mua, rstda, mub, rstdb, dxa,
                                         dxb, part, dparams, rows_a, rows_b, D, part_rows, device,
                                         s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks K3-bwd launches over `rows` rows of width D at `dtype` on
// `device`, into *grid; returns a cudaError_t code.
extern "C" int egovlp_layer_norm_bwd_grid(int rows, int D, int dtype, int device, int* grid) {
  if (device < 0 || device >= egovlp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = egovlp::k3::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || D <= 0 || D > egovlp::k3::kMaxD || D % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == egovlp::kBFloat16)
    err = egovlp::k3::bwd_grid<__nv_bfloat16>(rows, D, device, grid);
  else if (dtype == egovlp::kFloat32)
    err = egovlp::k3::bwd_grid<float>(rows, D, device, grid);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Registers a thread, local (spill) bytes a thread and shared memory a
// block (static, and the dynamic ring at D 1024) of K3-bwd at `dtype`;
// returns a cudaError_t code.
extern "C" int egovlp_layer_norm_bwd_attributes(int dtype, int* regs, int* local_bytes,
                                                int* smem) {
  cudaFuncAttributes a;
  cudaError_t err;
  size_t ring;
  if (dtype == egovlp::kBFloat16) {
    err = cudaFuncGetAttributes(&a, egovlp::k3::bwd_kernel<__nv_bfloat16>);
    ring = egovlp::k3::bwd_smem_bytes<__nv_bfloat16>(egovlp::k3::kMaxD);
  } else if (dtype == egovlp::kFloat32) {
    err = cudaFuncGetAttributes(&a, egovlp::k3::bwd_kernel<float>);
    ring = egovlp::k3::bwd_smem_bytes<float>(egovlp::k3::kMaxD);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem = static_cast<int>(a.sharedSizeBytes + ring);
  return static_cast<int>(cudaSuccess);
}
