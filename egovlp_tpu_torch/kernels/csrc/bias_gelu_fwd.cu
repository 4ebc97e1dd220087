// Bias add + exact GELU, forward (K7-fwd), for sm_90a.
//
// Replaces no TPU kernel.  The JAX package's MLP (egovlp_tpu/models/
// video_tower.py Mlp, text_tower.py FFN) calls nn.gelu(approximate=False)
// on a Dense output: plain jnp, which XLA fuses with the bias add into the
// GEMM's epilogue or one elementwise pass.  The port ran it as PyTorch's
// bias add and four bf16 ops, one kernel each; this kernel is that one
// pass, with core/precision.py's rounding points (bias_gelu.cuh).
//
// What it computes: g = gelu(rnd(y + rnd(b))) over y [rows, width] (bf16
// or float32; b float32 [width], or none where the caller added it), every
// op of the chain rounded to y's type: equal to the PyTorch ops bit for
// bit.
//
// What bounds it on an H100: device memory.  It reads y and writes g once,
// 2 Hb a call (Hb = rows x width x 2 bytes at bf16): 0.368 ms at 3.35 TB/s
// for ViT-L's 75,264 x 4096.  erfcf and five roundings cost ~70 float32
// instructions an element, twice what the bytes allow; so at bf16 each
// block looks g up by h's bits in a shared-memory table that it fills
// first from the same chain (bias_gelu.cuh), and an element costs ~10.
//
// Design: a persistent grid of 2 blocks an SM, each filling its table once
// and the bias, rounded, into shared memory; a block takes a contiguous
// chunk of rows and walks it as a copy does, 16 bytes a thread and 2
// vectors a thread in flight (4, or 3 blocks an SM, read slower).

#include "bias_gelu.cuh"

namespace egovlp {
namespace k7 {

constexpr int kFwdUnroll = 2;     // vectors a thread has in flight
constexpr int kFwdMinBlocks = 2;  // blocks an SM

// g over rows [r0, r1) of each chunk blockIdx.x, blockIdx.x + gridDim.x,
// ...: a chunk is contiguous, and thread t takes its vectors t, t +
// kThreads, ..., as a copy does; the vector's column `col` advances by
// kThreads modulo the row's vectors, and its bias comes from shared memory
template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
    fwd_kernel(const T* __restrict__ y, const float* __restrict__ bias, T* __restrict__ g,
               int rows, int width, int chunks, float s) {
  constexpr int kN = Vec<T>::kN;
  constexpr bool kLookup = sizeof(T) == 2;
  // g of each table entry as float bits, then the bias rounded to T
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* table = reinterpret_cast<uint32_t*>(smem);
  float* bsh = reinterpret_cast<float*>(smem) + (kLookup ? kTable : 0);
  if constexpr (kLookup) {
    for (int i = threadIdx.x; i < kTable; i += kThreads)
      table[i] = __float_as_uint(gelu_chain<T>(table_h(i), s));
  }
  if constexpr (kBias) {
    for (int i = threadIdx.x; i < width; i += kThreads) bsh[i] = rnd<T>(bias[i]);
  }
  __syncthreads();
  const int nvec = width / kN;
  const int step = kThreads % nvec;
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* gv = reinterpret_cast<uint4*>(g);
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    int r0, r1;
    chunk_rows(rows, chunks, chunk, r0, r1);
    const size_t last = static_cast<size_t>(r1) * nvec;
    int col = threadIdx.x % nvec;
    for (size_t i = static_cast<size_t>(r0) * nvec + threadIdx.x; i < last;
         i += kThreads * kFwdUnroll) {
      uint4 in[kFwdUnroll];
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u)
        if (i + u * kThreads < last) in[u] = yv[i + u * kThreads];
#pragma unroll
      for (int u = 0; u < kFwdUnroll; ++u) {
        if (i + u * kThreads < last) {
          float f[kN], b[kN];
          unpack(in[u], f);
          if constexpr (kBias) {
#pragma unroll
            for (int k = 0; k < kN; k += 4) {
              const float4 t = *reinterpret_cast<const float4*>(bsh + col * kN + k);
              b[k] = t.x;
              b[k + 1] = t.y;
              b[k + 2] = t.z;
              b[k + 3] = t.w;
            }
          }
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            const float h = kBias ? rnd<T>(__fadd_rn(f[k], b[k])) : f[k];
            if constexpr (kLookup) {
              const uint32_t t = table_index(h);
              f[k] = t < kTable ? __uint_as_float(table[t]) : gelu_rare(h, s);
            } else {
              f[k] = gelu_chain<T>(h, s);
            }
          }
          gv[i + u * kThreads] = pack(f);
        }
        col += step;
        if (col >= nvec) col -= nvec;
      }
    }
  }
}

template <typename T>
int launch_fwd(const void* y, const void* bias, void* g, int rows, int width, float s,
               int device, cudaStream_t stream) {
  const void* ptrs[2] = {y, g};
  cudaError_t err = check_launch(rows, width, 1, ptrs, 2, bias);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  DeviceLimits lim;
  err = device_limits(device, &lim);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one chunk a block of the persistent grid, down to a row a chunk: a
  // call of few rows (a block's 96 CLS rows) waits on few DRAM trips
  const int chunks = std::min(kFwdMinBlocks * lim.sms, rows);
  const size_t smem = ((sizeof(T) == 2 ? kTable : 0) + (bias != nullptr ? width : 0)) * 4;
  if ((err = check_smem(smem, device)) != cudaSuccess) return static_cast<int>(err);
  const T* yt = static_cast<const T*>(y);
  const float* bt = static_cast<const float*>(bias);
  T* gt = static_cast<T*>(g);
  auto kernel = bias != nullptr ? fwd_kernel<T, true> : fwd_kernel<T, false>;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return static_cast<int>(err);
  kernel<<<chunks, kThreads, smem, stream>>>(yt, bt, gt, rows, width, chunks, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k7
}  // namespace egovlp

// y, g [rows, width] of `dtype`; bias float32 [width] or nullptr; s =
// sqrt(0.5) rounded to `dtype`.  Launches on `stream` of device `device`;
// returns a cudaError_t code.
extern "C" int egovlp_bias_gelu_fwd(const void* y, const void* bias, void* g, int rows, int width,
                                    float s, int dtype, int device, void* stream) {
  if (device < 0 || device >= egovlp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t err = egovlp::k7::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k7::launch_fwd<__nv_bfloat16>(y, bias, g, rows, width, s, device, st);
  if (dtype == egovlp::kFloat32)
    return egovlp::k7::launch_fwd<float>(y, bias, g, rows, width, s, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
