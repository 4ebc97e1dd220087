// Bias add + exact GELU, backward (K7-bwd), for sm_90a.
//
// Replaces no TPU kernel (see bias_gelu_fwd.cu): XLA differentiates the
// JAX package's nn.gelu and fuses the result.  The port's autograd ran
// about ten bf16 ops over the hidden tensor and kept three hidden-sized
// tensors for them; this kernel recomputes from the saved y alone.
//
// What it computes: over dg and y [rows, width] (bf16 or float32) and the
// bias b (float32 [width], or none), h = rnd(y + rnd(b)) and the slope
// dg / dh of bias_gelu.cuh's chain, then dh = rnd(dg * slope), one
// rounding: the gradient of y.  With a bias, each block also writes the
// float32 sums of its rows' rounded dh by column to `part` [chunks, width],
// and a second small kernel sums those over the chunks in a fixed order and
// rounds the sum to y's type: the bias gradient, as the PyTorch ops' bf16
// sum and cast back give it.  No atomics: the result is the same from run
// to run.
//
// What bounds it on an H100: device memory.  It reads dg and y and writes
// dh, 3 Hb a call: 0.552 ms at 3.35 TB/s for ViT-L's 75,264 x 4096 bf16.
// erfcf, expf and the roundings cost ~90 float32 instructions an element;
// so at bf16 each block first fills a shared-memory table of the slope
// (float32) by h's bits, from the same chain, and an element costs ~15.
//
// Design: the rows are cut into chunks (geometry, which the wrapper asks
// through egovlp_bias_gelu_bwd_chunks to size `part`), and a work item is a
// slab of 32 16-byte vectors (a vector a lane) of every row of one chunk,
// the slab's bias read once into registers; a persistent grid of 2 blocks
// an SM, each filling its table once and walking the items blockIdx.x,
// blockIdx.x + gridDim.x, ...; a block's 16 warps take the chunk's rows in
// turn, one row at a time (two read slower: the loads of dg and y already
// overlap); a lane keeps its columns' sums in registers, and the block adds
// its warps' sums in warp order through shared memory.

#include <numeric>

#include "bias_gelu.cuh"

namespace egovlp {
namespace k7 {

constexpr int kSlab = 32;          // 16-byte vectors of a row a work item owns
constexpr int kMinBlocks = 2;      // blocks an SM the registers must allow
constexpr int kMinChunkRows = 64;  // fewest rows of a chunk: 4 a warp

// this lane's kN bias values rounded to T (zeros without a bias)
template <typename T, int kN>
__device__ __forceinline__ void load_bias(const float* bias, bool live, float (&b)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) b[i] = 0.f;
  if (bias == nullptr || !live) return;
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(bias + i);
    b[i] = rnd<T>(t.x);
    b[i + 1] = rnd<T>(t.y);
    b[i + 2] = rnd<T>(t.z);
    b[i + 3] = rnd<T>(t.w);
  }
}

// the launch's geometry over `rows` rows of `width` (kN columns a vector):
// the slabs of a row; the chunks of rows, the fewest that make the work
// items (slabs x chunks) a multiple of the persistent grid of kMinBlocks
// blocks an SM, so that every block walks as many, with no chunk under
// kMinChunkRows rows; and the grid
inline cudaError_t geometry(int rows, int width, int kN, int device, int* slabs, int* chunks,
                            int* grid) {
  DeviceLimits lim;
  const cudaError_t err = device_limits(device, &lim);
  if (err != cudaSuccess) return err;
  const int fill = kMinBlocks * lim.sms;
  *slabs = (width / kN + kSlab - 1) / kSlab;
  *chunks = std::max(1, std::min(fill / std::gcd(fill, *slabs),
                                 (rows + kMinChunkRows - 1) / kMinChunkRows));
  *grid = std::min(*slabs * *chunks, fill);
  return cudaSuccess;
}

template <typename T, bool kBias>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bwd_kernel(const T* __restrict__ dg, const T* __restrict__ y, const float* __restrict__ bias,
               T* __restrict__ dy, float* __restrict__ part, int rows, int width, int slabs,
               int chunks, float s, float ks) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kCols = kSlab * kN;  // columns of a slab
  constexpr bool kLookup = sizeof(T) == 2;
  // the slope of each table entry, then (with a bias) the warps' column
  // sums of an item, [kWarps][kCols]
  extern __shared__ __align__(16) unsigned char smem[];
  float* table = reinterpret_cast<float*>(smem);
  float* red = table + (kLookup ? kTable : 0);
  if constexpr (kLookup) {
    for (int i = threadIdx.x; i < kTable; i += kThreads)
      table[i] = slope_chain<T>(table_h(i), s, ks);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int item = blockIdx.x; item < slabs * chunks; item += gridDim.x) {
    const int slab = item % slabs;
    const int v = slab * kSlab + lane;
    const bool live = v < width / kN;
    float b[kN], acc[kN];
    load_bias<T>(kBias ? bias + static_cast<size_t>(v) * kN : nullptr, live, b);
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.f;
    int r0, r1;
    chunk_rows(rows, chunks, item / slabs, r0, r1);
    if (live) {
      const size_t col = static_cast<size_t>(v) * kN;
      for (int row = r0 + warp; row < r1; row += kWarps) {
        const size_t at = static_cast<size_t>(row) * width + col;
        float fg[kN], fy[kN];
        unpack(load16(dg + at), fg);
        unpack(load16(y + at), fy);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          // y itself without a bias: -0 stays -0, as in the PyTorch ops
          const float h = kBias ? rnd<T>(__fadd_rn(fy[i], b[i])) : fy[i];
          float d;
          if constexpr (kLookup) {
            const uint32_t t = table_index(h);
            d = t < kTable ? table[t] : slope_rare(h, s, ks);
          } else {
            d = slope_chain<T>(h, s, ks);
          }
          fg[i] = rnd<T>(__fmul_rn(fg[i], d));
          acc[i] = __fadd_rn(acc[i], fg[i]);
        }
        store16(dy + at, pack(fg));
      }
    }
    if constexpr (kBias) {
      // the item's column sums, its warps' added in warp order
#pragma unroll
      for (int i = 0; i < kN; ++i) red[warp * kCols + lane * kN + i] = acc[i];
      __syncthreads();
      for (int c = threadIdx.x; c < kCols; c += kThreads) {
        const int col = slab * kCols + c;
        if (col < width) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) sum = __fadd_rn(sum, red[w * kCols + c]);
          part[static_cast<size_t>(item / slabs) * width + col] = sum;
        }
      }
      __syncthreads();  // red is free for the next item
    }
  }
}

// dbias[c] = rnd(sum of part[k][c] over the chunks k), in a fixed order:
// warp w adds chunks w, w + kWarps, ..., then warp 0 adds the warps' sums
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias, int width,
                    int chunks) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (c < width)
    for (int k = warp; k < chunks; k += kWarps)
      sum = __fadd_rn(sum, part[static_cast<size_t>(k) * width + c]);
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < width) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, red[w][lane]);
    dbias[c] = rnd<T>(t);
  }
}

template <typename T>
int launch_bwd(const void* dg, const void* y, const void* bias, void* dy, void* part, void* dbias,
               int rows, int width, int part_rows, float s, float ks, int device,
               cudaStream_t stream) {
  const void* ptrs[3] = {dg, y, dy};
  cudaError_t err = check_launch(rows, width, 1, ptrs, 3, bias);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kN = Vec<T>::kN;
  int slabs = 0, chunks = 0, grid = 0;
  err = geometry(rows, width, kN, device, &slabs, &chunks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bias != nullptr && (part == nullptr || dbias == nullptr || part_rows < chunks))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((sizeof(T) == 2 ? kTable : 0) +
                       (bias != nullptr ? kWarps * kSlab * kN : 0)) * sizeof(float);
  const T* gt = static_cast<const T*>(dg);
  const T* yt = static_cast<const T*>(y);
  const float* bt = static_cast<const float*>(bias);
  T* dyt = static_cast<T*>(dy);
  float* pt = static_cast<float*>(part);
  if (bias == nullptr) {
    if (rows == 0) return static_cast<int>(cudaSuccess);
    bwd_kernel<T, false><<<grid, kThreads, smem, stream>>>(gt, yt, bt, dyt, pt, rows, width,
                                                           slabs, chunks, s, ks);
    return static_cast<int>(cudaGetLastError());
  }
  bwd_kernel<T, true><<<grid, kThreads, smem, stream>>>(gt, yt, bt, dyt, pt, rows, width, slabs,
                                                        chunks, s, ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bias_sum_kernel<T><<<(width + 31) / 32, kThreads, 0, stream>>>(pt, static_cast<float*>(dbias),
                                                                  width, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k7
}  // namespace egovlp

// dg, y, dy [rows, width] of `dtype`; bias float32 [width] or nullptr; with
// a bias, part float32 [part_rows, width] (scratch; part_rows at least the
// chunks, egovlp_bias_gelu_bwd_chunks) and dbias float32 [width], else
// both ignored; s = sqrt(0.5) rounded to `dtype`, ks = s * 2 / sqrt(pi) in
// float32.  Launches on `stream` of device `device`; returns a cudaError_t
// code.
extern "C" int egovlp_bias_gelu_bwd(const void* dg, const void* y, const void* bias, void* dy,
                                    void* part, void* dbias, int rows, int width, int part_rows,
                                    float s, float ks, int dtype, int device, void* stream) {
  if (device < 0 || device >= egovlp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const cudaError_t err = egovlp::k7::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k7::launch_bwd<__nv_bfloat16>(dg, y, bias, dy, part, dbias, rows, width,
                                                 part_rows, s, ks, device, st);
  if (dtype == egovlp::kFloat32)
    return egovlp::k7::launch_bwd<float>(dg, y, bias, dy, part, dbias, rows, width, part_rows, s,
                                         ks, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The chunks of rows K7-bwd cuts `rows` rows of `width` at `dtype` on
// `device` into (the rows its scratch `part` needs), into *chunks; returns
// a cudaError_t code.
extern "C" int egovlp_bias_gelu_bwd_chunks(int rows, int width, int dtype, int device,
                                           int* chunks) {
  if (device < 0 || device >= egovlp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (rows < 0 || width <= 0 || width % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != egovlp::kBFloat16 && dtype != egovlp::kFloat32)
    return static_cast<int>(cudaErrorInvalidValue);
  int slabs = 0, grid = 0;
  return static_cast<int>(egovlp::k7::geometry(rows, width, dtype == egovlp::kBFloat16 ? 8 : 4,
                                               device, &slabs, chunks, &grid));
}
