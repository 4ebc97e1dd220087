// Tensor-core forward of grouped softmax attention with a CLS key / value
// row, for bf16 on sm_90a: the one body of K1-fwd (space_attention_fwd.cu)
// and K4-fwd (grouped_attention_fwd.cu) at bf16, with the rounding policy
// of each Pallas kernel as a template parameter.  The float32 launches of
// both keep their scalar bodies: tensor cores at float32 would be TF32,
// which rounds the products.
//
// What it computes: q, k, v, out are [B, G, L, D] with D = H * hd (heads
// sliced from D by stride; K4 launches it with H 1, D = hd on its [BH, G,
// L, hd] groups); cls_k, cls_v are [B, 1, D].  For each (b, group g, head
// h) the L queries attend over the L + 1 keys [cls_k; k[b, g]] and return
// the softmax-weighted sum of [cls_v; v[b, g]].  Rounding points:
//
//   kSpace (K1, pallas_attention.py _mk_space_fwd_bsd_v2 :473-480, _v3
//   :590-602): qs = round(q * scale * log2(e)); float32 logits in log2
//   units; e = exp2(s - rowmax); out = round(round(e) V * (1 / rowsum(e))).
//   kGrouped (K4, _fwd_kernel :40-51): q as given (already scaled); e =
//   exp(s - rowmax), taken as exp2((s - rowmax) log2(e)); out =
//   round(round(e / rowsum(e)) V), the division correctly rounded.
//
// What bounds it on an H100: device memory.  At [16, 4, 196, 768] the
// launch must move 77 MB (q, k, v in, out out: 0.023 ms at 3.35 TB/s) and
// do 7.6 GFLOP (0.008 ms at the 989 TFLOP/s bf16 tensor-core peak); the
// scalar body ran both products as one CUDA-core FMA per K or V element
// read from shared memory, ~50x its bound.  This body runs ~3.5x the
// bound on an H100 80GB HBM3 at 700 W (chip_smoke.py); its time goes to
// the two products and the softmax between them, not to the copies: each
// 16-row warp tile re-reads all of K and V through ldmatrix, and only two
// CTAs (8 warps) share an SM to hide the latencies.
//
// Design: one CTA of 4 warps per (b, g, h).  It copies [cls_k; k] and
// [cls_v; v] of its head into shared memory with 16-byte cp.async (two
// commit groups, so the V copy overlaps the logits of the first query
// tiles), rows padded by 16 bytes so that ldmatrix is free of bank
// conflicts, and the key rows past L + 1 zeroed up to a multiple of 16.
// Each warp takes 16-row query tiles (tiles w, w + 4, ...): it loads its Q
// fragment straight from global memory, all loads in flight at once (kSpace
// scales and rounds it in registers; the first tile's loads overlap the K
// copy), runs S = Q K^T with mma.sync m16n8k16 (K fragments from
// ldmatrix.x4) and keeps the whole 16 x 16*KT logit tile in registers, so
// one softmax pass sees the full row: no online rescale, every exponential
// is taken against the row's true max, at JAX's rounding points.  Row max
// and sum reduce over the 4 lanes that share a row.  The S accumulators
// are repacked as bf16 pairs straight into the A fragments of O = P V (the
// m16n8 C layout is the m16n8k16 A layout), V comes in by
// ldmatrix.x4.trans, and O accumulates in float32; the warp's output tile
// goes out through shared memory as whole 16-byte chunks of each row.
// Shared memory at L 196, hd 64: 67.5 KB; two CTAs an SM (the register
// file's limit at ~200 registers a thread), so one's copies overlap the
// other's products.  Limits: L + 1 <= 256 keys (16 key tiles of logits in
// registers), hd a multiple of 16 up to 128; the launcher refuses other
// shapes.  wgmma's 64-row tiles, TMA and a persistent grid are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace egovlp {

enum class FwdRounding { kSpace, kGrouped };

namespace mma_fwd {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeys = 256;
constexpr int kMaxHd = 128;

// staged K / V row stride in elements: hd plus 16 bytes, so the 8 rows an
// ldmatrix reads start in 8 distinct 16-byte bank groups
__host__ __device__ constexpr int row_stride(int hd) { return hd + 8; }

// K and V (key_tiles * 16 rows each), then one 16-row output tile a warp
inline size_t smem_bytes(int key_tiles, int hd) {
  return (2 * static_cast<size_t>(key_tiles) + kWarps) * 16 * row_stride(hd) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x; results below 2^-126 flush to zero (under a bf16 ulp of any row
// sum, which holds the row max's term 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b, correctly rounded for a in [0, 1] and b >= 1, from r = 1 / b
// (correctly rounded) and one FMA correction of the remainder
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float y = a * r;
  return fmaf(fmaf(-y, b, a), r, y);
}

// The Q fragments (A of S = Q K^T) of query rows row0 and row0 + 8, straight
// from global memory: a[ks] = {(row0, lo), (row0 + 8, lo), (row0, hi),
// (row0 + 8, hi)} for dims ks * 16 + {0, 8} + 2 tq + {0, 1}; rows past L are
// zero.  kSpace scales by qscale = scale * log2(e) and rounds to bf16.  All
// 4 * HD / 16 loads are issued before any is used: scaling each load's
// value next to it serialised their round trips.
template <FwdRounding R, int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4], const bf16* q_group, int D,
                                       int L, int row0, int tq, float qscale) {
  const bool in0 = row0 < L, in1 = row0 + 8 < L;
  const unsigned int* r0 = reinterpret_cast<const unsigned int*>(
      q_group + static_cast<size_t>(in0 ? row0 : 0) * D + 2 * tq);
  const unsigned int* r1 = reinterpret_cast<const unsigned int*>(
      q_group + static_cast<size_t>(in1 ? row0 + 8 : 0) * D + 2 * tq);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {  // 4-byte words: 8 a 16-dim step
    qa[ks][0] = __ldg(r0 + ks * 8);
    qa[ks][1] = __ldg(r1 + ks * 8);
    qa[ks][2] = __ldg(r0 + ks * 8 + 4);
    qa[ks][3] = __ldg(r1 + ks * 8 + 4);
  }
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int part = 0; part < 4; ++part) {
      uint32_t u = (part % 2 ? in1 : in0) ? qa[ks][part] : 0u;
      if (R == FwdRounding::kSpace) {
        const float2 f = unpack_bf16(u);
        u = pack_bf16(f.x * qscale, f.y * qscale);
      }
      qa[ks][part] = u;
    }
  }
}

// HD: head width; KT: 16-key tiles of logits held in registers (13 or 16,
// >= the launch's (L + 1) / 16, rounded up).  Two CTAs an SM leave up to 255
// registers a thread, so no instantiation spills (three would cap them at
// 168, and the L 196, hd 64 body then spills ~100 bytes and runs slower).
template <FwdRounding R, int HD, int KT>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ cls_k,
                         const bf16* __restrict__ cls_v, bf16* __restrict__ out, int G, int L,
                         int D, int H, float qscale) {
  constexpr int RS = row_stride(HD);
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a head row
  extern __shared__ __align__(16) unsigned char smem[];
  const int lk = L + 1;
  const int nkt = (lk + 15) / 16;  // key tiles of this launch, <= KT
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + static_cast<size_t>(nkt) * 16 * RS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bf16* o_s = v_s + static_cast<size_t>(nkt + warp) * 16 * RS;  // this warp's output tile

  const int h = blockIdx.x % H;
  const int bg = blockIdx.x / H;  // b * G + g
  const int b = bg / G;
  const size_t grid_off = static_cast<size_t>(bg) * L * D + static_cast<size_t>(h) * HD;
  const size_t cls_off = static_cast<size_t>(b) * D + static_cast<size_t>(h) * HD;

  // row 0 is the CLS token, rows 1..L the group's tokens; K, then V
  for (int c = threadIdx.x; c < lk * kChunks; c += kThreads) {
    const int r = c / kChunks, x = (c % kChunks) * 8;
    const size_t src = r == 0 ? cls_off + x : grid_off + static_cast<size_t>(r - 1) * D + x;
    cp_async16(smem_addr(k_s + r * RS + x), (r == 0 ? cls_k : k) + src);
  }
  cp_async_commit();
  for (int c = threadIdx.x; c < lk * kChunks; c += kThreads) {
    const int r = c / kChunks, x = (c % kChunks) * 8;
    const size_t src = r == 0 ? cls_off + x : grid_off + static_cast<size_t>(r - 1) * D + x;
    cp_async16(smem_addr(v_s + r * RS + x), (r == 0 ? cls_v : v) + src);
  }
  cp_async_commit();
  // padded key rows: zero logits (masked below) and zero values, so that
  // p = 0 meets a finite V
  for (int c = threadIdx.x; c < (nkt * 16 - lk) * kChunks; c += kThreads) {
    const int r = lk + c / kChunks, x = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(k_s + r * RS + x) = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(v_s + r * RS + x) = make_uint4(0u, 0u, 0u, 0u);
  }
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair
  const int nqt = (L + 15) / 16;
  const bf16* q_group = q + grid_off;
  // the first Q tile's loads overlap the K copy
  uint32_t qa[HD / 16][4];
  if (warp < nqt) load_q<R, HD>(qa, q_group, D, L, warp * 16 + gq, tq, qscale);
  cp_async_wait<1>();  // K has landed
  __syncthreads();

  // ldmatrix: lane supplies row (lane % 8) of 8 x 8 matrix (lane / 8).
  // K, for S = Q K^T: matrix m holds keys (m / 2) * 8.., dims (m % 2) * 8..
  // -> B fragments (b0, b1) of the two 8-key halves of a 16-key tile.
  // V, transposed, for O = P V: matrix m holds keys (m % 2) * 8.., dims
  // (m / 2) * 8.. -> B fragments of two 8-column slices of the output.
  const int lrow = lane % 8, lmat = lane / 8;
  const uint32_t k_lane = smem_addr(k_s + (lrow + (lmat / 2) * 8) * RS + (lmat % 2) * 8);
  const uint32_t v_lane = smem_addr(v_s + (lrow + (lmat % 2) * 8) * RS + (lmat / 2) * 8);

  const int rounds = (nqt + kWarps - 1) / kWarps;
  for (int it = 0; it < rounds; ++it) {
    const int qt = it * kWarps + warp;
    const bool active = qt < nqt;  // the whole warp takes one branch
    const int row0 = qt * 16 + gq, row1 = row0 + 8;  // this lane's two query rows
    uint32_t pa[KT][4];  // P as A fragments of O = P V, one per 16-key tile
    float norm0 = 1.f, norm1 = 1.f;  // kSpace: 1 / rowsum
    if (active) {
      if (it > 0) load_q<R, HD>(qa, q_group, D, L, row0, tq, qscale);
      float s[2 * KT][4];
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < nkt) {
#pragma unroll
          for (int ks = 0; ks < HD / 16; ++ks) {
            uint32_t bk[4];
            ldmatrix_x4(k_lane + (kt * 16 * RS + ks * 16) * sizeof(bf16), bk);
            mma_bf16(s[2 * kt], qa[ks], bk[0], bk[1]);
            mma_bf16(s[2 * kt + 1], qa[ks], bk[2], bk[3]);
          }
        }
      }
      // s[j][0..1]: row0, keys 8j + 2tq + {0, 1}; s[j][2..3]: row1, same keys
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        if (j < 2 * nkt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (8 * j + 2 * tq + e >= lk) s[j][e] = s[j][2 + e] = -INFINITY;
            m0 = fmaxf(m0, s[j][e]);
            m1 = fmaxf(m1, s[j][2 + e]);
          }
        }
      }
      // finite: the CLS key is in every row.  kGrouped takes exp(x) as
      // exp2(x * log2(e)), so both scale the max once
      const float to_log2 = R == FwdRounding::kSpace ? 1.f : static_cast<float>(kLog2e);
      const float mx0 = quad_max(m0) * to_log2;
      const float mx1 = quad_max(m1) * to_log2;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        if (j < 2 * nkt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[j][e] = exp2_ftz(fmaf(s[j][e], to_log2, -mx0));
            s[j][2 + e] = exp2_ftz(fmaf(s[j][2 + e], to_log2, -mx1));
            sum0 += s[j][e];
            sum1 += s[j][2 + e];
          }
        }
      }
      const float total0 = quad_sum(sum0);
      const float total1 = quad_sum(sum1);
      if (R == FwdRounding::kSpace) {  // round(e) V, then * (1 / rowsum)
        norm0 = 1.f / total0;
        norm1 = 1.f / total1;
      } else {  // round(e / rowsum) V
        const float r0 = __frcp_rn(total0), r1 = __frcp_rn(total1);
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          if (j < 2 * nkt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[j][e] = div_by(s[j][e], total0, r0);
              s[j][2 + e] = div_by(s[j][2 + e], total1, r1);
            }
          }
        }
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < nkt) {
          pa[kt][0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
          pa[kt][1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
          pa[kt][2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
          pa[kt][3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
        }
      }
    }
    if (it == 0) {  // every warp: V has landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (active) {
      float o[HD / 8][4];
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < nkt) {
#pragma unroll
          for (int dp = 0; dp < HD / 16; ++dp) {
            uint32_t bv[4];
            ldmatrix_x4_trans(v_lane + (kt * 16 * RS + dp * 16) * sizeof(bf16), bv);
            mma_bf16(o[2 * dp], pa[kt], bv[0], bv[1]);
            mma_bf16(o[2 * dp + 1], pa[kt], bv[2], bv[3]);
          }
        }
      }
      // o[j][0..1]: row0, columns 8j + 2tq + {0, 1}; o[j][2..3]: row1.  The
      // tile goes through shared memory so that 8 lanes store each row's
      // HD * 2 bytes as whole 16-byte chunks.
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        *reinterpret_cast<uint32_t*>(o_s + gq * RS + col) =
            pack_bf16(o[j][0] * norm0, o[j][1] * norm0);
        *reinterpret_cast<uint32_t*>(o_s + (gq + 8) * RS + col) =
            pack_bf16(o[j][2] * norm1, o[j][3] * norm1);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16 * kChunks / 32; ++i) {
        const int c = lane + 32 * i;
        const int r = c / kChunks, x = (c % kChunks) * 8;
        if (qt * 16 + r < L)
          *reinterpret_cast<uint4*>(out + grid_off + static_cast<size_t>(qt * 16 + r) * D + x) =
              *reinterpret_cast<const uint4*>(o_s + r * RS + x);
      }
      __syncwarp();  // the tile is read before the next round overwrites it
    }
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const bf16*, bf16*,
                        int, int, int, int, float);

template <FwdRounding R, int HD>
Kernel pick_key_tiles(int nkt) {
  // 13 key tiles = 208 keys hold n 196, the patch count of every model
  // config, in 30 fewer registers a thread than 16 (the most the kernel
  // takes), which runs the L 196 launch ~4% slower
  return nkt <= 13 ? attention_fwd_mma_kernel<R, HD, 13> : attention_fwd_mma_kernel<R, HD, 16>;
}

// The instantiation for (L, hd), or nullptr where the kernel refuses it.
template <FwdRounding R>
Kernel pick_kernel(int L, int hd) {
  if (L < 1 || L + 1 > kMaxKeys) return nullptr;
  const int nkt = (L + 16) / 16;
  switch (hd) {
    case 16: return pick_key_tiles<R, 16>(nkt);
    case 32: return pick_key_tiles<R, 32>(nkt);
    case 48: return pick_key_tiles<R, 48>(nkt);
    case 64: return pick_key_tiles<R, 64>(nkt);
    case 80: return pick_key_tiles<R, 80>(nkt);
    case 96: return pick_key_tiles<R, 96>(nkt);
    case 112: return pick_key_tiles<R, 112>(nkt);
    case 128: return pick_key_tiles<R, 128>(nkt);
    default: return nullptr;
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace mma_fwd

// Launches the bf16 tensor-core forward on [B, G, L, D] (heads sliced from
// D; K4 passes H 1, D = hd) with `scale` applied to q (kSpace; kGrouped
// takes q already scaled and ignores it).  Returns a cudaError_t code:
// cudaErrorInvalidValue for L + 1 > 256 keys, hd not a multiple of 16 in
// [16, 128], a pointer not 16-byte aligned, or more shared memory than the
// device allows a block.
template <FwdRounding R>
int launch_attention_fwd_mma(const void* q, const void* k, const void* v, const void* ck,
                             const void* cv, void* out, int B, int G, int L, int D, int H,
                             float scale, int device, cudaStream_t stream) {
  using namespace mma_fwd;
  const int hd = D / H;
  const Kernel kernel = pick_kernel<R>(L, hd);
  if (kernel == nullptr || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(ck) ||
      !aligned16(cv) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes((L + 16) / 16, hd);
  cudaError_t err = check_smem(smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctas = static_cast<unsigned>(B) * G * H;
  if (ctas == 0) return static_cast<int>(cudaSuccess);
  const float qscale =
      R == FwdRounding::kSpace ? static_cast<float>(static_cast<double>(scale) * kLog2e) : 1.f;
  kernel<<<ctas, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(ck), static_cast<const bf16*>(cv), static_cast<bf16*>(out), G, L,
      D, H, qscale);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes a thread and dynamic shared
// memory of the instantiation a bf16 launch at (L, hd) takes.
template <FwdRounding R>
int attention_fwd_mma_attributes(int L, int hd, int* regs, int* local_bytes, int* smem) {
  using namespace mma_fwd;
  const Kernel kernel = pick_kernel<R>(L, hd);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(smem_bytes((L + 16) / 16, hd));
  return static_cast<int>(cudaSuccess);
}

}  // namespace egovlp
