// Tensor-core backward of grouped softmax attention with a CLS key / value
// row, for bf16 on sm_90a: the one body of K1-bwd (space_attention_bwd.cu)
// and K4-bwd (grouped_attention_bwd.cu) at bf16, the backward twin of
// attention_fwd_mma.cuh, with the rounding policy of each Pallas kernel as
// a template parameter.  The float32 launches of both keep their scalar
// bodies: tensor cores at float32 would be TF32, which rounds the products.
//
// What it computes: q, k, v, do, dq, dk, dv are [B, G, L, D] with D = H * hd
// (heads sliced from D by stride; K4 launches it with H 1, D = hd on its
// [BH, G, L, hd] groups); cls_k, cls_v are [B, 1, D].  For each (b, group
// g, head h), with K = [cls_k; k[b, g]] and V = [cls_v; v[b, g]] (L + 1
// rows), recomputing the probabilities in float32 against each row's full
// max:
//
//   kSpace (K1, pallas_attention.py _mk_space_bwd_bsd_v2 :509-530, _v3
//   :625-666): qs = round(q * scale * log2(e)); s = qs K^T in log2 units;
//   p = exp2(s - rowmax) * (1 / rowsum); dp = do V^T;
//   dl = round(p * (dp - rowsum(dp * p)));
//   dq = (dl K) * scale, dK = (dl^T qs) * ln(2), dV = round(p)^T do.
//   kGrouped (K4, _bwd_kernel :54-101): q as given (already scaled);
//   p = exp(s - rowmax) / rowsum, taken as exp2 and a correctly rounded
//   division; dl rounded as above; dq = dl K, dK = dl^T q, dV = p^T do
//   with p UNROUNDED (do is widened to float32, :61, :90, :94): the bf16
//   product takes p as round(p) + round(p - round(p)), two mma.sync into
//   one float32 sum, which carries 16 bits of p.
//
// dq and the group rows of dK and dV are written in bf16; the CLS rows of
// dK and dV, this group's float32 share of the CLS gradients, go to the
// scratch [B, G, D] that the wrapper sums over the groups.
//
// What bounds it on an H100: on paper, device memory (at [16, 4, 196, 768]
// it must move 135 MB, 0.040 ms at 3.35 TB/s, and do 19 GFLOP of the five
// products, 0.019 ms at 989 TFLOP/s).  The scalar bodies ran every product
// as CUDA-core FMAs over shared memory, ~70x the bound.  This body runs the
// products on mma.sync and recomputes the probabilities twice (nine
// products instead of five; ten for K4, whose dV takes two), and runs ~6x
// the bound on an H100 80GB HBM3 at 700 W (chip_smoke.py).  What it leaves:
// at one CTA an SM the staging copies overlap no compute; with 8 warps an
// SM the dependent mma.sync -> exp2 -> mma.sync chains wait on latency; and
// each 16-row tile reads a fresh 16 x 16 B fragment per product from
// shared memory.
//
// Design: one CTA of 8 warps per (b, g, h), no atomics.  It copies qs, do,
// [cls_k; k] and [cls_v; v] of its head into shared memory with 16-byte
// cp.async (rows padded by 16 bytes so that ldmatrix is free of bank
// conflicts; query rows past L and key rows past L + 1 zeroed up to a
// multiple of 16; kSpace scales and rounds q in place).  Then two phases:
//   1. Each warp takes 16-row query tiles (w, w + 8, ...), with the tile's
//      qs and do A fragments in registers.  A first pass over the 16-key
//      tiles runs S = qs K^T and dP = do V^T and keeps, per lane, an online
//      max, sum of e and sum of e * dp; the 4 lanes of a row then merge
//      them against the row's true max.  The row's max, sum, 1 / sum and
//      inner = sum(dp * p) go to shared memory.  A second pass recomputes S
//      and dP, forms round(dl) as A fragments in registers (the m16n8 C
//      layout is the m16n8k16 A layout) and accumulates dq = dl K (K by
//      ldmatrix.trans) in float32; the warp writes its dq rows.
//   2. After a barrier, each warp takes 16-key tiles (w, w + 8, ...), with
//      the tile's K and V A fragments in registers, and runs over the query
//      tiles: S^T = K qs^T and dP^T = V do^T, p^T and dl^T from the row
//      statistics, dK += dl^T qs and dV += p^T do (qs, do by
//      ldmatrix.trans), in float32 registers.  Its dK, dV tile goes out
//      through its own (no longer read) K and V rows in shared memory as
//      16-byte stores; the CLS key row goes to the float32 scratch.
// Each dq row and each dK / dV row is summed by one warp in a fixed order,
// so a launch's result does not change from run to run.  The probabilities
// are taken against the row's true max, as JAX takes them (only the row
// sum is gathered online, rescaled as the max grows); inner is formed from
// float32 p and dp, not as rowsum(do * out) from the bf16 forward output.
//
// Shared memory at L 196, hd 64: 120 KB (one CTA an SM, 8 warps, up to 255
// registers a thread).  Limits: L + 1 <= 256 keys and hd a multiple of 16
// up to 128, as the tensor-core forward; and the staged tiles must fit the
// device's opt-in shared memory, which at hd 112 and 128 holds L <= 224
// and L <= 207.  The launcher refuses other shapes.  The tile counts are
// runtime values: the body holds no per-tile state in registers, so unlike
// the forward it needs no instantiation per key-tile count.  wgmma, TMA,
// wider query tiles a warp (fewer B fragment reads) and a persistent grid
// are later work.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_sync.cuh"

namespace egovlp {
namespace mma_bwd {

using namespace mma;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxKeys = 256;

__host__ __device__ constexpr int query_tiles(int L) { return (L + 15) / 16; }
__host__ __device__ constexpr int key_tiles(int L) { return (L + 16) / 16; }

// qs and do (16 rows a query tile each), K and V (16 rows a key tile
// each), then four float32 statistics a query row
inline size_t smem_bytes(int L, int hd) {
  const size_t qrows = 16 * static_cast<size_t>(query_tiles(L));
  const size_t krows = 16 * static_cast<size_t>(key_tiles(L));
  return 2 * (qrows + krows) * row_stride(hd) * sizeof(bf16) + 4 * qrows * sizeof(float);
}

// s += a x^T over HD dims: a is the 16-row A operand (HD / 16 fragments),
// x_addr the lane's ldmatrix address of 16 staged rows, the n index of the
// two 8-column halves s[0], s[1]
template <int HD>
__device__ __forceinline__ void product_nt(float (&s)[2][4], const uint32_t (&a)[HD / 16][4],
                                           uint32_t x_addr) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t b[4];
    ldmatrix_x4(x_addr + ks * 16 * sizeof(bf16), b);
    mma_bf16(s[0], a[ks], b[0], b[1]);
    mma_bf16(s[1], a[ks], b[2], b[3]);
  }
}

// acc += a x for a 16 x 16 A fragment and the 16 staged rows x HD of x
// (rows are the k index; ldmatrix.trans at x_addr); kSplit adds a_lo x
// from the same B fragments
template <int HD, bool kSplit>
__device__ __forceinline__ void product_nn(float (&acc)[HD / 8][4], const uint32_t (&a)[4],
                                           const uint32_t (&a_lo)[4], uint32_t x_addr) {
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(x_addr + dp * 16 * sizeof(bf16), b);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    if (kSplit) {
      mma_bf16(acc[2 * dp], a_lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a_lo, b[2], b[3]);
    }
  }
}

// the HD / 16 A fragments of 16 staged rows (a_addr: the lane's address)
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4], uint32_t a_addr) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) ldmatrix_x4(a_addr + ks * 16 * sizeof(bf16), a[ks]);
}

// p from a logit s against the row's max mx (log2 units), sum and r = 1 / sum
template <Rounding R>
__device__ __forceinline__ float prob(float s, float to_log2, float mx, float sum, float r) {
  const float e = exp2_ftz(fmaf(s, to_log2, -mx));
  return R == Rounding::kSpace ? e * r : div_by(e, sum, r);
}

// HD: head width.  8 warps and one CTA an SM leave up to 255 registers a
// thread; the K and V fragments of phase 2 stay in registers up to hd 64
// and are re-read from shared memory past it.
template <Rounding R, int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ cls_k,
                         const bf16* __restrict__ cls_v, const bf16* __restrict__ dout,
                         bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ dcls_k, float* __restrict__ dcls_v, int G, int L,
                         int D, int H, float qscale, float dq_scale, float dk_scale) {
  constexpr int RS = row_stride(HD);
  constexpr int kChunks = HD / 8;  // 16-byte chunks of a head row
  constexpr bool kSplit = R == Rounding::kGrouped;
  constexpr bool kHoldKV = HD <= 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lk = L + 1;
  const int nqt = query_tiles(L), nkt = key_tiles(L);
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + static_cast<size_t>(nqt) * 16 * RS;
  bf16* k_s = do_s + static_cast<size_t>(nqt) * 16 * RS;
  bf16* v_s = k_s + static_cast<size_t>(nkt) * 16 * RS;
  float* max_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(nkt) * 16 * RS);
  float* sum_s = max_s + nqt * 16;
  float* rcp_s = sum_s + nqt * 16;
  float* inner_s = rcp_s + nqt * 16;

  const int h = blockIdx.x % H;
  const int bg = blockIdx.x / H;  // b * G + g
  const int b = bg / G;
  const size_t grid_off = static_cast<size_t>(bg) * L * D + static_cast<size_t>(h) * HD;
  const size_t cls_off = static_cast<size_t>(b) * D + static_cast<size_t>(h) * HD;

  // q and do rows 0..L-1; K and V row 0 the CLS token, rows 1..L the group
  for (int c = threadIdx.x; c < L * kChunks; c += kThreads) {
    const int r = c / kChunks, x = (c % kChunks) * 8;
    const size_t src = grid_off + static_cast<size_t>(r) * D + x;
    cp_async16(smem_addr(q_s + r * RS + x), q + src);
    cp_async16(smem_addr(do_s + r * RS + x), dout + src);
  }
  for (int c = threadIdx.x; c < lk * kChunks; c += kThreads) {
    const int r = c / kChunks, x = (c % kChunks) * 8;
    const size_t src = r == 0 ? cls_off + x : grid_off + static_cast<size_t>(r - 1) * D + x;
    cp_async16(smem_addr(k_s + r * RS + x), (r == 0 ? cls_k : k) + src);
    cp_async16(smem_addr(v_s + r * RS + x), (r == 0 ? cls_v : v) + src);
  }
  cp_async_commit();
  // padded rows: zero query rows give finite statistics that phase 2
  // masks; zero key rows meet masked logits
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < (nqt * 16 - L) * kChunks; c += kThreads) {
    const int r = L + c / kChunks, x = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(q_s + r * RS + x) = zero;
    *reinterpret_cast<uint4*>(do_s + r * RS + x) = zero;
  }
  for (int c = threadIdx.x; c < (nkt * 16 - lk) * kChunks; c += kThreads) {
    const int r = lk + c / kChunks, x = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(k_s + r * RS + x) = zero;
    *reinterpret_cast<uint4*>(v_s + r * RS + x) = zero;
  }
  cp_async_wait<0>();
  if (R == Rounding::kSpace) {  // qs = round(q * qscale), each thread on its own copies
    for (int c = threadIdx.x; c < L * kChunks; c += kThreads) {
      uint4* chunk = reinterpret_cast<uint4*>(q_s + (c / kChunks) * RS + (c % kChunks) * 8);
      uint4 u = *chunk;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(w[i]);
        w[i] = pack_bf16(f.x * qscale, f.y * qscale);
      }
      *chunk = u;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, column pair
  // ldmatrix: lane supplies row (lane % 8) of 8 x 8 matrix (lane / 8).
  // A operand of 16 rows: matrices (rows 0-7, 8-15) x (cols 0-7, 8-15).
  const int a_off = (lane % 16) * RS + (lane / 16) * 8;
  // x^T as B (rows are n): matrix m holds rows (m / 2) * 8.., cols
  // (m % 2) * 8.. -> B fragments of the two 8-row halves
  const int nt_off = (lane % 8 + (lane / 16) * 8) * RS + ((lane / 8) % 2) * 8;
  // x as B (rows are k), transposed: matrix m holds rows (m % 2) * 8..,
  // cols (m / 2) * 8.. -> B fragments of two 8-column slices
  const int nn_off = (lane % 8 + ((lane / 8) % 2) * 8) * RS + (lane / 16) * 8;
  constexpr uint32_t kTileBytes = 16 * RS * sizeof(bf16);
  const uint32_t q_base = smem_addr(q_s), do_base = smem_addr(do_s);
  const uint32_t k_base = smem_addr(k_s), v_base = smem_addr(v_s);
  const float to_log2 = R == Rounding::kSpace ? 1.f : static_cast<float>(kLog2e);
  const uint32_t no_lo[4] = {0u, 0u, 0u, 0u};

  // ---- phase 1: row statistics and dq, one query tile a warp at a time
  for (int qt = warp; qt < nqt; qt += kWarps) {
    const int row0 = qt * 16 + gq, row1 = row0 + 8;  // this lane's two query rows
    uint32_t qa[HD / 16][4], ga[HD / 16][4];
    load_a<HD>(qa, q_base + qt * kTileBytes + a_off * sizeof(bf16));
    load_a<HD>(ga, do_base + qt * kTileBytes + a_off * sizeof(bf16));
    // s[j][0..1]: row0, keys kt * 16 + 8j + 2tq + {0, 1}; s[j][2..3]: row1
    auto logits = [&](int kt, float (&s)[2][4], float (&g)[2][4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = g[j][0] = g[j][1] =
          g[j][2] = g[j][3] = 0.f;
      product_nt<HD>(s, qa, k_base + kt * kTileBytes + nt_off * sizeof(bf16));
      product_nt<HD>(g, ga, v_base + kt * kTileBytes + nt_off * sizeof(bf16));
      if (kt == nkt - 1) {  // keys past L + 1
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kt * 16 + 8 * j + 2 * tq + e >= lk) s[j][e] = s[j][2 + e] = -INFINITY;
      }
    };
    // pass 1: per lane, the running max of the raw logits and the sums of
    // e and e * dp against it
    float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.f, l1 = 0.f, i0 = 0.f, i1 = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      float s[2][4], g[2][4];
      logits(kt, s, g);
      float t0 = mx0, t1 = mx1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
        t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
      }
      // a lane whose keys so far are all masked keeps zero sums
      const float ref0 = t0 == -INFINITY ? 0.f : t0 * to_log2;
      const float ref1 = t1 == -INFINITY ? 0.f : t1 * to_log2;
      const float c0 = exp2_ftz(fmaf(mx0, to_log2, -ref0));
      const float c1 = exp2_ftz(fmaf(mx1, to_log2, -ref1));
      l0 *= c0, i0 *= c0, l1 *= c1, i1 *= c1;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float e0 = exp2_ftz(fmaf(s[j][e], to_log2, -ref0));
          const float e1 = exp2_ftz(fmaf(s[j][2 + e], to_log2, -ref1));
          l0 += e0, i0 = fmaf(e0, g[j][e], i0);
          l1 += e1, i1 = fmaf(e1, g[j][2 + e], i1);
        }
      }
      mx0 = t0, mx1 = t1;
    }
    // the row's true max (finite: the CLS key is in every row), and the
    // lanes' sums rescaled to it
    const float m0 = quad_max(mx0) * to_log2, m1 = quad_max(mx1) * to_log2;
    const float c0 = exp2_ftz(fmaf(mx0, to_log2, -m0)), c1 = exp2_ftz(fmaf(mx1, to_log2, -m1));
    const float sum0 = quad_sum(l0 * c0), sum1 = quad_sum(l1 * c1);
    const float r0 = __frcp_rn(sum0), r1 = __frcp_rn(sum1);
    const float in0 = quad_sum(i0 * c0) * r0, in1 = quad_sum(i1 * c1) * r1;
    if (tq == 0) {  // query rows past L: max +inf, so phase 2 takes p = 0
      max_s[row0] = row0 < L ? m0 : INFINITY;
      max_s[row1] = row1 < L ? m1 : INFINITY;
      sum_s[row0] = sum0, sum_s[row1] = sum1;
      rcp_s[row0] = r0, rcp_s[row1] = r1;
      inner_s[row0] = in0, inner_s[row1] = in1;
    }
    // pass 2: dq = round(dl) K
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      float s[2][4], g[2][4];
      logits(kt, s, g);
      uint32_t da[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p00 = prob<R>(s[j][0], to_log2, m0, sum0, r0);
        const float p01 = prob<R>(s[j][1], to_log2, m0, sum0, r0);
        const float p10 = prob<R>(s[j][2], to_log2, m1, sum1, r1);
        const float p11 = prob<R>(s[j][3], to_log2, m1, sum1, r1);
        da[2 * j] = pack_bf16(p00 * (g[j][0] - in0), p01 * (g[j][1] - in0));
        da[2 * j + 1] = pack_bf16(p10 * (g[j][2] - in1), p11 * (g[j][3] - in1));
      }
      product_nn<HD, false>(acc, da, no_lo, k_base + kt * kTileBytes + nn_off * sizeof(bf16));
    }
    // acc[j][0..1]: row0, columns 8j + 2tq + {0, 1}; acc[j][2..3]: row1
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      if (row0 < L)
        *reinterpret_cast<uint32_t*>(dq + grid_off + static_cast<size_t>(row0) * D + col) =
            pack_bf16(acc[j][0] * dq_scale, acc[j][1] * dq_scale);
      if (row1 < L)
        *reinterpret_cast<uint32_t*>(dq + grid_off + static_cast<size_t>(row1) * D + col) =
            pack_bf16(acc[j][2] * dq_scale, acc[j][3] * dq_scale);
    }
  }
  __syncthreads();  // every row's statistics are in shared memory

  // ---- phase 2: dK and dV, one key tile a warp at a time
  const size_t part_off = static_cast<size_t>(bg) * D + static_cast<size_t>(h) * HD;
  for (int kt = warp; kt < nkt; kt += kWarps) {
    const uint32_t ka_addr = k_base + kt * kTileBytes + a_off * sizeof(bf16);
    const uint32_t va_addr = v_base + kt * kTileBytes + a_off * sizeof(bf16);
    uint32_t ka[HD / 16][4], va[HD / 16][4];
    if (kHoldKV) {
      load_a<HD>(ka, ka_addr);
      load_a<HD>(va, va_addr);
    }
    float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = dva[j][0] = dva[j][1] = dva[j][2] =
          dva[j][3] = 0.f;
    for (int qt = 0; qt < nqt; ++qt) {
      if (!kHoldKV) {
        load_a<HD>(ka, ka_addr);
        load_a<HD>(va, va_addr);
      }
      // st[j][0..1]: key kt * 16 + gq, queries qt * 16 + 8j + 2tq + {0, 1};
      // st[j][2..3]: key + 8, the same queries
      float st[2][4] = {}, gt[2][4] = {};
      product_nt<HD>(st, ka, q_base + qt * kTileBytes + nt_off * sizeof(bf16));
      product_nt<HD>(gt, va, do_base + qt * kTileBytes + nt_off * sizeof(bf16));
      uint32_t da[4], pa[4], pl[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = qt * 16 + 8 * j + 2 * tq;
        const float2 mx = *reinterpret_cast<const float2*>(max_s + col);
        const float2 sm = *reinterpret_cast<const float2*>(sum_s + col);
        const float2 rc = *reinterpret_cast<const float2*>(rcp_s + col);
        const float2 in = *reinterpret_cast<const float2*>(inner_s + col);
        const float p00 = prob<R>(st[j][0], to_log2, mx.x, sm.x, rc.x);
        const float p01 = prob<R>(st[j][1], to_log2, mx.y, sm.y, rc.y);
        const float p10 = prob<R>(st[j][2], to_log2, mx.x, sm.x, rc.x);
        const float p11 = prob<R>(st[j][3], to_log2, mx.y, sm.y, rc.y);
        da[2 * j] = pack_bf16(p00 * (gt[j][0] - in.x), p01 * (gt[j][1] - in.y));
        da[2 * j + 1] = pack_bf16(p10 * (gt[j][2] - in.x), p11 * (gt[j][3] - in.y));
        pa[2 * j] = pack_bf16(p00, p01);
        pa[2 * j + 1] = pack_bf16(p10, p11);
        if (kSplit) {  // the part of p that round(p) drops
          const float2 h0 = unpack_bf16(pa[2 * j]), h1 = unpack_bf16(pa[2 * j + 1]);
          pl[2 * j] = pack_bf16(p00 - h0.x, p01 - h0.y);
          pl[2 * j + 1] = pack_bf16(p10 - h1.x, p11 - h1.y);
        }
      }
      product_nn<HD, false>(dka, da, no_lo, q_base + qt * kTileBytes + nn_off * sizeof(bf16));
      product_nn<HD, kSplit>(dva, pa, pl, do_base + qt * kTileBytes + nn_off * sizeof(bf16));
    }
    // dka[j][0..1]: key kt * 16 + gq, columns 8j + 2tq + {0, 1};
    // dka[j][2..3]: key + 8.  The CLS key (key 0) goes to the float32
    // scratch; the tile's bf16 rows go out through this warp's K and V rows
    // of shared memory, which no warp reads any more
    if (kt == 0 && gq == 0) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(dcls_k + part_off + col) =
            make_float2(dka[j][0] * dk_scale, dka[j][1] * dk_scale);
        *reinterpret_cast<float2*>(dcls_v + part_off + col) = make_float2(dva[j][0], dva[j][1]);
      }
    }
    bf16* dk_t = k_s + static_cast<size_t>(kt) * 16 * RS;
    bf16* dv_t = v_s + static_cast<size_t>(kt) * 16 * RS;
    __syncwarp();  // every lane's K / V fragment reads are done
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      *reinterpret_cast<uint32_t*>(dk_t + gq * RS + col) =
          pack_bf16(dka[j][0] * dk_scale, dka[j][1] * dk_scale);
      *reinterpret_cast<uint32_t*>(dk_t + (gq + 8) * RS + col) =
          pack_bf16(dka[j][2] * dk_scale, dka[j][3] * dk_scale);
      *reinterpret_cast<uint32_t*>(dv_t + gq * RS + col) = pack_bf16(dva[j][0], dva[j][1]);
      *reinterpret_cast<uint32_t*>(dv_t + (gq + 8) * RS + col) = pack_bf16(dva[j][2], dva[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16 * kChunks / 32; ++i) {
      const int c = lane + 32 * i;
      const int r = c / kChunks, x = (c % kChunks) * 8;
      const int key = kt * 16 + r;  // group row key - 1
      if (key >= 1 && key <= L) {
        const size_t dst = grid_off + static_cast<size_t>(key - 1) * D + x;
        *reinterpret_cast<uint4*>(dk + dst) = *reinterpret_cast<const uint4*>(dk_t + r * RS + x);
        *reinterpret_cast<uint4*>(dv + dst) = *reinterpret_cast<const uint4*>(dv_t + r * RS + x);
      }
    }
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const bf16*,
                        const bf16*, bf16*, bf16*, bf16*, float*, float*, int, int, int, int,
                        float, float, float);

// The instantiation for (L, hd), or nullptr where the kernel refuses it.
template <Rounding R>
Kernel pick_kernel(int L, int hd) {
  if (L < 1 || L + 1 > kMaxKeys) return nullptr;
  switch (hd) {
    case 16: return attention_bwd_mma_kernel<R, 16>;
    case 32: return attention_bwd_mma_kernel<R, 32>;
    case 48: return attention_bwd_mma_kernel<R, 48>;
    case 64: return attention_bwd_mma_kernel<R, 64>;
    case 80: return attention_bwd_mma_kernel<R, 80>;
    case 96: return attention_bwd_mma_kernel<R, 96>;
    case 112: return attention_bwd_mma_kernel<R, 112>;
    case 128: return attention_bwd_mma_kernel<R, 128>;
    default: return nullptr;
  }
}

}  // namespace mma_bwd

// Launches the bf16 tensor-core backward on [B, G, L, D] (heads sliced
// from D; K4 passes H 1, D = hd) with `scale` applied to q (kSpace; kGrouped
// takes q already scaled and ignores it).  dcls_k, dcls_v: float32
// [B, G, D], each group's share of the CLS grads.  Returns a cudaError_t
// code: cudaErrorInvalidValue for L + 1 > 256 keys, hd not a multiple of 16
// in [16, 128], a pointer not 16-byte aligned, or more shared memory than
// the device allows a block.
template <Rounding R>
int launch_attention_bwd_mma(const void* q, const void* k, const void* v, const void* ck,
                             const void* cv, const void* dout, void* dq, void* dk, void* dv,
                             void* dck, void* dcv, int B, int G, int L, int D, int H, float scale,
                             int device, cudaStream_t stream) {
  using namespace mma_bwd;
  const Kernel kernel = pick_kernel<R>(L, D / H);
  if (kernel == nullptr || !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(ck) ||
      !aligned16(cv) || !aligned16(dout) || !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(L, D / H);
  cudaError_t err = check_smem(smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctas = static_cast<unsigned>(B) * G * H;
  if (ctas == 0) return static_cast<int>(cudaSuccess);
  const bool space = R == Rounding::kSpace;
  kernel<<<ctas, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(ck), static_cast<const bf16*>(cv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dck), static_cast<float*>(dcv), G, L, D, H,
      space ? static_cast<float>(static_cast<double>(scale) * kLog2e) : 1.f,
      space ? scale : 1.f, space ? kLn2 : 1.f);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, local (spill) bytes a thread and dynamic shared
// memory of the instantiation a bf16 launch at (L, hd) takes.
template <Rounding R>
int attention_bwd_mma_attributes(int L, int hd, int* regs, int* local_bytes, int* smem) {
  using namespace mma_bwd;
  const Kernel kernel = pick_kernel<R>(L, hd);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<int>(smem_bytes(L, hd));
  return static_cast<int>(cudaSuccess);
}

}  // namespace egovlp
