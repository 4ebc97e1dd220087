// The 16-byte streaming bodies of the time-attention kernels, forward and
// backward: K2 (time_attention_fwd.cu, time_attention_bwd.cu) on
// [B, F, N, D] with heads sliced from D, and K5 (time_attention_hs_fwd.cu,
// time_attention_hs_bwd.cu) on the head-split [BH, F, N, hd].
//
// Layout of the work.  Each frame row of a patch column is a contiguous
// hd-wide run of memory.  A lane owns one 16-byte slice of a row: 8
// channels at bf16, 4 at float32.  P lanes (a power of two, 8 to 32) hold
// one head: hd / (16 bytes) of them carry channels, the rest of the P (hd
// not a power of two) hold zeros.  A warp holds 32 / P head groups, and
// every lane of a group ends a dot product with the group's whole sum
// after log2(P) xor shuffles, so all of them run the softmax.
//  - K2: a warp takes one patch column of one b and a slice of 32 / P
//    heads of its D-wide rows (4 heads of hd 64 at bf16: 512 contiguous
//    bytes a row).
//  - K5: for one bh and one frame the rows of consecutive patch columns
//    are contiguous, so a warp takes 32 / P adjacent columns of one bh,
//    group g column j0 + g (4 columns of hd 64 at bf16: again 512
//    contiguous bytes a row).  All groups read the one CLS row of the bh;
//    a group whose column is past N loads nothing and stores nothing.
//
// Forward.  A lane issues its loads of the column's F + 1 key and value
// rows (and, up to 8 frames, its F query rows) before the first use, and
// keeps them in registers as raw bits: no shared memory and no block
// barrier.  Per query it takes its partial dot products with the F + 1
// keys, completes them with xor shuffles over its group, runs the softmax
// in registers, and writes its slice of the output row as one 16-byte
// store.  Past 8 frames the query rows are loaded one ahead of their use
// instead, which keeps the 16-frame instantiation within the register
// file.  K2 sums e.v and divides by the row sum once, as its Pallas body
// does; K5 forms p = e / rowsum first and then sums p.v, as its Pallas
// body does (pallas_attention.py::_time_fwd_kernel).
//
// Backward.  A warp walks a run of kRun adjacent warp columns of one b (or
// bh) in a fixed order: 4 patch columns for K2, one block of 32 / P
// columns for K5.  For each:
//  1. a lane loads its slices of the F + 1 key and value rows (and, up to
//     4 frames, the F query and output-gradient rows) before their first
//     use, and keeps them in registers as raw bits;
//  2. per query, the partial logits and dp of its F + 1 keys, completed
//     with xor shuffles over its group; the softmax, p and dl in
//     registers; dq's slice written as one 16-byte store; p and dl kept in
//     a small per-warp table in shared memory (F (F + 1) floats each a
//     group, the rows of a group at an odd stride, so the groups read it
//     without bank conflicts);
//  3. per key, dK = sum over queries of dl qa and dV of p do, from the
//     table and the query and output-gradient rows (past 4 frames
//     reloaded here, from the cache, instead of held), written as 16-byte
//     stores; the CLS key's rows are added to the run's float32 sums.
// Only the warp itself reads its table (__syncwarp, no block barrier).
// After the run, K5's groups sum their CLS grads over the warp with xor
// shuffles (they share the CLS row); the run's sums go to float32 scratch
// [B, runs, D] (K2) or [BH, runs, hd] (K5), which the wrapper sums over the
// runs and casts once.  A warp walks its run in turn, one column's loads
// after the last one's stores, so a run costs warps in flight: K5's warps,
// which sum over 32 / P columns already, take one block each (at F 4, hd
// 64, bf16 this took K5-bwd from 82.8 to 57.2 us on an H100 80GB HBM3 at
// 700 W; scripts/torch_time_stream_sweep.py).  No atomics: every output
// element has one writer, and two launches give the same bits.
//
// Shapes: F from 1 to kFrameCap (instantiations hold 4, 8 or 16 frames),
// any N, hd a multiple of the slice's kN channels and at most 32 slices,
// 16-byte aligned tensors, at most 2^31 - 1 warps (far past the card's
// memory).  launch_fwd and launch_bwd refuse any other shape
// (cudaErrorInvalidValue) and launch nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace egovlp {
namespace k2 {

constexpr int kWarps = 4;  // warps a CTA
constexpr int kFrameCap = 16;  // the most frames an instantiation holds
// warp columns a warp of the backward walks: the wrappers' CLS scratch has
// ceil(warp columns / kRun) rows a b (kernels/cuda_attention.py,
// TIME_BWD_RUN for K2, time_hs_bwd_parts for K5)
template <bool kSplit>
constexpr int kRun = kSplit ? 1 : 4;

// One lane's 16-byte slice of a row, as raw bits; kN channels.
template <typename T>
struct Slice;

// to_f widens a slice to floats.  Its `salt` (the query or key the caller
// is working on) enters the unpacking as an operand, so the compiler
// neither hoists a held row's unpacking out of a loop nor keeps one
// unpacking live across the unrolled iterations: it unpacks each row where
// it is used, and the rows stay in registers as raw bits (at bf16, half
// the registers of floats).
template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void to_f(const uint4& u, float* f, int salt) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float is exact: the high half
      asm("// %2\n\tshl.b32 %0, %1, 16;" : "=f"(f[2 * i]) : "r"(w[i]), "r"(salt));
      asm("// %2\n\tand.b32 %0, %1, 0xffff0000;" : "=f"(f[2 * i + 1]) : "r"(w[i]), "r"(salt));
    }
  }
  // round to nearest even, as torch's casts do
  static __device__ __forceinline__ uint4 from_f(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Slice<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void to_f(const uint4& u, float* f, int salt) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) asm("// %2\n\tmov.b32 %0, %1;" : "=f"(f[i]) : "r"(w[i]), "r"(salt));
  }
  static __device__ __forceinline__ uint4 from_f(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <typename T>
__device__ __forceinline__ uint4 load(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// the slice at `p` if `in`, else zeros (a lane without channels, a frame
// past F, a column past N)
template <typename T>
__device__ __forceinline__ uint4 load_if(bool in, const T* p) {
  return in ? load(p) : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T>
__device__ __forceinline__ void store(T* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// lanes a head takes: a power of two from 8 to 32 that holds hd / kN slices
__host__ __device__ inline int lanes_per_head(int hd, int kn) {
  int p = 8;
  while (p * kn < hd) p <<= 1;
  return p;
}

// A shape the streaming bodies take: F from 1 to kFrameCap, hd a multiple of
// the lane's kN channels and at most 32 of them.
inline bool takes(int F, int hd, int kn) {
  return F >= 1 && F <= kFrameCap && hd % kn == 0 && hd / kn <= 32;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The work of one launch, on [B, F, N, D] with H heads of hd = D / H.
//  - K2 (kSplit false): a warp column is one patch column; `slices` warps
//    take it, 32 / P heads each.
//  - K5 (kSplit true, B = BH, D = hd, H = 1): a warp column is 32 / P
//    adjacent patch columns, one a group; one warp takes it.
struct Grid {
  int F, N;
  int D, hd, H;  // elements of a row, of a head; heads of a row
  int P;       // lanes a head
  int slices;  // warps a warp column
  int cols;    // warp columns a b
  int runs;    // runs of kRun warp columns a b (the backward's warps)
  long long warps;
  float scale;  // of q (K5: 1, its q comes scaled)
};

template <bool kSplit>
inline Grid make_grid(int B, int F, int N, int D, int H, int kn, float scale, bool bwd) {
  Grid g;
  g.F = F;
  g.N = N;
  g.D = D;
  g.hd = D / H;
  g.H = H;
  g.P = lanes_per_head(g.hd, kn);
  const int groups = 32 / g.P;
  g.slices = kSplit ? 1 : (H + groups - 1) / groups;
  g.cols = kSplit ? (N + groups - 1) / groups : N;
  g.runs = (g.cols + kRun<kSplit> - 1) / kRun<kSplit>;
  g.warps = static_cast<long long>(B) * (bwd ? g.runs : g.cols) * g.slices;
  g.scale = scale;
  return g;
}

// The lane's place in the warps of b (slice s): head group g, lane r in it;
// `off`, its first channel in a row and in the CLS row of b; `chan` if it
// carries channels of a head (K2: of a head that exists); then, for warp
// column w, its patch column, whether it is `active` (it carries channels
// of a column that exists) and its slice of the column's frame-0 row.
template <bool kSplit>
struct Lane {
  int r, g, off;
  bool chan;
  size_t base;  // b's frame-0 row of column 0, plus off
  __device__ __forceinline__ Lane(const Grid& grid, int kn, int b, int s) {
    const int lane = threadIdx.x & 31;
    g = lane / grid.P;
    r = lane % grid.P;
    if constexpr (kSplit) {  // group g: column w (32 / P) + g
      off = r * kn;
      chan = r * kn < grid.hd;
    } else {  // group g: head s (32 / P) + g of column w
      const int h = s * (32 / grid.P) + g;
      off = h * grid.hd + r * kn;
      chan = h < grid.H && r * kn < grid.hd;
    }
    base = static_cast<size_t>(b) * grid.F * grid.N * grid.D + off;
  }
  __device__ __forceinline__ int column(const Grid& grid, int w) const {
    return kSplit ? w * (32 / grid.P) + g : w;
  }
  __device__ __forceinline__ bool active(const Grid& grid, int w) const {
    return chan && (!kSplit || column(grid, w) < grid.N);
  }
  __device__ __forceinline__ size_t row(const Grid& grid, int w) const {
    return base + static_cast<size_t>(column(grid, w)) * grid.D;
  }
};

// sums of each of x[0..n) over the P lanes of a head group (aligned groups
// of a power of two): the n shuffles of one step are independent, so they
// overlap
template <int n>
__device__ __forceinline__ void group_sums(float* x, int P) {
  for (int o = P >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], o);
  }
}

template <int N>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// floats of one group's p (or dl) table: F (F + 1), made odd
__host__ __device__ inline int table_stride(int F) { return (F * (F + 1)) | 1; }

inline size_t bwd_smem_bytes(int F, int P) {
  return static_cast<size_t>(kWarps) * 2 * (32 / P) * table_stride(F) * sizeof(float);
}

namespace {

template <typename T, int FC, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ cls_k, const T* __restrict__ cls_v, T* __restrict__ out,
           const Grid grid) {
  constexpr int kN = Slice<T>::kN;
  constexpr bool kHoldQ = FC <= 8;  // all query rows in registers
  const unsigned warp = blockIdx.x * kWarps + threadIdx.x / 32;
  if (warp >= grid.warps) return;
  const int s = static_cast<int>(warp % grid.slices);
  const unsigned col = warp / grid.slices;  // b * cols + w
  const int b = static_cast<int>(col / grid.cols), w = static_cast<int>(col % grid.cols);
  const Lane<kSplit> ln(grid, kN, b, s);
  const int F = grid.F, P = grid.P;
  const float scale = grid.scale;
  const size_t frame = static_cast<size_t>(grid.N) * grid.D;  // stride of one frame row
  const size_t row0 = ln.row(grid, w);
  const size_t cls = static_cast<size_t>(b) * grid.D + ln.off;
  const bool active = ln.active(grid, w);

  uint4 kr[FC + 1], vr[FC + 1], qr[kHoldQ ? FC : 1];
  kr[0] = load_if(active, cls_k + cls);
  vr[0] = load_if(active, cls_v + cls);
#pragma unroll
  for (int f = 0; f < FC; ++f) {
    const bool in = active && f < F;
    kr[f + 1] = load_if(in, k + row0 + f * frame);
    vr[f + 1] = load_if(in, v + row0 + f * frame);
    if (kHoldQ) qr[f] = load_if(in, q + row0 + f * frame);
  }

  // one query row: logits, softmax and the output slice
  auto query = [&](int fi, const uint4& qv) {
    float qf[kN];
    Slice<T>::to_f(qv, qf, fi);
#pragma unroll
    for (int i = 0; i < kN; ++i) qf[i] *= scale;
    float e[FC + 1];
#pragma unroll
    for (int key = 0; key <= FC; ++key) {
      float kf[kN];
      Slice<T>::to_f(kr[key], kf, fi);
      e[key] = dot<kN>(qf, kf);  // 0 past F
    }
    group_sums<FC + 1>(e, P);
    float m = -INFINITY;
#pragma unroll
    for (int key = 0; key <= FC; ++key)
      if (key <= F) m = fmaxf(m, e[key]);
    float sum = 0.f;
    float acc[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] = 0.f;
    if constexpr (kSplit) {  // p = e / rowsum, then the sum of p v
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          e[key] = expf(e[key] - m);
          sum += e[key];
        }
      }
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          const float p = e[key] / sum;
          float vf[kN];
          Slice<T>::to_f(vr[key], vf, fi);
#pragma unroll
          for (int i = 0; i < kN; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
      }
    } else {  // the sum of e v, divided by the row sum once
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          const float p = expf(e[key] - m);
          sum += p;
          float vf[kN];
          Slice<T>::to_f(vr[key], vf, fi);
#pragma unroll
          for (int i = 0; i < kN; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] /= sum;
    }
    if (active) store(out + row0 + fi * frame, Slice<T>::from_f(acc));
  };

  if constexpr (kHoldQ) {
#pragma unroll
    for (int fi = 0; fi < FC; ++fi)
      if (fi < F) query(fi, qr[fi]);
  } else {  // each query row loaded one ahead of its use
    qr[0] = load_if(active, q + row0);
#pragma unroll 1
    for (int fi = 0; fi < F; ++fi) {
      const uint4 qv = qr[0];
      qr[0] = load_if(active && fi + 1 < F, q + row0 + (fi + 1) * frame);
      query(fi, qv);
    }
  }
}

template <typename T, int FC, bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ cls_k, const T* __restrict__ cls_v,
           const T* __restrict__ dout, T* __restrict__ dq, T* __restrict__ dk,
           T* __restrict__ dv, float* __restrict__ dcls_k, float* __restrict__ dcls_v,
           const Grid grid) {
  extern __shared__ float tables[];
  constexpr int kN = Slice<T>::kN;
  constexpr bool kHold = FC <= 4;  // the query and do rows held from step 1
  const unsigned warp = blockIdx.x * kWarps + threadIdx.x / 32;
  if (warp >= grid.warps) return;
  const int s = static_cast<int>(warp % grid.slices);
  const unsigned rest = warp / grid.slices;  // b * runs + run
  const int run = static_cast<int>(rest % grid.runs), b = static_cast<int>(rest / grid.runs);
  const Lane<kSplit> ln(grid, kN, b, s);
  const int F = grid.F, P = grid.P;
  const float scale = grid.scale;
  const int hpw = 32 / P;
  const int stride = table_stride(F);
  float* p_tab = tables + (threadIdx.x / 32) * 2 * hpw * stride + ln.g * stride;
  float* dl_tab = p_tab + hpw * stride;
  const size_t frame = static_cast<size_t>(grid.N) * grid.D;
  const size_t cls = static_cast<size_t>(b) * grid.D + ln.off;

  float cls_dk[kN], cls_dv[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) cls_dk[i] = cls_dv[i] = 0.f;
  const uint4 kc = load_if(ln.chan, cls_k + cls);
  const uint4 vc = load_if(ln.chan, cls_v + cls);

#pragma unroll 1
  for (int t = 0; t < kRun<kSplit>; ++t) {
    const int w = run * kRun<kSplit> + t;
    if (w >= grid.cols) break;
    const size_t row0 = ln.row(grid, w);
    const bool active = ln.active(grid, w);

    // 1. the column's rows
    uint4 kr[FC + 1], vr[FC + 1], qr[FC], gr[FC];
    kr[0] = kc;
    vr[0] = vc;
#pragma unroll
    for (int f = 0; f < FC; ++f) {
      const bool in = active && f < F;
      kr[f + 1] = load_if(in, k + row0 + f * frame);
      vr[f + 1] = load_if(in, v + row0 + f * frame);
      if (kHold) {
        qr[f] = load_if(in, q + row0 + f * frame);
        gr[f] = load_if(in, dout + row0 + f * frame);
      }
    }

    // 2. per query: p, dl, dq
    auto query = [&](int fi, const uint4& qv, const uint4& gv) {
      float qf[kN], gf[kN];
      Slice<T>::to_f(qv, qf, fi);
      Slice<T>::to_f(gv, gf, fi);
#pragma unroll
      for (int i = 0; i < kN; ++i) qf[i] *= scale;
      float sums[2 * (FC + 1)];  // the logits, then dp; 0 past F
      float* lg = sums;
      float* dp = sums + FC + 1;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        float kf[kN], vf[kN];
        Slice<T>::to_f(kr[key], kf, 2 * fi);
        Slice<T>::to_f(vr[key], vf, 2 * fi);
        lg[key] = dot<kN>(qf, kf);
        dp[key] = dot<kN>(gf, vf);
      }
      group_sums<2 * (FC + 1)>(sums, P);
      float m = -INFINITY;
#pragma unroll
      for (int key = 0; key <= FC; ++key)
        if (key <= F) m = fmaxf(m, lg[key]);
      float sum = 0.f;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          lg[key] = expf(lg[key] - m);
          sum += lg[key];
        }
      }
      float inner = 0.f;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          lg[key] = lg[key] / sum;  // p
          inner = fmaf(dp[key], lg[key], inner);
        }
      }
      float acc[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = 0.f;
#pragma unroll
      for (int key = 0; key <= FC; ++key) {
        if (key <= F) {
          const float dl = lg[key] * (dp[key] - inner);
          float kf[kN];
          Slice<T>::to_f(kr[key], kf, 2 * fi + 1);
#pragma unroll
          for (int i = 0; i < kN; ++i) acc[i] = fmaf(dl, kf[i], acc[i]);
          if (ln.r == 0) {
            p_tab[fi * (F + 1) + key] = lg[key];
            dl_tab[fi * (F + 1) + key] = dl;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] *= scale;
      if (active) store(dq + row0 + fi * frame, Slice<T>::from_f(acc));
    };
    if constexpr (kHold) {
#pragma unroll
      for (int fi = 0; fi < FC; ++fi)
        if (fi < F) query(fi, qr[fi], gr[fi]);
    } else {  // each query's rows loaded one ahead of their use
      uint4 qn = load_if(active, q + row0);
      uint4 gn = load_if(active, dout + row0);
#pragma unroll 1
      for (int fi = 0; fi < F; ++fi) {
        const uint4 qv = qn, gv = gn;
        const bool next = active && fi + 1 < F;
        qn = load_if(next, q + row0 + (fi + 1) * frame);
        gn = load_if(next, dout + row0 + (fi + 1) * frame);
        query(fi, qv, gv);
      }
    }
    __syncwarp();

    // 3. per key: dK and dV
    if (!kHold) {
#pragma unroll
      for (int f = 0; f < FC; ++f) {
        const bool in = active && f < F;
        qr[f] = load_if(in, q + row0 + f * frame);
        gr[f] = load_if(in, dout + row0 + f * frame);
      }
    }
#pragma unroll 1
    for (int key = 0; key <= F; ++key) {
      float ak[kN], av[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) ak[i] = av[i] = 0.f;
#pragma unroll
      for (int fi = 0; fi < FC; ++fi) {
        if (fi < F) {
          const float dl = dl_tab[fi * (F + 1) + key];
          const float p = p_tab[fi * (F + 1) + key];
          float qf[kN], gf[kN];
          Slice<T>::to_f(qr[fi], qf, key);
          Slice<T>::to_f(gr[fi], gf, key);
#pragma unroll
          for (int i = 0; i < kN; ++i) {
            ak[i] = fmaf(dl, qf[i] * scale, ak[i]);
            av[i] = fmaf(p, gf[i], av[i]);
          }
        }
      }
      if (key == 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          cls_dk[i] += ak[i];
          cls_dv[i] += av[i];
        }
      } else if (active) {
        store(dk + row0 + (key - 1) * frame, Slice<T>::from_f(ak));
        store(dv + row0 + (key - 1) * frame, Slice<T>::from_f(av));
      }
    }
    __syncwarp();  // the next column rewrites the tables
  }

  if constexpr (kSplit) {  // the groups' columns share the CLS row: one sum
    for (int o = P; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        cls_dk[i] += __shfl_xor_sync(0xffffffffu, cls_dk[i], o);
        cls_dv[i] += __shfl_xor_sync(0xffffffffu, cls_dv[i], o);
      }
    }
  }
  if (ln.chan && (!kSplit || ln.g == 0)) {
    const size_t dst = (static_cast<size_t>(b) * grid.runs + run) * grid.D + ln.off;
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      *reinterpret_cast<float4*>(dcls_k + dst + i) =
          make_float4(cls_dk[i], cls_dk[i + 1], cls_dk[i + 2], cls_dk[i + 3]);
      *reinterpret_cast<float4*>(dcls_v + dst + i) =
          make_float4(cls_dv[i], cls_dv[i + 1], cls_dv[i + 2], cls_dv[i + 3]);
    }
  }
}

// Launches the forward on [B, F, N, D] with H heads (K5: B = BH, D = hd,
// H = 1, scale 1), or refuses (cudaErrorInvalidValue) a shape the body does
// not take; returns a cudaError_t code.
template <typename T, bool kSplit>
int launch_fwd(const void* q, const void* k, const void* v, const void* ck, const void* cv,
               void* out, int B, int F, int N, int D, int H, float scale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, ck, cv, out};
  bool aligned = true;
  for (const void* p : ptrs) aligned = aligned && aligned16(p);
  if (H <= 0 || D % H != 0 || !takes(F, D / H, Slice<T>::kN) || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = make_grid<kSplit>(B, F, N, D, H, Slice<T>::kN, scale, false);
  if (g.warps > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (g.warps == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((g.warps + kWarps - 1) / kWarps);
  auto kernel = F <= 4 ? fwd_kernel<T, 4, kSplit>
                : F <= 8 ? fwd_kernel<T, 8, kSplit> : fwd_kernel<T, 16, kSplit>;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward likewise; dck, dcv: float32 [B, runs, D], each run
// of kRun<kSplit> warp columns' share of the CLS grads.
template <typename T, bool kSplit>
int launch_bwd(const void* q, const void* k, const void* v, const void* ck, const void* cv,
               const void* dout, void* dq, void* dk, void* dv, void* dck, void* dcv, int B,
               int F, int N, int D, int H, float scale, cudaStream_t stream) {
  const void* ptrs[] = {q, k, v, ck, cv, dout, dq, dk, dv, dck, dcv};
  bool aligned = true;
  for (const void* p : ptrs) aligned = aligned && aligned16(p);
  if (H <= 0 || D % H != 0 || !takes(F, D / H, Slice<T>::kN) || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = make_grid<kSplit>(B, F, N, D, H, Slice<T>::kN, scale, true);
  if (g.warps > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (g.warps == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((g.warps + kWarps - 1) / kWarps);
  auto kernel = F <= 4 ? bwd_kernel<T, 4, kSplit>
                : F <= 8 ? bwd_kernel<T, 8, kSplit> : bwd_kernel<T, 16, kSplit>;
  kernel<<<blocks, kWarps * 32, bwd_smem_bytes(F, g.P), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ck), static_cast<const T*>(cv), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dck),
      static_cast<float*>(dcv), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kSplit, bool kBwd>
cudaError_t func_attributes(int F, cudaFuncAttributes* attr) {
  const void* fn;
  if constexpr (kBwd)
    fn = reinterpret_cast<const void*>(F <= 4   ? bwd_kernel<T, 4, kSplit>
                                       : F <= 8 ? bwd_kernel<T, 8, kSplit>
                                                : bwd_kernel<T, 16, kSplit>);
  else
    fn = reinterpret_cast<const void*>(F <= 4   ? fwd_kernel<T, 4, kSplit>
                                       : F <= 8 ? fwd_kernel<T, 8, kSplit>
                                                : fwd_kernel<T, 16, kSplit>);
  return cudaFuncGetAttributes(attr, fn);
}

// Registers a thread and local (spill) bytes a thread of the instantiation a
// launch with F frames at `dtype` takes, and the shared memory a CTA of it
// takes at hd 64 (the forward: 0); returns a cudaError_t code.
template <bool kSplit, bool kBwd>
int attributes(int F, int dtype, int* regs, int* local_bytes, int* smem) {
  if (F < 1 || F > kFrameCap) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err;
  int kn;
  if (dtype == kBFloat16) {
    err = func_attributes<__nv_bfloat16, kSplit, kBwd>(F, &attr);
    kn = Slice<__nv_bfloat16>::kN;
  } else if (dtype == kFloat32) {
    err = func_attributes<float, kSplit, kBwd>(F, &attr);
    kn = Slice<float>::kN;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = kBwd ? static_cast<int>(bwd_smem_bytes(F, lanes_per_head(64, kn))) : 0;
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// makes `device` current if it is not, so the launch goes to its stream
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

}  // namespace k2
}  // namespace egovlp
