// Time attention backward (K2-bwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_mk_time_bwd_bsd_v2,
// which runs _mk_time_bwd_bsd_v3(force_batched=True) at f <= 8, launched by
// _time_bwd_bsd_call.
//
// What it computes: q, k, v, do, dq, dk, dv are [B, F, N, D] (F frames of N
// patch columns, D = H * hd, heads sliced from D by stride); cls_k, cls_v
// are [B, 1, D].  For each (b, patch column j, head h), with qa = q * scale,
// K = [cls_k; k[b, :, j]] and V = [cls_v; v[b, :, j]] (F + 1 rows):
//
//   p  = softmax(qa K^T),  dp = do V^T,  dl = p * (dp - rowsum(dp * p))
//   dq = dl K * scale,     dK = dl^T qa, dV = p^T do
//
// As in the Pallas body every value is widened to float32 on load and the
// math stays float32 up to one cast per output.  dq and the F frame rows of
// dK and dV are written in the input dtype; the CLS rows, summed over a run
// of 4 consecutive patch columns in float32, go to float32 scratch
// [B, ceil(N / 4), D] that the wrapper sums over the runs and casts
// once.  (The Pallas wrapper rounds each n-block's share to the output
// dtype before its sum; this kernel and its plain twin round once.)
//
// What bounds it on an H100: device memory.  Each query meets F + 1 keys:
// ~2.5 FLOP a byte.  The kernel has to read q, k, v, do and write dq, dk,
// dv once at the card's memory rate.
//
// Design: the 16-byte streaming body of time_attention_stream.cuh
// (bwd_kernel, K2's layout): one warp walks a run of 4 consecutive patch
// columns of one b, in a fixed order, for a slice of 32 / P heads; each
// lane owns one 16-byte slice of every row.  Per column: p, dl and dq's
// 16-byte slices per query, p and dl kept in a per-warp shared table, then
// dK and dV a key at a time; the CLS key's rows are summed over the run.
// No atomics: every output element has one writer, and two launches give
// the same bits.
//
// Shapes: those of the forward (F from 1 to 16, any N, hd a multiple of 8
// at bf16 or 4 at float32, up to 32 lanes a head, 16-byte aligned tensors);
// the launcher refuses any other (the wrapper raises).

#include "common.cuh"
#include "time_attention_stream.cuh"

// Launches on `stream` of device `device`; returns a cudaError_t code.
// dcls_k, dcls_v: float32 [B, ceil(N / 4), D], each run of 4 patch columns'
// share of the CLS grads.
extern "C" int egovlp_time_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* cls_k, const void* cls_v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* dcls_k, void* dcls_v, int B, int F, int N,
                                         int D, int H, float scale, int dtype, int device,
                                         void* stream) {
  const cudaError_t err = egovlp::k2::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k2::launch_bwd<__nv_bfloat16, false>(q, k, v, cls_k, cls_v, dout, dq, dk,
                                                        dv, dcls_k, dcls_v, B, F, N, D, H,
                                                        scale, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::k2::launch_bwd<float, false>(q, k, v, cls_k, cls_v, dout, dq, dk, dv,
                                                dcls_k, dcls_v, B, F, N, D, H, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the instantiation a
// launch with F frames at `dtype` takes, and the shared memory a CTA of it
// takes at hd 64; returns a cudaError_t code.
extern "C" int egovlp_time_attention_bwd_attributes(int F, int dtype, int* regs,
                                                    int* local_bytes, int* smem) {
  return egovlp::k2::attributes<false, true>(F, dtype, regs, local_bytes, smem);
}
