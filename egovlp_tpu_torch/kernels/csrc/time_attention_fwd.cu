// Time attention forward (K2-fwd) for sm_90a.
//
// Replaces: egovlp_tpu/kernels/pallas_attention.py::_mk_time_fwd_bsd_v2,
// which runs _mk_time_fwd_bsd_v3 at f <= 8, launched by _time_fwd_bsd_call.
//
// What it computes: q, k, v, out are [B, F, N, D] (F frames of N patch
// columns, D = H * hd, heads sliced from D by stride); cls_k, cls_v are
// [B, 1, D].  For each (b, patch column j, head h) the F frame queries of
// that column, scaled by `scale`, attend over the F + 1 keys
// [cls_k; k[b, :, j]] and return the softmax-weighted sum of
// [cls_v; v[b, :, j]].  As in the Pallas body, every value is widened to
// float32 on load; logits, softmax and accumulation stay float32 and the
// sum is divided by the row sum before the one cast to the output dtype.
//
// What bounds it on an H100: device memory.  Each query meets F + 1 keys,
// so the work is ~2.5 FLOP a byte, far below the ~295 at which the tensor
// cores would be the limit: the kernel's only job is to read q, k, v and
// write out once at the card's memory rate.
//
// Design: the 16-byte streaming body of time_attention_stream.cuh
// (fwd_kernel, K2's layout): one warp takes one patch column of one b and
// a slice of 32 / P heads (4 heads of hd 64 at bf16); each lane owns one
// 16-byte slice of every row and keeps its key, value (and, up to 8
// frames, query) rows in registers; the softmax runs in registers after
// xor shuffles over the head group, and each output slice is one 16-byte
// store.
//
// Shapes: F from 1 to 16 (instantiations hold 4, 8 or 16 frames), any N, hd
// a multiple of 8 (bf16) or 4 (float32) up to 32 lanes a head, 16-byte
// aligned tensors.  The launcher refuses any other shape (the wrapper
// raises); there is no other body.

#include "common.cuh"
#include "time_attention_stream.cuh"

// Launches on `stream` of device `device`; returns a cudaError_t code.
extern "C" int egovlp_time_attention_fwd(const void* q, const void* k, const void* v,
                                         const void* cls_k, const void* cls_v, void* out,
                                         int B, int F, int N, int D, int H, float scale,
                                         int dtype, int device, void* stream) {
  const cudaError_t err = egovlp::k2::use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == egovlp::kBFloat16)
    return egovlp::k2::launch_fwd<__nv_bfloat16, false>(q, k, v, cls_k, cls_v, out, B, F, N,
                                                        D, H, scale, s);
  if (dtype == egovlp::kFloat32)
    return egovlp::k2::launch_fwd<float, false>(q, k, v, cls_k, cls_v, out, B, F, N, D, H,
                                                scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers a thread and local (spill) bytes a thread of the instantiation a
// launch with F frames at `dtype` takes (`smem`: 0, it uses none); returns a
// cudaError_t code.
extern "C" int egovlp_time_attention_fwd_attributes(int F, int dtype, int* regs,
                                                    int* local_bytes, int* smem) {
  return egovlp::k2::attributes<false, false>(F, dtype, regs, local_bytes, smem);
}

// Message of a cudaError_t code, for the wrappers' exceptions.
extern "C" const char* egovlp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
