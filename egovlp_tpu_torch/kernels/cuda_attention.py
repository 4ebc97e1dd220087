"""Divided-attention kernels: CUDA wrappers and their plain PyTorch twins.

Counterpart of the forward halves of ``egovlp_tpu/kernels/pallas_attention.py``:

* ``space_attention_fwd`` (K1-fwd) <- ``make_space_attention_bsd`` (:821);
* ``time_attention_fwd`` (K2-fwd) <- ``make_time_attention_bsd`` (:1568).

Both work on the grid layout ``q, k, v: [B, f, n, D]`` with the CLS key and
value ``[B, 1, D]`` spliced in front of every group; heads are sliced from
D inside the kernel.  A wrapper given CUDA tensors launches its kernel
(``kernels/csrc``) or raises; given CPU tensors it computes the plain
version beside it.  ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from egovlp_tpu_torch.kernels._build import load_library

launches = {"space_attention_fwd": 0, "time_attention_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check(q, k, v, cls_k, cls_v, heads: int) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, f, n, D], got {tuple(q.shape)}")
    B, _, _, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if cls_k.shape != (B, 1, D) or cls_v.shape != (B, 1, D):
        raise ValueError(f"cls_k/cls_v must be {(B, 1, D)}, got "
                         f"{tuple(cls_k.shape)}, {tuple(cls_v.shape)}")
    if D % heads:
        raise ValueError(f"D={D} is not divisible by heads={heads}")
    ts = (q, k, v, cls_k, cls_v)
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError("q, k, v, cls_k, cls_v must share one dtype, "
                        f"float32 or bfloat16; got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v, cls_k, cls_v must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k, v, cls_k, cls_v must be contiguous")


def _launch(name: str, dims, q, k, v, cls_k, cls_v,
            scale: float) -> torch.Tensor:
    """Launch kernel ``name`` on q's device and current stream, or raise."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    lib = load_library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"egovlp_{name}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cls_k.data_ptr(),
        cls_v.data_ptr(), out.data_ptr(), *dims, float(scale),
        _DTYPE_CODES[q.dtype], q.device.index, stream)
    if err != 0:
        msg = lib.egovlp_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed at shape {tuple(q.shape)} "
                           f"{q.dtype}: {msg} (cudaError {err})")
    launches[name] += 1
    return out


# --------------------------------------------------------------------------
# K1: space attention (group = one frame's n patches)
# --------------------------------------------------------------------------

def space_attention_fwd_plain(q, k, v, cls_k, cls_v, *, heads: int,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch K1: the kernel's math, rounding points included."""
    B, G, L, D = q.shape
    hd = D // heads
    dt = q.dtype

    def split(t):  # [B, G, L, D] -> [B, G, H, L, hd]
        return t.reshape(B, G, L, heads, hd).permute(0, 1, 3, 2, 4)

    def with_cls(c, t):  # CLS row first: [B, G, H, L + 1, hd] in float32
        c = c.reshape(B, 1, heads, 1, hd).expand(B, G, heads, 1, hd)
        return torch.cat([c, split(t)], dim=3).float()

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    qs = (split(q).float() * scale).to(dt).float()
    logits = qs @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    inv = 1.0 / e.sum(dim=-1, keepdim=True)
    out = (e.to(dt).float() @ vc) * inv
    return out.permute(0, 1, 3, 2, 4).reshape(B, G, L, D).to(dt)


def space_attention_fwd(q, k, v, cls_k, cls_v, *, heads: int,
                        scale: float) -> torch.Tensor:
    """K1-fwd: each frame's patch queries attend over [CLS; that frame]."""
    _check(q, k, v, cls_k, cls_v, heads)
    if q.device.type == "cpu":
        return space_attention_fwd_plain(q, k, v, cls_k, cls_v, heads=heads,
                                         scale=scale)
    return _launch("space_attention_fwd", (*q.shape, heads),
                   q, k, v, cls_k, cls_v, scale)


# --------------------------------------------------------------------------
# K2: time attention (group = one patch column's f frames)
# --------------------------------------------------------------------------

def time_attention_fwd_plain(q, k, v, cls_k, cls_v, *, heads: int,
                             scale: float) -> torch.Tensor:
    """Plain PyTorch K2: float32 throughout, one cast at the end."""
    B, F, N, D = q.shape
    hd = D // heads

    def split(t):  # [B, F, N, D] -> [B, N, H, F, hd] in float32
        return t.float().reshape(B, F, N, heads, hd).permute(0, 2, 3, 1, 4)

    def with_cls(c, t):
        c = c.float().reshape(B, 1, heads, 1, hd).expand(B, N, heads, 1, hd)
        return torch.cat([c, split(t)], dim=3)

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    logits = (split(q) * scale) @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (e @ vc) / e.sum(dim=-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(B, F, N, D).to(q.dtype)


def time_attention_fwd(q, k, v, cls_k, cls_v, *, heads: int,
                       scale: float) -> torch.Tensor:
    """K2-fwd: each patch column's frame queries attend over [CLS; column]."""
    _check(q, k, v, cls_k, cls_v, heads)
    if q.device.type == "cpu":
        return time_attention_fwd_plain(q, k, v, cls_k, cls_v, heads=heads,
                                        scale=scale)
    return _launch("time_attention_fwd", (*q.shape, heads),
                   q, k, v, cls_k, cls_v, scale)
