"""Divided-attention kernels: CUDA wrappers, their plain PyTorch twins,
and the autograd Functions over them.

Counterpart of ``egovlp_tpu/kernels/pallas_attention.py``:

* ``space_attention_fwd`` (K1-fwd) / ``space_attention_bwd`` (K1-bwd) and
  the Function ``SpaceAttention`` <- ``make_space_attention_bsd`` (:821);
* ``time_attention_fwd`` (K2-fwd) / ``time_attention_bwd`` (K2-bwd) and
  the Function ``TimeAttention`` <- ``make_time_attention_bsd`` (:1568).

All work on the grid layout ``q, k, v: [B, f, n, D]`` with the CLS key and
value ``[B, 1, D]`` spliced in front of every group; heads are sliced from
D inside the kernels.  A wrapper given CUDA tensors launches its kernel
(``kernels/csrc``) or raises; given CPU tensors it computes the plain
version beside it.  ``launches`` counts kernel launches per wrapper.  As
the JAX ``custom_vjp`` does, a Function saves only its inputs and the
backward kernel recomputes the probabilities.
"""

from __future__ import annotations

import torch

from egovlp_tpu_torch.kernels._build import load_library

launches = {"space_attention_fwd": 0, "time_attention_fwd": 0,
            "space_attention_bwd": 0, "time_attention_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check(q, k, v, cls_k, cls_v, heads: int, do=None) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be [B, f, n, D], got {tuple(q.shape)}")
    B, _, _, D = q.shape
    grid = (k, v) if do is None else (k, v, do)
    if any(t.shape != q.shape for t in grid):
        raise ValueError(f"q/k/v/do shapes differ: {tuple(q.shape)}, "
                         f"{[tuple(t.shape) for t in grid]}")
    if cls_k.shape != (B, 1, D) or cls_v.shape != (B, 1, D):
        raise ValueError(f"cls_k/cls_v must be {(B, 1, D)}, got "
                         f"{tuple(cls_k.shape)}, {tuple(cls_v.shape)}")
    if D % heads:
        raise ValueError(f"D={D} is not divisible by heads={heads}")
    ts = (q, cls_k, cls_v) + grid
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError("q, k, v, cls_k, cls_v (and do) must share one dtype, "
                        f"float32 or bfloat16; got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v, cls_k, cls_v (and do) must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k, v, cls_k, cls_v (and do) must be contiguous")


def _launch(name: str, dims, inputs, outputs, scale: float) -> None:
    """Launch kernel ``name`` on the inputs' device and current stream over
    preallocated ``outputs``, or raise."""
    q = inputs[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"egovlp_{name}")(
        *(t.data_ptr() for t in (*inputs, *outputs)), *dims, float(scale),
        _DTYPE_CODES[q.dtype], q.device.index, stream)
    if err != 0:
        msg = lib.egovlp_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed at shape {tuple(q.shape)} "
                           f"{q.dtype}: {msg} (cudaError {err})")
    launches[name] += 1


def _fwd(name, plain, q, k, v, cls_k, cls_v, heads, scale):
    _check(q, k, v, cls_k, cls_v, heads)
    if q.device.type == "cpu":
        return plain(q, k, v, cls_k, cls_v, heads=heads, scale=scale)
    out = torch.empty_like(q)
    _launch(name, (*q.shape, heads), (q, k, v, cls_k, cls_v), (out,), scale)
    return out


def _bwd(name, plain, part_shape, q, k, v, cls_k, cls_v, do, heads, scale):
    """dq, dk, dv and the CLS grads [B, 1, D]: the kernel writes each
    group's float32 share of the CLS grads to ``[B, groups, D]`` scratch,
    summed here over the groups and cast once."""
    _check(q, k, v, cls_k, cls_v, heads, do)
    if q.device.type == "cpu":
        return plain(q, k, v, cls_k, cls_v, do, heads=heads, scale=scale)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    parts = [torch.empty(part_shape, device=q.device, dtype=torch.float32)
             for _ in range(2)]
    _launch(name, (*q.shape, heads), (q, k, v, cls_k, cls_v, do),
            (dq, dk, dv, *parts), scale)
    dck, dcv = (t.sum(dim=1, keepdim=True).to(q.dtype) for t in parts)
    return dq, dk, dv, dck, dcv


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
    return _fwd("space_attention_fwd", space_attention_fwd_plain,
                q, k, v, cls_k, cls_v, heads, scale)


def space_attention_bwd_plain(q, k, v, cls_k, cls_v, do, *, heads: int,
                              scale: float):
    """Plain PyTorch K1-bwd: the kernel's math, rounding points included
    (``round(q * scale)``, ``dl`` and ``p`` rounded to the input dtype before
    their products); the CLS grads are summed over frames in float32."""
    B, G, L, D = q.shape
    hd = D // heads
    dt = q.dtype

    def split(t):  # [B, G, L, D] -> [B, G, H, L, hd] in float32
        return t.reshape(B, G, L, heads, hd).permute(0, 1, 3, 2, 4).float()

    def with_cls(c, t):
        c = c.reshape(B, 1, heads, 1, hd).expand(B, G, heads, 1, hd).float()
        return torch.cat([c, split(t)], dim=3)

    def merge(t):  # [B, G, H, rows, hd] -> [B, G, rows, D]
        return t.permute(0, 1, 3, 2, 4).reshape(B, G, -1, D)

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    qs = (split(q) * scale).to(dt).float()
    gr = split(do)
    logits = qs @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    dp = gr @ vc.transpose(-1, -2)
    dl = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = merge((dl @ kc) * scale)
    dkc = merge(dl.transpose(-1, -2) @ qs)
    dvc = merge(p.to(dt).float().transpose(-1, -2) @ gr)
    return (dq.to(dt), dkc[:, :, 1:].to(dt), dvc[:, :, 1:].to(dt),
            dkc[:, :, :1].sum(dim=1).to(dt), dvc[:, :, :1].sum(dim=1).to(dt))


def space_attention_bwd(q, k, v, cls_k, cls_v, do, *, heads: int,
                        scale: float):
    """K1-bwd: ``(dq, dk, dv, dcls_k [B, 1, D], dcls_v [B, 1, D])``."""
    B, G, _, D = q.shape
    return _bwd("space_attention_bwd", space_attention_bwd_plain,
                (B, G, D), q, k, v, cls_k, cls_v, do, heads, scale)


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
    return _fwd("time_attention_fwd", time_attention_fwd_plain,
                q, k, v, cls_k, cls_v, heads, scale)


def time_attention_bwd_plain(q, k, v, cls_k, cls_v, do, *, heads: int,
                             scale: float):
    """Plain PyTorch K2-bwd: float32 throughout, one cast per output; the
    CLS grads are summed over the patch columns in float32."""
    B, F, N, D = q.shape
    hd = D // heads
    dt = q.dtype

    def split(t):  # [B, F, N, D] -> [B, N, H, F, hd] in float32
        return t.float().reshape(B, F, N, heads, hd).permute(0, 2, 3, 1, 4)

    def with_cls(c, t):
        c = c.float().reshape(B, 1, heads, 1, hd).expand(B, N, heads, 1, hd)
        return torch.cat([c, split(t)], dim=3)

    def merge(t):  # [B, N, H, rows, hd] -> [B, rows, N, D]
        return t.permute(0, 3, 1, 2, 4).reshape(B, -1, N, D)

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    qa = split(q) * scale
    gr = split(do)
    logits = qa @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = gr @ vc.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = merge((dl @ kc) * scale)
    dkc = merge(dl.transpose(-1, -2) @ qa)
    dvc = merge(p.transpose(-1, -2) @ gr)
    return (dq.to(dt), dkc[:, 1:].to(dt), dvc[:, 1:].to(dt),
            dkc[:, :1].sum(dim=2).to(dt), dvc[:, :1].sum(dim=2).to(dt))


def time_attention_bwd(q, k, v, cls_k, cls_v, do, *, heads: int,
                       scale: float):
    """K2-bwd: ``(dq, dk, dv, dcls_k [B, 1, D], dcls_v [B, 1, D])``."""
    B, _, N, D = q.shape
    return _bwd("time_attention_bwd", time_attention_bwd_plain,
                (B, N, D), q, k, v, cls_k, cls_v, do, heads, scale)


# --------------------------------------------------------------------------
# autograd: forward kernel, backward kernel, inputs saved (no probabilities)
# --------------------------------------------------------------------------

class SpaceAttention(torch.autograd.Function):
    """K1: ``apply(q, k, v, cls_k, cls_v, heads, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v, heads, scale):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        ctx.heads, ctx.scale = heads, scale
        return space_attention_fwd(q, k, v, cls_k, cls_v, heads=heads,
                                   scale=scale)

    @staticmethod
    def backward(ctx, do):
        return (*space_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                     heads=ctx.heads, scale=ctx.scale),
                None, None)


class TimeAttention(torch.autograd.Function):
    """K2: ``apply(q, k, v, cls_k, cls_v, heads, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v, heads, scale):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        ctx.heads, ctx.scale = heads, scale
        return time_attention_fwd(q, k, v, cls_k, cls_v, heads=heads,
                                  scale=scale)

    @staticmethod
    def backward(ctx, do):
        return (*time_attention_bwd(*ctx.saved_tensors, do.contiguous(),
                                    heads=ctx.heads, scale=ctx.scale),
                None, None)
