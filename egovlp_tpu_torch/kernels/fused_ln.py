"""LayerNorm with the JAX package's formula and its memory-lean VJP (K3).

Counterpart of ``egovlp_tpu/kernels/fused_ln.py`` (:41-82; plain jnp
there, not a Pallas kernel).  ``F.layer_norm`` computes the variance
another way, so it is not used: statistics are float32, the variance is
``max(E[x^2] - E[x]^2, 0)``, eps sits inside the rsqrt, and the output
``(x - mu) * (rstd * scale) + bias`` is cast to the input dtype.

The autograd Function ``LayerNorm`` saves only ``x``, ``scale`` and the
float32 row statistics ``mu``, ``rstd`` (``[..., 1]``), and its backward
is JAX's one pass (:67-79): with ``x_hat = (x - mu) * rstd`` and ``g = dy
* scale``, ``dx = rstd * (g - mean(g) - x_hat * mean(g * x_hat))`` cast to
x's dtype, ``dscale = sum_rows(dy * x_hat)`` and ``dbias = sum_rows(dy)``
in float32, cast to the parameters' dtype.  On a CUDA tensor the forward
and the backward are one hand-written kernel each, K3-fwd
(``csrc/layer_norm_fwd.cu``) and K3-bwd (``csrc/layer_norm_bwd.cu``,
which writes each block's float32 share of dscale and dbias, added here),
counted in ``cuda_attention.launches``; on a CPU tensor their plain twins
below.  Both are ops, ``torch.ops.egovlp_torch.layer_norm_{fwd,bwd}``
(``kernels/ops.py``), whose outputs are y and the stacked ``[mu; rstd]``,
and dx and the stacked ``[dscale; dbias]``.  The kernels take contiguous
rows of D a multiple of 16 bytes' values (8 at bf16, 4 at float32; the
backward up to 1024), 16-byte aligned, float32 parameters; any other
CUDA input raises.
"""

from __future__ import annotations

import torch
from torch import nn

from egovlp_tpu_torch.kernels import ops
from egovlp_tpu_torch.kernels.cuda_attention import (
    _DTYPE_CODES,
    _launch,
    forward_only,
)

# the widest row K3-bwd holds, and the rows of one of its blocks (one row
# of its partial sums): ``kMaxD``, ``kBwdRowsPerBlock`` in
# ``csrc/layer_norm.cuh``
MAX_BWD_DIM = 1024
BWD_ROWS_PER_BLOCK = 32


def _stats_shape(x):
    return (*x.shape[:-1], 1)


def layer_norm_fwd_plain(x, scale, bias, eps: float):
    """Plain PyTorch K3-fwd: ``(y in x.dtype, mu, rstd)``, the statistics
    float32 ``[..., 1]``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * (rstd * scale.float()) + bias.float()
    return y.to(x.dtype), mu, rstd


def layer_norm_bwd_plain(x, scale, mu, rstd, dy):
    """Plain PyTorch K3-bwd: ``(dx in x.dtype, dscale, dbias)``, the
    parameter grads summed over every row in float32 and cast to
    ``scale.dtype``."""
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mu) * rstd
    g = dyf * scale.float()
    m1 = g.mean(dim=-1, keepdim=True)
    m2 = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (g - m1 - xhat * m2)).to(x.dtype)
    rows = tuple(range(dy.dim() - 1))
    dscale = (dyf * xhat).sum(dim=rows).to(scale.dtype)
    dbias = dyf.sum(dim=rows).to(scale.dtype)
    return dx, dscale, dbias


def _check_cuda(x, params, bwd: bool, rows=()) -> None:
    """What the kernels take (see the module notes), or raise: ``params``
    are the float32 ``[D]`` parameters, ``rows`` the tensors laid out as
    ``x`` (dy) or as its row statistics (mu, rstd)."""
    D = x.shape[-1]
    if x.dtype not in _DTYPE_CODES or any(p.dtype != torch.float32
                                          for p in params):
        raise TypeError(f"LayerNorm kernels take float32 or bfloat16 rows and "
                        f"float32 parameters, got {x.dtype}, "
                        f"{[p.dtype for p in params]}")
    if any(p.shape != (D,) or p.device != x.device for p in params):
        raise ValueError(f"LayerNorm parameters must be [{D}] on {x.device}")
    slice_ = 16 // x.element_size()
    if D % slice_ or (bwd and D > MAX_BWD_DIM):
        raise ValueError(f"LayerNorm kernels take D a multiple of {slice_}"
                         f"{f' up to {MAX_BWD_DIM}' if bwd else ''}, got {D}")
    for t, shape, dtype in rows:
        if t.shape != shape or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"expected {tuple(shape)} {dtype} on {x.device}")
    if not all(t.is_contiguous() for t in (x, *params, *(r[0] for r in rows))):
        raise ValueError("LayerNorm kernels take contiguous tensors")


def _bwd_rows(x, mu, rstd, dy) -> tuple:
    """K3-bwd's row tensors and the shape and dtype each must have."""
    stats = _stats_shape(x)
    return ((dy, x.shape, x.dtype), (mu, stats, torch.float32),
            (rstd, stats, torch.float32))


def _fwd_cuda(x, scale, bias, eps: float):
    """K3-fwd's launcher: ``(y, stats [2, ..., 1])``, the row statistics
    mu and rstd stacked in one float32 allocation."""
    _check_cuda(x, (scale, bias), bwd=False)
    D = x.shape[-1]
    y = torch.empty_like(x)
    stats = torch.empty((2, *_stats_shape(x)), device=x.device,
                        dtype=torch.float32)
    _launch("layer_norm_fwd", (x, scale, bias), (y, stats[0], stats[1]),
            (x.numel() // D, D, eps))
    return y, stats


def _bwd_cuda(x, scale, mu, rstd, dy):
    """K3-bwd's launcher: ``(dx, [dscale; dbias] [2, D])``; the kernel
    writes each block's float32 share of dscale and dbias, summed here
    over the blocks."""
    _check_cuda(x, (scale,), bwd=True, rows=_bwd_rows(x, mu, rstd, dy))
    D = x.shape[-1]
    rows = x.numel() // D
    blocks = -(-rows // BWD_ROWS_PER_BLOCK)
    dx = torch.empty_like(x)
    part = torch.empty((2, blocks, D), device=x.device, dtype=torch.float32)
    _launch("layer_norm_bwd", (x, dy, scale, mu, rstd), (dx, part),
            (rows, D))
    return dx, part.sum(dim=1).to(scale.dtype)


def _fwd_cpu(x, scale, bias, eps: float):
    y, mu, rstd = layer_norm_fwd_plain(x, scale, bias, eps)
    return y, torch.stack([mu, rstd])


def _bwd_cpu(x, scale, mu, rstd, dy):
    dx, dscale, dbias = layer_norm_bwd_plain(x, scale, mu, rstd, dy)
    return dx, torch.stack([dscale, dbias])


def _fwd_fake(x, scale, bias, eps: float):
    if x.device.type == "cuda":
        _check_cuda(x, (scale, bias), bwd=False)
    return (torch.empty_like(x),
            x.new_empty((2, *_stats_shape(x)), dtype=torch.float32))


def _bwd_fake(x, scale, mu, rstd, dy):
    if x.device.type == "cuda":
        _check_cuda(x, (scale,), bwd=True, rows=_bwd_rows(x, mu, rstd, dy))
    return torch.empty_like(x), scale.new_empty((2, x.shape[-1]))


_LN_FWD = ops.define(
    "layer_norm_fwd", "(Tensor x, Tensor scale, Tensor bias, float eps) -> "
    "(Tensor, Tensor)", _fwd_cpu, _fwd_cuda, _fwd_fake)
_LN_BWD = ops.define(
    "layer_norm_bwd", "(Tensor x, Tensor scale, Tensor mu, Tensor rstd, "
    "Tensor dy) -> (Tensor, Tensor)", _bwd_cpu, _bwd_cuda, _bwd_fake)


def layer_norm_fwd(x, scale, bias, eps: float):
    """K3-fwd: ``(y, mu, rstd)`` as ``layer_norm_fwd_plain``; ``x``
    contiguous."""
    y, stats = _LN_FWD(x, scale, bias, eps)
    return y, stats[0], stats[1]


def layer_norm_bwd(x, scale, mu, rstd, dy):
    """K3-bwd: ``(dx, dscale, dbias)`` as ``layer_norm_bwd_plain``."""
    dx, dparams = _LN_BWD(x, scale, mu, rstd, dy)
    return dx, dparams[0], dparams[1]


class LayerNorm(torch.autograd.Function):
    """K3: ``apply(x, scale, bias, eps)``; saves x, scale, mu and rstd.
    Both passes launch without the dispatcher (``cuda_attention.direct``
    says why)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x = x.contiguous()
        fwd = _fwd_cpu if x.device.type == "cpu" else _fwd_cuda
        y, stats = fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, stats[0], stats[1])
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors  # unpacked once: recompute allows no more
        bwd = _bwd_cpu if dy.device.type == "cpu" else _bwd_cuda
        dx, dparams = bwd(*saved, dy.contiguous())
        return dx, dparams[0], dparams[1], None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; returns ``x.dtype``.  The autograd
    Function ``LayerNorm``, or with grad mode off the K3-fwd op
    (``cuda_attention.forward_only``)."""
    if forward_only():
        return _LN_FWD(x.contiguous(), scale, bias, eps)[0]
    return LayerNorm.apply(x, scale, bias, eps)


class FusedLayerNorm(nn.Module):
    """``nn.LayerNorm``-named parameters (``weight``, ``bias``, float32);
    the output keeps the activation dtype."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 device: "torch.device | str | None" = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, self.eps)
