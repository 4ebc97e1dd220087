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
in float32, cast to the parameters' dtype.

The video tower norms a block's CLS part and patch part with one set of
parameters (JAX ``video_tower.py:308-330``): ``LayerNormPair`` does both
in one launch each way, saving ``xc``, ``xp``, ``scale`` and both parts'
statistics; its parameter grads are the two VJPs' sum, ``dscale_c +
dscale_p``.  A part whose output reaches no loss gets a ``None`` gradient
(``set_materialize_grads(False)``), and the backward then runs over the
other part's rows alone.

On a CUDA tensor the forward and the backward are one hand-written kernel
each, K3-fwd (``csrc/layer_norm_fwd.cu``) and K3-bwd
(``csrc/layer_norm_bwd.cu``, which also sums dscale and dbias over its
blocks), counted in ``cuda_attention.launches`` once a launch, single or
pair; on a CPU tensor their plain twins below.  The kernels take up to two
row segments, the patch rows first and the CLS rows at the tail of the
grid.  They are ops, ``torch.ops.egovlp_torch.layer_norm_{fwd,bwd}`` and
``layer_norm_pair_{fwd,bwd}`` (``kernels/ops.py``), whose outputs are y
(each part's) and the stacked ``[mu; rstd]`` (each part's), and dx (each
part's) and the stacked ``[dscale; dbias]``.  The kernels take contiguous
rows of D a multiple of 16 bytes' values (8 at bf16, 4 at float32; the
backward up to 1024), 16-byte aligned, float32 parameters; any other CUDA
input raises.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from egovlp_tpu_torch.kernels import ops
from egovlp_tpu_torch.kernels.cuda_attention import (
    _DTYPE_CODES,
    _launch,
    forward_only,
)

# the widest row K3-bwd holds, the warps of one of its blocks (one row a
# warp) and the most blocks an SM takes: ``kMaxD``, ``kWarps`` in
# ``csrc/layer_norm.cuh`` and ``kBwdBlocksPerSm`` in ``layer_norm_bwd.cu``
MAX_BWD_DIM = 1024
BWD_WARPS = 8
BWD_BLOCKS_PER_SM = 1


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


def layer_norm_pair_fwd_plain(xc, xp, scale, bias, eps: float):
    """Plain PyTorch K3-fwd on a CLS part and a patch part with one set of
    parameters: ``(yc, yp, mu_c, rstd_c, mu_p, rstd_p)``."""
    yc, mu_c, rstd_c = layer_norm_fwd_plain(xc, scale, bias, eps)
    yp, mu_p, rstd_p = layer_norm_fwd_plain(xp, scale, bias, eps)
    return yc, yp, mu_c, rstd_c, mu_p, rstd_p


def layer_norm_pair_bwd_plain(xc, xp, scale, mu_c, rstd_c, mu_p, rstd_p,
                              dyc, dyp):
    """Plain PyTorch K3-bwd of the pair: ``(dxc, dxp, dscale, dbias)``, the
    parameter grads of the two parts' VJPs added as JAX adds them,
    ``dscale_c + dscale_p``."""
    dxc, dscale_c, dbias_c = layer_norm_bwd_plain(xc, scale, mu_c, rstd_c,
                                                  dyc)
    dxp, dscale_p, dbias_p = layer_norm_bwd_plain(xp, scale, mu_p, rstd_p,
                                                  dyp)
    return dxc, dxp, dscale_c + dscale_p, dbias_c + dbias_p


def _check_cuda(xs, params, bwd: bool, rows=()) -> None:
    """What the kernels take (see the module notes), or raise: ``xs`` are
    the row segments, ``params`` the float32 ``[D]`` parameters, ``rows``
    ``(tensor, shape, dtype)`` of the tensors laid out as a segment (dy)
    or as its row statistics (mu, rstd)."""
    x = xs[0]
    D = x.shape[-1]
    if any(t.shape[-1] != D or t.dtype != x.dtype or t.device != x.device
           for t in xs[1:]):
        raise ValueError(f"LayerNorm segments must share D, dtype and device, "
                         f"got {[(t.shape[-1], t.dtype, t.device) for t in xs]}")
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
    if not all(t.is_contiguous() for t in (*xs, *params, *(r[0] for r in rows))):
        raise ValueError("LayerNorm kernels take contiguous tensors")


def _bwd_rows(x, mu, rstd, dy) -> tuple:
    """K3-bwd's row tensors of segment ``x`` and the shape and dtype each
    must have."""
    stats = _stats_shape(x)
    return ((dy, x.shape, x.dtype), (mu, stats, torch.float32),
            (rstd, stats, torch.float32))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fwd_segments(xs, scale, bias, eps: float):
    """K3-fwd's launcher over the row segments ``xs`` (one tensor, or the
    patch part then the CLS part): ``(ys, stats)``, each segment's output
    and its row statistics mu and rstd stacked in one float32 allocation
    ``[2, ..., 1]``."""
    _check_cuda(xs, (scale, bias), bwd=False)
    D = xs[0].shape[-1]
    ys = [torch.empty_like(x) for x in xs]
    stats = [x.new_empty((2, *_stats_shape(x)), dtype=torch.float32)
             for x in xs]
    b = len(xs) - 1  # a single tensor is segment a, and b has no rows
    _launch("layer_norm_fwd", (xs[0], xs[b], scale, bias),
            (ys[0], ys[b], stats[0], stats[b]),
            (xs[0].numel() // D, xs[b].numel() // D if b else 0, D, eps))
    return ys, stats


def _bwd_segments(xs, scale, mus, rstds, dys):
    """K3-bwd's launcher over the row segments ``xs`` with their statistics
    and output grads: ``(dxs, [dscale; dbias] [2, D])``, the parameter
    grads summed over both segments by the kernel."""
    _check_cuda(xs, (scale,), bwd=True,
                rows=[r for seg in zip(xs, mus, rstds, dys)
                      for r in _bwd_rows(*seg)])
    x = xs[0]
    D = x.shape[-1]
    rows = [t.numel() // D for t in xs]
    dxs = [torch.empty_like(t) for t in xs]
    dparams = torch.empty((2, D), device=x.device, dtype=torch.float32)
    if sum(rows) == 0:
        return dxs, dparams.zero_()
    # the kernel's blocks, each writing one row of [dscale; dbias] partial
    # sums: as many as the launch can have (``persistent_grid``)
    part_rows = min(-(-sum(rows) // BWD_WARPS),
                    BWD_BLOCKS_PER_SM * _sms(x.device.index))
    part = torch.empty((part_rows, 2 * D), device=x.device,
                       dtype=torch.float32)
    b = len(xs) - 1
    _launch("layer_norm_bwd",
            (xs[0], xs[b], dys[0], dys[b], scale, mus[0], rstds[0], mus[b],
             rstds[b]), (dxs[0], dxs[b], part, dparams),
            (rows[0], rows[b] if b else 0, D, part_rows))
    return dxs, dparams


def _fwd_cuda(x, scale, bias, eps: float):
    """K3-fwd on one tensor: ``(y, stats [2, ..., 1])``."""
    (y,), (stats,) = _fwd_segments((x,), scale, bias, eps)
    return y, stats


def _bwd_cuda(x, scale, mu, rstd, dy):
    """K3-bwd on one tensor: ``(dx, [dscale; dbias] [2, D])``."""
    (dx,), dparams = _bwd_segments((x,), scale, (mu,), (rstd,), (dy,))
    return dx, dparams


def _pair_fwd_cuda(xc, xp, scale, bias, eps: float):
    """K3-fwd on the pair, one launch, the patch rows first: ``(yc, yp,
    stats_c, stats_p)``."""
    (yp, yc), (stats_p, stats_c) = _fwd_segments((xp, xc), scale, bias, eps)
    return yc, yp, stats_c, stats_p


def _pair_bwd_cuda(xc, xp, scale, mu_c, rstd_c, mu_p, rstd_p, dyc, dyp):
    """K3-bwd on the pair, one launch: ``(dxc, dxp, [dscale; dbias])``."""
    (dxp, dxc), dparams = _bwd_segments((xp, xc), scale, (mu_p, mu_c),
                                        (rstd_p, rstd_c), (dyp, dyc))
    return dxc, dxp, dparams


def _fwd_cpu(x, scale, bias, eps: float):
    y, mu, rstd = layer_norm_fwd_plain(x, scale, bias, eps)
    return y, torch.stack([mu, rstd])


def _bwd_cpu(x, scale, mu, rstd, dy):
    dx, dscale, dbias = layer_norm_bwd_plain(x, scale, mu, rstd, dy)
    return dx, torch.stack([dscale, dbias])


def _pair_fwd_cpu(xc, xp, scale, bias, eps: float):
    yc, yp, mu_c, rstd_c, mu_p, rstd_p = layer_norm_pair_fwd_plain(
        xc, xp, scale, bias, eps)
    return yc, yp, torch.stack([mu_c, rstd_c]), torch.stack([mu_p, rstd_p])


def _pair_bwd_cpu(xc, xp, scale, mu_c, rstd_c, mu_p, rstd_p, dyc, dyp):
    dxc, dxp, dscale, dbias = layer_norm_pair_bwd_plain(
        xc, xp, scale, mu_c, rstd_c, mu_p, rstd_p, dyc, dyp)
    return dxc, dxp, torch.stack([dscale, dbias])


def _stats_like(x):
    return x.new_empty((2, *_stats_shape(x)), dtype=torch.float32)


def _fwd_fake(x, scale, bias, eps: float):
    if x.device.type == "cuda":
        _check_cuda((x,), (scale, bias), bwd=False)
    return torch.empty_like(x), _stats_like(x)


def _bwd_fake(x, scale, mu, rstd, dy):
    if x.device.type == "cuda":
        _check_cuda((x,), (scale,), bwd=True, rows=_bwd_rows(x, mu, rstd, dy))
    return torch.empty_like(x), scale.new_empty((2, x.shape[-1]))


def _pair_fwd_fake(xc, xp, scale, bias, eps: float):
    if xc.device.type == "cuda":
        _check_cuda((xp, xc), (scale, bias), bwd=False)
    return (torch.empty_like(xc), torch.empty_like(xp), _stats_like(xc),
            _stats_like(xp))


def _pair_bwd_fake(xc, xp, scale, mu_c, rstd_c, mu_p, rstd_p, dyc, dyp):
    if xc.device.type == "cuda":
        _check_cuda((xp, xc), (scale,), bwd=True,
                    rows=(*_bwd_rows(xp, mu_p, rstd_p, dyp),
                          *_bwd_rows(xc, mu_c, rstd_c, dyc)))
    return (torch.empty_like(xc), torch.empty_like(xp),
            scale.new_empty((2, xc.shape[-1])))


_LN_FWD = ops.define(
    "layer_norm_fwd", "(Tensor x, Tensor scale, Tensor bias, float eps) -> "
    "(Tensor, Tensor)", _fwd_cpu, _fwd_cuda, _fwd_fake)
_LN_BWD = ops.define(
    "layer_norm_bwd", "(Tensor x, Tensor scale, Tensor mu, Tensor rstd, "
    "Tensor dy) -> (Tensor, Tensor)", _bwd_cpu, _bwd_cuda, _bwd_fake)
_LN_PAIR_FWD = ops.define(
    "layer_norm_pair_fwd", "(Tensor xc, Tensor xp, Tensor scale, Tensor bias, "
    "float eps) -> (Tensor, Tensor, Tensor, Tensor)", _pair_fwd_cpu,
    _pair_fwd_cuda, _pair_fwd_fake)
_LN_PAIR_BWD = ops.define(
    "layer_norm_pair_bwd", "(Tensor xc, Tensor xp, Tensor scale, Tensor mu_c, "
    "Tensor rstd_c, Tensor mu_p, Tensor rstd_p, Tensor dyc, Tensor dyp) -> "
    "(Tensor, Tensor, Tensor)", _pair_bwd_cpu, _pair_bwd_cuda, _pair_bwd_fake)


def layer_norm_fwd(x, scale, bias, eps: float):
    """K3-fwd: ``(y, mu, rstd)`` as ``layer_norm_fwd_plain``; ``x``
    contiguous."""
    y, stats = _LN_FWD(x, scale, bias, eps)
    return y, stats[0], stats[1]


def layer_norm_bwd(x, scale, mu, rstd, dy):
    """K3-bwd: ``(dx, dscale, dbias)`` as ``layer_norm_bwd_plain``."""
    dx, dparams = _LN_BWD(x, scale, mu, rstd, dy)
    return dx, dparams[0], dparams[1]


def layer_norm_pair_fwd(xc, xp, scale, bias, eps: float):
    """K3-fwd on the pair, one launch: ``(yc, yp, mu_c, rstd_c, mu_p,
    rstd_p)`` as ``layer_norm_pair_fwd_plain``; ``xc``, ``xp``
    contiguous."""
    yc, yp, stats_c, stats_p = _LN_PAIR_FWD(xc, xp, scale, bias, eps)
    return yc, yp, stats_c[0], stats_c[1], stats_p[0], stats_p[1]


def layer_norm_pair_bwd(xc, xp, scale, mu_c, rstd_c, mu_p, rstd_p, dyc, dyp):
    """K3-bwd on the pair, one launch: ``(dxc, dxp, dscale, dbias)`` as
    ``layer_norm_pair_bwd_plain``."""
    dxc, dxp, dparams = _LN_PAIR_BWD(xc, xp, scale, mu_c, rstd_c, mu_p,
                                     rstd_p, dyc, dyp)
    return dxc, dxp, dparams[0], dparams[1]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


class LayerNorm(torch.autograd.Function):
    """K3: ``apply(x, scale, bias, eps)``; saves x, scale, mu and rstd.
    Both passes launch without the dispatcher (``cuda_attention.direct``
    says why)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x = x.contiguous()
        fwd = _fwd_cpu if _on_cpu(x) else _fwd_cuda
        y, stats = fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, stats[0], stats[1])
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors  # unpacked once: recompute allows no more
        bwd = _bwd_cpu if _on_cpu(dy) else _bwd_cuda
        dx, dparams = bwd(*saved, dy.contiguous())
        return dx, dparams[0], dparams[1], None


class LayerNormPair(torch.autograd.Function):
    """K3 on a CLS part and a patch part with one set of parameters:
    ``apply(xc, xp, scale, bias, eps) -> (yc, yp)``, one launch each way;
    saves xc, xp, scale and both parts' ``[mu; rstd]``.  A part whose
    output gets no gradient is left out of the backward's launch (its
    input grad is ``None``)."""

    @staticmethod
    def forward(ctx, xc, xp, scale, bias, eps):
        xc, xp = xc.contiguous(), xp.contiguous()
        fwd = _pair_fwd_cpu if _on_cpu(xc) else _pair_fwd_cuda
        yc, yp, stats_c, stats_p = fwd(xc, xp, scale, bias, eps)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xc, xp, scale, stats_c, stats_p)
        return yc, yp

    @staticmethod
    def backward(ctx, dyc, dyp):
        xc, xp, scale, stats_c, stats_p = ctx.saved_tensors
        if dyc is None and dyp is None:
            return None, None, None, None, None
        if dyc is None or dyp is None:  # one part reaches no loss
            x, stats, dy = (xc, stats_c, dyc) if dyp is None else (
                xp, stats_p, dyp)
            bwd = _bwd_cpu if _on_cpu(dy) else _bwd_cuda
            dx, dparams = bwd(x, scale, stats[0], stats[1], dy.contiguous())
            dxc, dxp = (dx, None) if dyp is None else (None, dx)
        else:
            bwd = _pair_bwd_cpu if _on_cpu(dyc) else _pair_bwd_cuda
            dxc, dxp, dparams = bwd(xc, xp, scale, stats_c[0], stats_c[1],
                                    stats_p[0], stats_p[1], dyc.contiguous(),
                                    dyp.contiguous())
        return dxc, dxp, dparams[0], dparams[1], None


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; returns ``x.dtype``.  The autograd
    Function ``LayerNorm``, or with grad mode off the K3-fwd op
    (``cuda_attention.forward_only``)."""
    if forward_only():
        return _LN_FWD(x.contiguous(), scale, bias, eps)[0]
    return LayerNorm.apply(x, scale, bias, eps)


def fused_layer_norm_pair(xc: torch.Tensor, xp: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          eps: float = 1e-6) -> tuple:
    """``(fused_layer_norm(xc, ...), fused_layer_norm(xp, ...))`` in one
    launch: the autograd Function ``LayerNormPair``, or with grad mode off
    the pair's K3-fwd op."""
    if forward_only():
        return _LN_PAIR_FWD(xc.contiguous(), xp.contiguous(), scale, bias,
                            eps)[:2]
    return LayerNormPair.apply(xc, xp, scale, bias, eps)


class FusedLayerNorm(nn.Module):
    """``nn.LayerNorm``-named parameters (``weight``, ``bias``, float32);
    the output keeps the activation dtype.  ``pair(xc, xp)`` norms a CLS
    part and a patch part in one launch."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 device: "torch.device | str | None" = None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, self.eps)

    def pair(self, xc: torch.Tensor, xp: torch.Tensor) -> tuple:
        return fused_layer_norm_pair(xc, xp, self.weight, self.bias,
                                     self.eps)
