"""The MLP's bias add and exact GELU, one hand-written kernel each way (K7).

The JAX package has no kernel here: its MLP calls ``nn.gelu`` on a Dense
output, plain jnp that XLA fuses with the bias add.  The port computes the
same rounding chain as ``core/precision``'s ``linear`` and ``gelu``: with
``h = rnd(y + rnd(b))``, ``a = rnd(0.5 h)``, ``c = rnd(h * -s)``, ``e =
rnd(erfc(c))`` and ``g = rnd(a e)``, where ``s`` is sqrt(0.5) rounded to
y's dtype and each op is computed in float32 and rounded to y's dtype.
Its backward is the chain's slope, ``dh = rnd(dg * (0.5 e + a s (2 /
sqrt(pi)) exp(-c^2)))``, computed in float32 from the rounded ``a``, ``c``
and ``e`` and rounded once; ``dh`` is also y's gradient, and the bias
gradient is ``dh`` summed over the rows in float32, rounded to y's dtype
and back to float32, as the PyTorch ops' ``bias.to(dtype)`` backward does.
``b`` may be ``None`` (under tensor parallelism ``column_linear`` has
added the bias): then ``h = y`` and there is no bias gradient.

The autograd Function ``BiasGelu`` saves only ``y`` and ``b``: one
hidden-sized tensor, where autograd's chain of PyTorch ops saves three
(``c``, ``a`` and ``e``).  Its backward recomputes the chain from ``y``.

On a CUDA tensor the forward and the backward are one hand-written kernel
each, K7-fwd (``csrc/bias_gelu_fwd.cu``) and K7-bwd
(``csrc/bias_gelu_bwd.cu``, whose second small kernel sums the bias
gradient), counted in ``cuda_attention.launches`` once a call; on a CPU
tensor their plain twins below.  The forward equals the PyTorch ops bit
for bit.  They are ops, ``torch.ops.egovlp_torch.bias_gelu_{fwd,bwd}``
(``kernels/ops.py``), whose outputs are ``g``, and ``dy`` with the
bias gradient (an empty float32 tensor where ``b`` is ``None``).  The
kernels take contiguous rows of a width that is a multiple of 8, bf16 or
float32, 16-byte aligned, and a float32 bias; any other CUDA input
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from egovlp_tpu_torch.core.precision import _sqrt_half, gelu
from egovlp_tpu_torch.kernels import ops
from egovlp_tpu_torch.kernels._build import load_library
from egovlp_tpu_torch.kernels.cuda_attention import (
    _DTYPE_CODES,
    _launch,
    forward_only,
)


@functools.cache
def slope_scale(dtype: torch.dtype) -> float:
    """``s * 2 / sqrt(pi)`` in float32, ``s`` sqrt(0.5) rounded to
    ``dtype``: the constant of GELU's slope."""
    s = torch.tensor(_sqrt_half(dtype), dtype=torch.float32)
    return (s * torch.tensor(2 / math.sqrt(math.pi))).item()


def bias_gelu_fwd_plain(y, b):
    """Plain PyTorch K7-fwd: ``gelu(y + b.to(y.dtype))``, or ``gelu(y)``
    where ``b`` is None, with ``core/precision``'s ops."""
    return gelu(y if b is None else y + b.to(y.dtype))


def bias_gelu_bwd_plain(dg, y, b):
    """Plain PyTorch K7-bwd: ``(dy, dbias)``, dbias None where ``b`` is
    None.  The chain's ``a``, ``c`` and ``e`` rounded as the forward
    rounds them, the slope in float32, ``dy`` rounded once."""
    dt = y.dtype
    h = y if b is None else y + b.to(dt)
    a, c = 0.5 * h, h * -_sqrt_half(dt)
    e = torch.special.erfc(c)
    af, cf = a.float(), c.float()
    slope = 0.5 * e.float() + af * slope_scale(dt) * torch.exp(-(cf * cf))
    dy = (dg.float() * slope).to(dt)
    if b is None:
        return dy, None
    rows = tuple(range(dy.dim() - 1))
    return dy, dy.float().sum(dim=rows).to(dt).to(b.dtype)


def _check_cuda(y, b, others=()) -> None:
    """What the kernels take (see the module notes), or raise: ``others``
    are tensors laid out as ``y`` (dg)."""
    D = y.shape[-1]
    if y.dtype not in _DTYPE_CODES or (b is not None
                                       and b.dtype != torch.float32):
        raise TypeError(f"bias_gelu kernels take float32 or bfloat16 rows and "
                        f"a float32 bias, got {y.dtype}, "
                        f"{None if b is None else b.dtype}")
    if D % 8:
        raise ValueError(f"bias_gelu kernels take a width that is a multiple "
                         f"of 8, got {D}")
    if b is not None and (b.shape != (D,) or b.device != y.device):
        raise ValueError(f"bias_gelu bias must be [{D}] on {y.device}, got "
                         f"{tuple(b.shape)} on {b.device}")
    for t in others:
        if t.shape != y.shape or t.dtype != y.dtype or t.device != y.device:
            raise ValueError(f"{tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"expected {tuple(y.shape)} {y.dtype} on "
                             f"{y.device}")
    ts = (y, *others) if b is None else (y, b, *others)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("bias_gelu kernels take contiguous tensors")


def _bwd_chunks(rows: int, width: int, dtype: torch.dtype, index: int) -> int:
    """The chunks of rows K7-bwd cuts ``[rows, width]`` into on device
    ``index``: the rows of its scratch of column sums (the kernel's own
    choice, ``egovlp_bias_gelu_bwd_chunks``)."""
    lib, chunks = load_library(), ctypes.c_int()
    err = lib.egovlp_bias_gelu_bwd_chunks(rows, width, _DTYPE_CODES[dtype],
                                          index, ctypes.byref(chunks))
    if err != 0:
        raise RuntimeError(f"bias_gelu_bwd chunks at [{rows}, {width}]: "
                           f"{lib.egovlp_cuda_error_string(err).decode()}")
    return chunks.value


def _fwd_cuda(y, b):
    """K7-fwd's launcher: ``g``."""
    _check_cuda(y, b)
    g = torch.empty_like(y)
    D = y.shape[-1]
    _launch("bias_gelu_fwd", (y, b), (g,),
            (y.numel() // D, D, _sqrt_half(y.dtype)))
    return g


def _bwd_cuda(dg, y, b):
    """K7-bwd's launcher: ``(dy, dbias)``, dbias float32 ``[D]`` (empty
    where ``b`` is None); the kernel writes each chunk's column sums to
    scratch and sums them."""
    _check_cuda(y, b, (dg,))
    D = y.shape[-1]
    rows = y.numel() // D
    dy = torch.empty_like(y)
    dbias = y.new_empty((0 if b is None else D,), dtype=torch.float32)
    part = None if b is None else y.new_empty(
        (_bwd_chunks(rows, D, y.dtype, y.device.index), D),
        dtype=torch.float32)
    _launch("bias_gelu_bwd", (dg, y, b),
            (dy, part, None if b is None else dbias),
            (rows, D, 0 if part is None else part.shape[0],
             _sqrt_half(y.dtype), slope_scale(y.dtype)))
    return dy, dbias


def _bwd_cpu(dg, y, b):
    dy, dbias = bias_gelu_bwd_plain(dg, y, b)
    return dy, y.new_empty((0,), dtype=torch.float32) if b is None else dbias


def _fwd_fake(y, b):
    if y.device.type == "cuda":
        _check_cuda(y, b)
    return torch.empty_like(y)


def _bwd_fake(dg, y, b):
    if y.device.type == "cuda":
        _check_cuda(y, b, (dg,))
    return (torch.empty_like(y),
            y.new_empty((0 if b is None else y.shape[-1],),
                        dtype=torch.float32))


_FWD = ops.define("bias_gelu_fwd", "(Tensor y, Tensor? b) -> Tensor",
                  bias_gelu_fwd_plain, _fwd_cuda, _fwd_fake)
_BWD = ops.define("bias_gelu_bwd",
                  "(Tensor dg, Tensor y, Tensor? b) -> (Tensor, Tensor)",
                  _bwd_cpu, _bwd_cuda, _bwd_fake)


def bias_gelu_fwd(y, b):
    """K7-fwd: ``g`` as ``bias_gelu_fwd_plain``; ``y`` contiguous."""
    return _FWD(y, b)


def bias_gelu_bwd(dg, y, b):
    """K7-bwd: ``(dy, dbias)`` as ``bias_gelu_bwd_plain``."""
    dy, dbias = _BWD(dg, y, b)
    return dy, None if b is None else dbias


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


class BiasGelu(torch.autograd.Function):
    """K7: ``apply(y, b)``; saves y and b.  Both passes launch without the
    dispatcher (``cuda_attention.direct`` says why)."""

    @staticmethod
    def forward(ctx, y, b):
        y = y.contiguous()
        fwd = bias_gelu_fwd_plain if _on_cpu(y) else _fwd_cuda
        ctx.save_for_backward(y, b)
        return fwd(y, b)

    @staticmethod
    def backward(ctx, dg):
        y, b = ctx.saved_tensors  # unpacked once: recompute allows no more
        bwd = bias_gelu_bwd_plain if _on_cpu(dg) else _bwd_cuda
        dy, dbias = bwd(dg.contiguous(), y, b)
        return dy, None if b is None else dbias


def bias_gelu(y: torch.Tensor, b: "torch.Tensor | None") -> torch.Tensor:
    """``gelu(y + b)`` with ``core/precision``'s rounding (``b`` None:
    ``gelu(y)``); returns ``y.dtype``.  The autograd Function
    ``BiasGelu``, or with grad mode off the K7-fwd op
    (``cuda_attention.forward_only``)."""
    if forward_only():
        return _FWD(y.contiguous(), b)
    return BiasGelu.apply(y, b)
