"""Mixed-precision policy (counterpart of ``egovlp_tpu/core/precision.py``).

Parameters live in float32.  Matmuls run in the compute dtype (bf16 by
default, ``arch.args.precision``); softmax and LayerNorm statistics run in
float32 inside the ops that need them.  Elementwise ops round where the
JAX package's do: each op's result in the activation dtype.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: "torch.Tensor | None") -> torch.Tensor:
    """``x @ weight.T + bias`` with the parameters cast to x's dtype (flax
    ``Dense(dtype=...)`` semantics): the product is rounded to the
    activation dtype, then the bias is added in it."""
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing ``linear``: float32 parameters, the matmul
    and the bias add in the activation dtype.  ``reduce(x, weight)``, set
    on a row-parallel layer (``core/tp.py``), is the product summed over
    the model group; the bias is added after it.  ``product(x)`` is the
    layer without its bias, for a caller that adds the bias itself (the
    MLP's ``kernels.bias_gelu``)."""

    reduce = None

    def product(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduce is None:
            return F.linear(x, self.weight.to(x.dtype))
        return self.reduce(x, self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.product(x)
        return y if self.bias is None else y + self.bias.to(x.dtype)


@functools.cache
def _sqrt_half(dtype: torch.dtype) -> float:
    return torch.tensor(math.sqrt(0.5)).to(dtype).item()


def gelu(h: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU as ``jax.nn.gelu(approximate=False)`` computes it:
    ``(0.5 * h) * erfc(-h * sqrt(0.5))``, with sqrt(0.5) rounded to h's
    dtype and every op rounded to it (``h * -s`` rounds as ``-h * s``, one
    op fewer)."""
    s = _sqrt_half(h.dtype)
    return (0.5 * h) * torch.special.erfc(h * -s)


def compute_dtype(name: str) -> torch.dtype:
    """``arch.args.precision`` name -> compute dtype (parameters stay float32)."""
    return {
        "bf16": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "fp32": torch.float32,
        "float32": torch.float32,
    }[name]
