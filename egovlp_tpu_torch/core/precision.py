"""Mixed-precision policy (counterpart of ``egovlp_tpu/core/precision.py``).

Parameters live in float32.  Matmuls run in the compute dtype (bf16 by
default, ``arch.args.precision``); softmax and LayerNorm statistics run in
float32 inside the ops that need them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 parameters are cast to the activation
    dtype for the matmul (flax ``Dense(dtype=...)`` semantics)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def compute_dtype(name: str) -> torch.dtype:
    """``arch.args.precision`` name -> compute dtype (parameters stay float32)."""
    return {
        "bf16": torch.bfloat16,
        "bfloat16": torch.bfloat16,
        "fp32": torch.float32,
        "float32": torch.float32,
    }[name]
