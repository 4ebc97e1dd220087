"""LayerNorm with the JAX package's exact forward formula.

Counterpart of ``egovlp_tpu/kernels/fused_ln.py:42`` (plain jnp there, not
a Pallas kernel; forward only here).  ``F.layer_norm`` computes the
variance another way, so it is not used: statistics are float32, the
variance is ``max(E[x^2] - E[x]^2, 0)``, eps sits inside the rsqrt, and
the output ``(x - mu) * (rstd * scale) + bias`` is cast to the input dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; returns ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mu) * (rstd * scale.float()) + bias.float()
    return y.to(x.dtype)


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
