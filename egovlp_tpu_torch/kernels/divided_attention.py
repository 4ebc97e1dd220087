"""Divided space-time attention with the CLS token carried separately.

Counterpart of ``egovlp_tpu/kernels/divided_attention.py``
(``divided_attention_parts`` :300, ``_cls_row_parts`` :156), on the
tower's ``(cls [B, 1, D], grid [B, f, n, D])`` pair.  The CLS query
attends over all keys, CLS key first, in plain torch, as the JAX package
does outside its kernels; the patch queries go through the grouped
kernels of ``cuda_attention``:

* ``axis='space'``: each frame's n patches attend over [CLS; that frame];
* ``axis='time'``: each patch column's f frames attend over [CLS; column].

``impl='pallas'`` goes through the autograd Functions ``SpaceAttention`` /
``TimeAttention`` (forward and backward kernels on a CUDA tensor, their
plain twins on a CPU tensor); ``impl='xla'`` is the plain forward, which
autograd differentiates directly: the oracle path.  The CLS row is plain
torch in both and gets its gradient from autograd, as the JAX package
gets it from ``jax.grad`` of plain jnp.
"""

from __future__ import annotations

import torch

from egovlp_tpu_torch.kernels.cuda_attention import (
    SpaceAttention,
    TimeAttention,
    space_attention_fwd_plain,
    time_attention_fwd_plain,
)


def _plain(fn):
    def grouped(q, k, v, cls_k, cls_v, heads, scale):
        return fn(q, k, v, cls_k, cls_v, heads=heads, scale=scale)
    return grouped


# (axis, impl) -> grouped op ``(q, k, v, cls_k, cls_v, heads, scale)``
_GROUPED = {
    ("space", "pallas"): SpaceAttention.apply,
    ("space", "xla"): _plain(space_attention_fwd_plain),
    ("time", "pallas"): TimeAttention.apply,
    ("time", "xla"): _plain(time_attention_fwd_plain),
}


def _cls_row_parts(qc, kc, vc, kp, vp, heads: int, scale: float):
    """CLS-query full-attention row: ``[B, 1, D]`` over [CLS; all patches].

    Logits and softmax in float32, probabilities rounded to the activation
    dtype before the value sum (as the JAX op does)."""
    B, D = kp.shape[0], kp.shape[-1]
    hd = D // heads
    dt = kp.dtype
    q3c = (qc.reshape(B, heads, hd) * scale).float()
    k4 = kp.reshape(B, -1, heads, hd).float()
    v4 = vp.reshape(B, -1, heads, hd).float()
    lg_c = (q3c * kc.reshape(B, heads, hd).float()).sum(-1, keepdim=True)
    lg_p = torch.einsum("bhd,bshd->bhs", q3c, k4)
    pr = torch.softmax(torch.cat([lg_c, lg_p], dim=-1), dim=-1).to(dt).float()
    oc = torch.einsum("bhs,bshd->bhd", pr[:, :, 1:], v4)
    oc = oc + pr[:, :, :1] * vc.reshape(B, heads, hd).float()
    return oc.reshape(B, 1, D).to(dt)


def divided_attention_parts(qc, kc, vc, qp, kp, vp, *, heads: int,
                            axis: str, impl: str = "pallas"):
    """Divided attention on the pair layout.

    Args:
      qc, kc, vc: ``[B, 1, D]`` CLS projections.
      qp, kp, vp: ``[B, f, n, D]`` patch projections (the grid layout).
      axis: ``'space'`` or ``'time'``.
      impl: ``'pallas'`` (kernel wrappers) or ``'xla'`` (plain torch).

    Returns ``(cls_out [B, 1, D], out_p [B, f, n, D])``.
    """
    if (axis, impl) not in _GROUPED:
        raise ValueError(f"axis must be 'space'/'time' and impl "
                         f"'pallas'/'xla'; got {axis!r}, {impl!r}")
    scale = float(qp.shape[-1] // heads) ** -0.5
    cls_out = _cls_row_parts(qc, kc, vc, kp, vp, heads, scale)
    out_p = _GROUPED[axis, impl](qp, kp, vp, kc, vc, heads, scale)
    return cls_out, out_p
