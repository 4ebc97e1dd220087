"""Divided space-time attention with the CLS splice.

Counterpart of ``egovlp_tpu/kernels/divided_attention.py``.  The CLS
query attends over all keys, CLS key first, in plain torch, as the JAX
package does outside its kernels; the patch queries go through the
grouped kernels of ``cuda_attention``:

* ``axis='space'``: each frame's n patches attend over [CLS; that frame];
* ``axis='time'``: each patch column's f frames attend over [CLS; column].

Three entry points, as in the JAX package:

* ``divided_attention_parts`` (:300, ``_cls_row_parts`` :156): the tower's
  ``(cls [B, 1, D], grid [B, f, n, D])`` pair, through K1 / K2;
* ``divided_attention_bsd`` (:377): un-split ``[B, S, D]``, through K1 / K2
  with the CLS row outside the kernel;
* ``divided_attention`` (:37): the head-split ``[B, H, S, hd]`` op with q
  already scaled, through K4 (space) and K5 (time).  No tower calls it.

``impl='pallas'`` goes through the autograd Functions (forward and
backward kernels on a CUDA tensor, their plain twins on a CPU tensor);
``impl='xla'`` is plain torch, which autograd differentiates directly: the
oracle path.  The CLS row is plain torch in both and gets its gradient
from autograd, as the JAX package gets it from ``jax.grad`` of plain jnp.
"""

from __future__ import annotations

import torch

from egovlp_tpu_torch.kernels.cuda_attention import (
    GroupedAttention,
    SpaceAttention,
    TimeAttention,
    TimeAttentionHS,
    space_attention_fwd_plain,
    time_attention_fwd_plain,
)


def _plain(fn):
    def grouped(q, k, v, cls_k, cls_v, heads, scale):
        return fn(q, k, v, cls_k, cls_v, heads=heads, scale=scale)
    return grouped


# (axis, impl) -> grouped op ``(q, k, v, cls_k, cls_v, heads, scale)``;
# 'xla2' is the JAX package's canonical-relayout time path
# (``_time_xla_parts_v2``), the same math as 'xla'
_GROUPED = {
    ("space", "pallas"): SpaceAttention.apply,
    ("space", "xla"): _plain(space_attention_fwd_plain),
    ("time", "pallas"): TimeAttention.apply,
    ("time", "xla"): _plain(time_attention_fwd_plain),
    ("time", "xla2"): _plain(time_attention_fwd_plain),
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
      impl: ``'pallas'`` (kernel wrappers) or ``'xla'`` (plain torch);
        ``'xla2'`` (time only) is ``'xla'``.

    Returns ``(cls_out [B, 1, D], out_p [B, f, n, D])``.
    """
    if (axis, impl) not in _GROUPED:
        raise ValueError(f"axis must be 'space'/'time' and impl "
                         f"'pallas'/'xla' (or 'xla2' on time); got {axis!r}, "
                         f"{impl!r}")
    scale = float(qp.shape[-1] // heads) ** -0.5
    cls_out = _cls_row_parts(qc, kc, vc, kp, vp, heads, scale)
    out_p = _GROUPED[axis, impl](qp, kp, vp, kc, vc, heads, scale)
    return cls_out, out_p


def divided_attention(q, k, v, *, frames: int, patches: int, axis: str,
                      impl: str = "xla") -> torch.Tensor:
    """Divided space-time attention on head-split inputs.

    Args:
      q, k, v: ``[B, H, S, hd]`` with ``S = 1 + frames * patches``; ``q``
        already scaled by ``hd ** -0.5``.
      frames, patches: f and n.
      axis: ``'space'`` (group = frame, length n) or ``'time'`` (group =
        patch column, length f).
      impl: ``'pallas'``: K4 ``GroupedAttention`` on the space groups, K5
        ``TimeAttentionHS`` on the natural ``[BH, f, n, hd]`` layout for
        time; ``'xla'``: plain torch (float32 logits and softmax,
        probabilities rounded to the input dtype before the value sum).

    Returns ``[B, H, S, hd]``, the CLS row first.
    """
    if axis not in ("space", "time") or impl not in ("pallas", "xla"):
        raise ValueError(f"axis must be 'space'/'time' and impl "
                         f"'pallas'/'xla'; got {axis!r}, {impl!r}")
    B, H, S, hd = q.shape
    if S != 1 + frames * patches:
        raise ValueError(f"S={S} is not 1 + frames * patches = "
                         f"1 + {frames} * {patches}")
    dt = q.dtype
    cls_k, cls_v = k[:, :, :1], v[:, :, :1]

    # CLS row: full attention over all S tokens
    cls_logits = q[:, :, :1].float() @ k.float().transpose(-1, -2)
    cls_out = torch.softmax(cls_logits, dim=-1).to(dt) @ v  # [B, H, 1, hd]

    def cls(c):  # [B, H, 1, hd] -> contiguous [BH, 1, hd]
        return c.reshape(B * H, 1, hd).contiguous()

    if impl == "pallas" and axis == "time":
        def nat(t):  # patch tokens as [BH, f, n, hd]: an explicit copy
            return t[:, :, 1:].reshape(B * H, frames, patches, hd).contiguous()

        out_t = TimeAttentionHS.apply(nat(q), nat(k), nat(v), cls(cls_k),
                                      cls(cls_v))
        return torch.cat([cls_out, out_t.reshape(B, H, frames * patches, hd)],
                         dim=2)

    # patch tokens in groups: [BH, G, L, hd]
    G, L = (frames, patches) if axis == "space" else (patches, frames)

    def group(t):
        t = t[:, :, 1:].reshape(B, H, frames, patches, hd)
        if axis == "time":
            t = t.transpose(2, 3)
        return t.reshape(B * H, G, L, hd).contiguous()

    qg, kg, vg = group(q), group(k), group(v)
    if impl == "pallas":
        out_g = GroupedAttention.apply(qg, kg, vg, cls(cls_k), cls(cls_v))
    else:
        # splice CLS k/v in front of every group
        def splice(c, t):
            return torch.cat([cls(c)[:, None].expand(B * H, G, 1, hd), t],
                             dim=2)

        logits = qg.float() @ splice(cls_k, kg).float().transpose(-1, -2)
        probs = torch.softmax(logits, dim=-1).to(dt)
        out_g = probs @ splice(cls_v, vg)
    out_g = out_g.reshape(B, H, G, L, hd)
    if axis == "time":
        out_g = out_g.transpose(2, 3)
    return torch.cat([cls_out, out_g.reshape(B, H, frames * patches, hd)],
                     dim=2)


def divided_attention_bsd(q, k, v, *, heads: int, frames: int, patches: int,
                          axis: str, impl: str = "pallas") -> torch.Tensor:
    """Divided attention on un-split ``[B, S, D]`` projections.

    ``impl='pallas'``: K1 / K2 (heads sliced inside the kernels, q scaled
    there) through ``divided_attention_parts``, the CLS row outside the
    kernel.  Any other ``impl`` splits the heads, scales q in its dtype and
    calls ``divided_attention``.
    """
    B, S, D = q.shape
    hd = D // heads
    scale = float(hd) ** -0.5

    if impl != "pallas":
        def split(t):
            return t.reshape(B, S, heads, hd).transpose(1, 2)

        out = divided_attention(split(q) * scale, split(k), split(v),
                                frames=frames, patches=patches, axis=axis,
                                impl=impl)
        return out.transpose(1, 2).reshape(B, S, D)

    def grid(t):
        return t[:, 1:].reshape(B, frames, patches, D).contiguous()

    def first(t):
        return t[:, :1].contiguous()

    cls_out, out_p = divided_attention_parts(
        first(q), first(k), first(v), grid(q), grid(k), grid(v), heads=heads,
        axis=axis, impl="pallas")
    return torch.cat([cls_out, out_p.reshape(B, frames * patches, D)], dim=1)
