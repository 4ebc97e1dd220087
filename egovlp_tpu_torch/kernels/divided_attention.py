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
backward kernels on a CUDA tensor, their plain twins on a CPU tensor,
which round where the kernels do), or, with grad mode off, through the
forward kernels' registered ops (``cuda_attention.forward_only``);
``impl='xla'`` (and ``'xla2'`` on time) is plain torch at the rounding
points of the JAX package's XLA paths, which autograd differentiates
directly.  The CLS row is plain
torch in both and gets its gradient from autograd, as the JAX package
gets it from ``jax.grad`` of plain jnp.
"""

from __future__ import annotations

import torch

from egovlp_tpu_torch.kernels import cuda_attention as ca
from egovlp_tpu_torch.kernels.cuda_attention import (
    GroupedAttention,
    SpaceAttention,
    TimeAttention,
    TimeAttentionHS,
)

_PARTS_IMPLS = {("space", "pallas"), ("space", "xla"), ("time", "pallas"),
                ("time", "xla"), ("time", "xla2")}


def _cls_row_parts(qc, kc, vc, kp, vp, heads: int, scale: float):
    """CLS-query full-attention row: ``[B, 1, D]`` over [CLS; all patches].

    At the JAX op's rounding points (:167-189): ``q * scale`` in the
    activation dtype, float32 logits and softmax, probabilities rounded to
    the dtype; the patch value sum is rounded to the dtype, then the CLS
    term ``p_cls * v_cls`` is added, each op in the dtype."""
    B, D = kp.shape[0], kp.shape[-1]
    hd = D // heads
    dt = kp.dtype
    q3c = (qc.reshape(B, heads, hd) * scale).float()
    k4 = kp.reshape(B, -1, heads, hd).float()
    v4 = vp.reshape(B, -1, heads, hd).float()
    lg_c = (q3c * kc.reshape(B, heads, hd).float()).sum(-1, keepdim=True)
    lg_p = torch.einsum("bhd,bshd->bhs", q3c, k4)
    pr = torch.softmax(torch.cat([lg_c, lg_p], dim=-1), dim=-1).to(dt)
    oc = torch.einsum("bhs,bshd->bhd", pr[:, :, 1:].float(), v4).to(dt)
    oc = oc + pr[:, :, :1] * vc.reshape(B, heads, hd)
    return oc.reshape(B, 1, D)


def _time_xla_parts(qc, kc, vc, qp, kp, vp, heads: int, scale: float,
                    relayout: bool = False):
    """The time axis in plain torch at the rounding points of the JAX XLA
    paths ``_time_xla_parts`` (:193) and, with ``relayout``,
    ``_time_xla_parts_v2`` (:255), whose one explicit ``[B, n, H, f, hd]``
    copy per tensor it makes too: float32 logits times the scale, the CLS
    logit spliced first, normalised probabilities rounded to the
    activation dtype, the patch value sum rounded to it, then the CLS term
    ``p_cls * v_cls`` added, each op in the dtype."""
    B, f, n, D = qp.shape
    hd = D // heads
    dt = qp.dtype

    def columns(t):  # [B, f, n, D] -> [B, n, H, f, hd]
        t = t.reshape(B, f, n, heads, hd).permute(0, 2, 3, 1, 4)
        return t.contiguous() if relayout else t

    q6, k6, v6 = columns(qp), columns(kp), columns(vp)
    q6f = q6.float()
    lg = (q6f @ k6.float().transpose(-1, -2)) * scale
    lg_cls = (q6f @ kc.reshape(B, 1, heads, hd, 1).float()) * scale
    pr = torch.softmax(torch.cat([lg_cls, lg], dim=-1), dim=-1).to(dt)
    out = (pr[..., 1:].float() @ v6.float()).to(dt)
    out = out + pr[..., :1] * vc.reshape(B, 1, heads, 1, hd)
    out_p = out.permute(0, 3, 1, 2, 4).reshape(B, f, n, D)
    return _cls_row_parts(qc, kc, vc, kp, vp, heads, scale), out_p


def divided_attention_parts(qc, kc, vc, qp, kp, vp, *, heads: int,
                            axis: str, impl: str = "pallas"):
    """Divided attention on the pair layout.

    Args:
      qc, kc, vc: ``[B, 1, D]`` CLS projections.
      qp, kp, vp: ``[B, f, n, D]`` patch projections (the grid layout).
      axis: ``'space'`` or ``'time'``.
      impl: ``'pallas'``: the CLS row in plain torch, the patch queries
        through K1 (space) or K2 (time).  ``'xla'``: the JAX XLA paths'
        plain torch at their rounding points (JAX :333-353): on space,
        ``divided_attention_bsd(impl='xla')`` on ``[cls; patches]``, CLS
        row included; on time, ``_time_xla_parts``.  ``'xla2'`` (time
        only): ``_time_xla_parts`` with the explicit relayout.

    Returns ``(cls_out [B, 1, D], out_p [B, f, n, D])``.
    """
    if (axis, impl) not in _PARTS_IMPLS:
        raise ValueError(f"axis must be 'space'/'time' and impl "
                         f"'pallas'/'xla' (or 'xla2' on time); got {axis!r}, "
                         f"{impl!r}")
    B, f, n, D = qp.shape
    scale = float(D // heads) ** -0.5
    if impl == "pallas":
        if ca.forward_only():
            fwd = (ca.space_attention_fwd if axis == "space"
                   else ca.time_attention_fwd)
            out_p = fwd(qp, kp, vp, kc, vc, heads=heads, scale=scale)
        else:
            fn = SpaceAttention if axis == "space" else TimeAttention
            out_p = fn.apply(qp, kp, vp, kc, vc, heads, scale)
        return _cls_row_parts(qc, kc, vc, kp, vp, heads, scale), out_p
    if axis == "time":
        return _time_xla_parts(qc, kc, vc, qp, kp, vp, heads, scale,
                               relayout=impl == "xla2")

    def cat(c, t):
        return torch.cat([c, t.reshape(B, f * n, D)], dim=1)

    out = divided_attention_bsd(cat(qc, qp), cat(kc, kp), cat(vc, vp),
                                heads=heads, frames=f, patches=n,
                                axis="space", impl="xla")
    return out[:, :1], out[:, 1:].reshape(B, f, n, D)


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

        x = (nat(q), nat(k), nat(v), cls(cls_k), cls(cls_v))
        out_t = (ca.time_attention_hs_fwd(*x) if ca.forward_only()
                 else TimeAttentionHS.apply(*x))
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
        x = (qg, kg, vg, cls(cls_k), cls(cls_v))
        out_g = (ca.grouped_attention_fwd(*x) if ca.forward_only()
                 else GroupedAttention.apply(*x))
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
