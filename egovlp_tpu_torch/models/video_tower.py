"""SpaceTimeTransformer video tower.

Counterpart of ``egovlp_tpu/models/video_tower.py``.  Parameter names are
the reference's (``blocks.{i}.timeattn.qkv.weight``, ...), so one
``load_state_dict`` takes weights exported from the JAX package and a
published EgoVLP checkpoint alike.  Kept from the JAX tower:

* activations ride as the ``(cls [B, 1, D], grid [B, T, n, D])`` pair
  between blocks, the layout the attention kernels take;
* block: ``t = x + timeattn(norm3(x))``, ``s = attn(norm1(t))``, and the
  space residual branches from the ORIGINAL ``x`` (reference quirk the
  published checkpoints depend on): ``x = (x + s) + mlp(norm2(x + s))``;
* ``time_init='zeros'``: zero time-attention qkv, all-ones output
  projection (applied by ``build.init_params``);
* the temporal embed is sliced to the input's ``T <= num_frames``;
* exact-erf GELU, LayerNorm eps 1e-6 with f32 statistics;
* training mode: drop-path at rates ``linspace(0, drop_path_rate, depth)``
  on the space-attention and MLP branches, one keep mask per sample for
  both parts of the pair, drawn from an explicit ``torch.Generator``
  (``video_tower.py:333-345`` of the JAX package).

Activation recompute (``remat``, JAX :95-108, :284-301, :414-415), by
``torch.utils.checkpoint`` (non-reentrant) unless said otherwise:

* ``False`` / ``'none'``: every activation saved;
* ``True`` / ``'block'``: each whole ``SpaceTimeBlock`` recomputed;
* ``'attn'``: the two ``VarAttention`` applications (qkv, attention and
  output projection) recomputed;
* ``'attn_out'``: the attention outputs kept, so the backward recomputes
  only the qkv projection, not the attention kernel and not ``proj``.
  The attention Functions save their q, k and v, so a checkpoint around
  the qkv projection alone would free nothing: ``QKVAttention`` is one
  autograd Function over "qkv projection -> attention" that saves its
  input and the qkv weights, and whose backward recomputes q, k, v and
  calls the attention kernels' backward (K1-bwd / K2-bwd) directly;
* ``'mlp'``: each MLP recomputed.

A recompute must see the drop-path masks of its forward: each block draws
its two masks from the generator before any checkpointed region and
passes them in, so no recompute draws.

``drop_rate`` and ``attn_drop_rate`` are not modelled: the JAX builder
never reads them from a config.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from egovlp_tpu_torch.core.precision import Linear, gelu, linear
from egovlp_tpu_torch.kernels.cuda_attention import direct
from egovlp_tpu_torch.kernels.divided_attention import (
    _cls_row_parts,
    divided_attention_parts,
)
from egovlp_tpu_torch.kernels.fused_ln import FusedLayerNorm

# remat values -> the recompute mode
REMAT_MODES = {False: "none", "none": "none", True: "block", "block": "block",
               "attn": "attn", "attn_out": "attn_out", "mlp": "mlp"}


def resolve_attention_impls(cfg_impl: str):
    """Map ``attention_impl`` to ``(space_impl, time_impl)``.

    ``'auto'``/``'pallas'``: the hand-written kernels on a CUDA device (their
    plain twins on a CPU tensor); ``'xla'``: plain torch on both axes, at
    the rounding points of the JAX package's XLA paths; ``'mixed'``: space
    kernel, time plain; ``'mixed2'``: space kernel, time ``'xla2'`` (the
    JAX package's relayout variant of the plain time path, the same
    rounding)."""
    table = {"auto": ("pallas", "pallas"), "pallas": ("pallas", "pallas"),
             "xla": ("xla", "xla"), "mixed": ("pallas", "xla"),
             "mixed2": ("pallas", "xla2")}
    if cfg_impl not in table:
        raise ValueError(f"attention_impl must be one of {sorted(table)}, "
                         f"got {cfg_impl!r}")
    return table[cfg_impl]


@dataclasses.dataclass(frozen=True)
class VideoTowerConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 4
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    time_init: str = "zeros"  # 'zeros' => starts as a ViT; else random
    attention_impl: str = "auto"  # see resolve_attention_impls
    drop_path_rate: float = 0.0
    remat: "bool | str" = False

    def __post_init__(self):
        # bool or str only: 1 == True would find True's entry
        if not (isinstance(self.remat, (bool, str))
                and self.remat in REMAT_MODES):
            raise ValueError(
                f"remat={self.remat!r}: expected False/'none', True/'block', "
                "'attn', 'attn_out' or 'mlp'")

    @property
    def remat_mode(self) -> str:
        """'none', 'block', 'attn', 'attn_out' or 'mlp'."""
        return REMAT_MODES[self.remat]

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


def _projections(xc, xp, weight, bias):
    """``(qc, kc, vc, qp, kp, vp)``: the qkv projection of both parts, each
    third made contiguous."""
    return (*(t.contiguous() for t in linear(xc, weight, bias).chunk(3, -1)),
            *(t.contiguous() for t in linear(xp, weight, bias).chunk(3, -1)))


class QKVAttention(torch.autograd.Function):
    """``apply(xc, xp, weight, bias, heads, axis, impl) -> (oc, op)``: the
    qkv projection and divided attention of ``VarAttention`` as one
    Function that saves only ``xc``, ``xp`` and the qkv weights (remat
    ``'attn_out'``).  Its backward recomputes q, k, v, then, on the
    ``'pallas'`` route, takes the patch queries' gradients from the
    attention kernel's backward (no forward launch) and the CLS row's from
    autograd of its plain torch; on the plain routes it recomputes the
    attention under autograd."""

    @staticmethod
    def forward(ctx, xc, xp, weight, bias, heads, axis, impl):
        ctx.save_for_backward(xc, xp, weight, bias)
        ctx.heads, ctx.axis, ctx.impl = heads, axis, impl
        # an output that reaches no loss (the last block's patch part) gets
        # None, not zeros: its attention backward is skipped, as autograd
        # skips it without recompute
        ctx.set_materialize_grads(False)
        return divided_attention_parts(*_projections(xc, xp, weight, bias),
                                       heads=heads, axis=axis, impl=impl)

    @staticmethod
    def backward(ctx, doc, dop):
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            qc, kc, vc, qp, kp, vp = _projections(*leaves)
            outs, douts = [], []
            if ctx.impl == "pallas":
                scale = float(qp.shape[-1] // ctx.heads) ** -0.5
                if dop is not None:
                    douts += direct(f"{ctx.axis}_attention_bwd", qp.detach(),
                                    kp.detach(), vp.detach(), kc.detach(),
                                    vc.detach(), dop.contiguous(), ctx.heads,
                                    scale)
                    outs += [qp, kp, vp, kc, vc]
                if doc is not None:
                    outs.append(_cls_row_parts(qc, kc, vc, kp, vp, ctx.heads,
                                               scale))
                    douts.append(doc)
            else:
                oc, op = divided_attention_parts(qc, kc, vc, qp, kp, vp,
                                                 heads=ctx.heads,
                                                 axis=ctx.axis, impl=ctx.impl)
                for o, d in ((oc, doc), (op, dop)):
                    if d is not None:
                        outs.append(o)
                        douts.append(d)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, douts,
                                           allow_unused=True))
        return (*(next(got) if t is not None and t.requires_grad else None
                  for t in leaves), None, None, None)


class VarAttention(nn.Module):
    """qkv projection + divided attention along ``axis`` + output projection,
    applied to the ``(cls, grid)`` pair with shared weights.
    ``keep_attn_out``: the qkv projection and the attention run as
    ``QKVAttention`` (remat ``'attn_out'``)."""

    def __init__(self, dim: int, num_heads: int, axis: str, impl: str,
                 qkv_bias: bool = True, zero_init: bool = False,
                 keep_attn_out: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.axis = axis
        self.impl = impl
        self.zero_init = zero_init  # read by build.init_params
        self.keep_attn_out = keep_attn_out
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = Linear(dim, dim, device=device)

    def forward(self, xc, xp):
        w, b = self.qkv.weight, self.qkv.bias
        if self.keep_attn_out and torch.is_grad_enabled():
            oc, op = QKVAttention.apply(xc, xp, w, b, self.num_heads,
                                        self.axis, self.impl)
        else:
            oc, op = divided_attention_parts(*_projections(xc, xp, w, b),
                                             heads=self.num_heads,
                                             axis=self.axis, impl=self.impl)
        return self.proj(oc), self.proj(op)


def drop_path_mask(batch: int, rate: float,
                   generator: "torch.Generator | None") -> torch.Tensor:
    """One path-drop scale a sample, ``keep / (1 - rate)`` with ``keep``
    drawn from ``generator`` (float32 ``[batch]``, on the generator's
    device)."""
    if generator is None:
        raise ValueError("drop_path in training mode needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(batch, generator=generator,
                      device=generator.device) < keep
    return mask / keep


def drop_path(xc, xp, mask: torch.Tensor):
    """Per-sample path drop of the ``(cls, grid)`` pair by a
    ``drop_path_mask``: one scale per sample for both parts."""
    mask = mask.to(xc.device)
    return (xc * mask.reshape(-1, 1, 1).to(xc.dtype),
            xp * mask.reshape(-1, 1, 1, 1).to(xp.dtype))


def _recompute(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: VideoTowerConfig, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        D = cfg.embed_dim
        self.drop_path = drop_path
        self.remat = cfg.remat_mode
        space_impl, time_impl = resolve_attention_impls(cfg.attention_impl)
        keep = self.remat == "attn_out"
        self.norm1 = FusedLayerNorm(D, cfg.ln_eps, device=device)
        self.norm2 = FusedLayerNorm(D, cfg.ln_eps, device=device)
        self.norm3 = FusedLayerNorm(D, cfg.ln_eps, device=device)
        self.timeattn = VarAttention(D, cfg.num_heads, "time", time_impl,
                                     qkv_bias=cfg.qkv_bias,
                                     zero_init=cfg.time_init == "zeros",
                                     keep_attn_out=keep, device=device)
        self.attn = VarAttention(D, cfg.num_heads, "space", space_impl,
                                 qkv_bias=cfg.qkv_bias, keep_attn_out=keep,
                                 device=device)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio), device=device)

    def forward(self, xc, xp, generator: "torch.Generator | None" = None):
        # both masks drawn before any recomputed region (space, then MLP)
        masks = ((drop_path_mask(xc.shape[0], self.drop_path, generator),
                  drop_path_mask(xc.shape[0], self.drop_path, generator))
                 if self.training and self.drop_path > 0.0 else ())
        if self.remat == "block" and torch.is_grad_enabled():
            return _recompute(self._body, xc, xp, *masks)
        return self._body(xc, xp, *masks)

    def _attention(self, module, xc, xp):
        if self.remat == "attn" and torch.is_grad_enabled():
            return _recompute(module, xc, xp)
        return module(xc, xp)

    def _mlp(self, x):
        if self.remat == "mlp" and torch.is_grad_enabled():
            return _recompute(self.mlp, x)
        return self.mlp(x)

    def _body(self, xc, xp, space_mask=None, mlp_mask=None):
        tc, tp = self._attention(self.timeattn, self.norm3(xc), self.norm3(xp))
        sc, sp = self._attention(self.attn, self.norm1(xc + tc),
                                 self.norm1(xp + tp))
        if space_mask is not None:
            sc, sp = drop_path(sc, sp, space_mask)
        # residual from the ORIGINAL x, not from x + time (reference quirk)
        rc, rp = xc + sc, xp + sp
        mc, mp = self._mlp(self.norm2(rc)), self._mlp(self.norm2(rp))
        if mlp_mask is not None:
            mc, mp = drop_path(mc, mp, mlp_mask)
        return rc + mc, rp + mp


class PatchEmbed(nn.Module):
    """16x16 patch embedding as reshape + matmul over channels-last frames;
    the weight keeps the conv shape ``[D, 3, p, p]`` of the reference."""

    def __init__(self, patch_size: int, embed_dim: int, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size,
                              device=device)

    def forward(self, x):
        """x: ``[N, H, W, 3]`` -> ``[N, (H/p)*(W/p), D]``."""
        N, H, W, C = x.shape
        p = self.patch_size
        x = x.reshape(N, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(N, (H // p) * (W // p), C * p * p)
        w = self.proj.weight.reshape(self.proj.weight.shape[0], -1)
        # the product rounded to x's dtype, then the bias added in it
        return F.linear(x, w.to(x.dtype)) + self.proj.bias.to(x.dtype)


class SpaceTimeTransformer(nn.Module):
    """Divided space-time attention transformer; returns the CLS feature."""

    def __init__(self, cfg: VideoTowerConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, D, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.patches_per_frame + 1, D, device=device))
        self.temporal_embed = nn.Parameter(
            torch.zeros(1, cfg.num_frames, D, device=device))
        rates = torch.linspace(0.0, cfg.drop_path_rate, cfg.depth).tolist()
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, rate, device=device) for rate in rates)
        self.norm = FusedLayerNorm(D, cfg.ln_eps, device=device)

    def embed(self, video):
        """``[B, T, H, W, 3]`` -> the ``(cls, grid)`` activation pair."""
        B, T, H, W, C = video.shape
        if T > self.cfg.num_frames:
            raise ValueError(f"{T} frames > num_frames={self.cfg.num_frames}")
        D, dt = self.cfg.embed_dim, self.dtype
        x = self.patch_embed(video.reshape(B * T, H, W, C).to(dt))
        x = x.reshape(B, T, -1, D)
        cls = (self.cls_token.to(dt).expand(B, 1, D)
               + self.pos_embed[:, :1].to(dt))
        patch_pos = (self.pos_embed[:, None, 1:, :]
                     + self.temporal_embed[:, :T, None, :])
        return cls, x + patch_pos.to(dt)

    def forward(self, video, generator: "torch.Generator | None" = None):
        """video: ``[B, T, H, W, 3]`` channels-last, ``T <= num_frames``;
        ``generator`` draws the drop-path masks in training mode."""
        xc, xp = self.embed(video)
        for blk in self.blocks:
            xc, xp = blk(xc, xp, generator)
        return self.norm(xc)[:, 0]
