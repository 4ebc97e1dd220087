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

``drop_rate`` and ``attn_drop_rate`` are not modelled: the JAX builder
never reads them from a config.  ``remat`` takes only ``False``/``'none'``
(what every shipped config but the ViT-L tensor-parallel one sets); the
recompute modes are listed in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from egovlp_tpu_torch.core.precision import Linear
from egovlp_tpu_torch.kernels.divided_attention import divided_attention_parts
from egovlp_tpu_torch.kernels.fused_ln import FusedLayerNorm


def resolve_attention_impls(cfg_impl: str):
    """Map ``attention_impl`` to ``(space_impl, time_impl)``.

    ``'auto'``/``'pallas'``: the hand-written kernels on a CUDA device (their
    plain twins on a CPU tensor); ``'xla'``: plain torch on both axes;
    ``'mixed'``: space kernel, time plain."""
    table = {"auto": ("pallas", "pallas"), "pallas": ("pallas", "pallas"),
             "xla": ("xla", "xla"), "mixed": ("pallas", "xla")}
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
        if self.remat not in (False, "none"):
            raise ValueError(
                f"remat={self.remat!r}: the port runs without activation "
                "recompute only (remat false/'none'); the recompute modes "
                "are still to port (ROADMAP.md, Queue A, A3)")

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class VarAttention(nn.Module):
    """qkv projection + divided attention along ``axis`` + output projection,
    applied to the ``(cls, grid)`` pair with shared weights."""

    def __init__(self, dim: int, num_heads: int, axis: str, impl: str,
                 qkv_bias: bool = True, zero_init: bool = False, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.axis = axis
        self.impl = impl
        self.zero_init = zero_init  # read by build.init_params
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, device=device)
        self.proj = Linear(dim, dim, device=device)

    def forward(self, xc, xp):
        qc, kc, vc = (t.contiguous() for t in self.qkv(xc).chunk(3, dim=-1))
        qp, kp, vp = (t.contiguous() for t in self.qkv(xp).chunk(3, dim=-1))
        oc, op = divided_attention_parts(qc, kc, vc, qp, kp, vp,
                                         heads=self.num_heads, axis=self.axis,
                                         impl=self.impl)
        return self.proj(oc), self.proj(op)


def drop_path(xc, xp, rate: float, generator: "torch.Generator | None"):
    """Per-sample path drop of the ``(cls, grid)`` pair: one keep mask per
    sample for both parts, kept parts scaled by ``1 / (1 - rate)``."""
    if generator is None:
        raise ValueError("drop_path in training mode needs an explicit "
                         "torch.Generator")
    keep = 1.0 - rate
    mask = (torch.rand(xc.shape[0], generator=generator,
                       device=generator.device) < keep).to(xc.device)
    return (xc * (mask.reshape(-1, 1, 1) / keep).to(xc.dtype),
            xp * (mask.reshape(-1, 1, 1, 1) / keep).to(xp.dtype))


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: VideoTowerConfig, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        D = cfg.embed_dim
        self.drop_path = drop_path
        space_impl, time_impl = resolve_attention_impls(cfg.attention_impl)
        self.norm1 = FusedLayerNorm(D, cfg.ln_eps, device=device)
        self.norm2 = FusedLayerNorm(D, cfg.ln_eps, device=device)
        self.norm3 = FusedLayerNorm(D, cfg.ln_eps, device=device)
        self.timeattn = VarAttention(D, cfg.num_heads, "time", time_impl,
                                     qkv_bias=cfg.qkv_bias,
                                     zero_init=cfg.time_init == "zeros",
                                     device=device)
        self.attn = VarAttention(D, cfg.num_heads, "space", space_impl,
                                 qkv_bias=cfg.qkv_bias, device=device)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio), device=device)

    def forward(self, xc, xp, generator: "torch.Generator | None" = None):
        drop = self.training and self.drop_path > 0.0
        tc, tp = self.timeattn(self.norm3(xc), self.norm3(xp))
        sc, sp = self.attn(self.norm1(xc + tc), self.norm1(xp + tp))
        if drop:
            sc, sp = drop_path(sc, sp, self.drop_path, generator)
        # residual from the ORIGINAL x, not from x + time (reference quirk)
        rc, rp = xc + sc, xp + sp
        mc, mp = self.mlp(self.norm2(rc)), self.mlp(self.norm2(rp))
        if drop:
            mc, mp = drop_path(mc, mp, self.drop_path, generator)
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
        return F.linear(x, w.to(x.dtype), self.proj.bias.to(x.dtype))


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
