"""SpaceTimeTransformer video tower, inference only.

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
* exact-erf GELU, LayerNorm eps 1e-6 with f32 statistics.

Dropout and drop-path are identity at inference and are not modelled.
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


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: VideoTowerConfig, device=None):
        super().__init__()
        D = cfg.embed_dim
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

    def forward(self, xc, xp):
        tc, tp = self.timeattn(self.norm3(xc), self.norm3(xp))
        sc, sp = self.attn(self.norm1(xc + tc), self.norm1(xp + tp))
        # residual from the ORIGINAL x, not from x + time (reference quirk)
        rc, rp = xc + sc, xp + sp
        return (rc + self.mlp(self.norm2(rc)),
                rp + self.mlp(self.norm2(rp)))


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
        self.blocks = nn.ModuleList(
            SpaceTimeBlock(cfg, device=device) for _ in range(cfg.depth))
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

    def forward(self, video):
        """video: ``[B, T, H, W, 3]`` channels-last, ``T <= num_frames``."""
        xc, xp = self.embed(video)
        for blk in self.blocks:
            xc, xp = blk(xc, xp)
        return self.norm(xc)[:, 0]
