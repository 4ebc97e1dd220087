"""DistilBERT text tower, inference only.

Counterpart of ``egovlp_tpu/models/text_tower.py``: 6 post-LN blocks, dim
768, 12 heads, FFN 3072, learned positions, exact-erf GELU, LayerNorm eps
1e-12.  Submodules carry HuggingFace DistilBERT names
(``embeddings.LayerNorm``, ``transformer.layer.{i}.ffn.lin1``, ...), the
names of the reference checkpoints.  Attention stays plain torch: scores
in float32, masked keys set to ``finfo(float32).min``, probabilities cast
to the activation dtype before the value matmul.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from egovlp_tpu_torch.core.precision import Linear
from egovlp_tpu_torch.kernels.fused_ln import FusedLayerNorm

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class TextTowerConfig:
    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    max_position_embeddings: int = 512
    ln_eps: float = 1e-12


class Embeddings(nn.Module):
    def __init__(self, cfg: TextTowerConfig, device=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.dim,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.dim, device=device)
        self.LayerNorm = FusedLayerNorm(cfg.dim, cfg.ln_eps, device=device)

    def forward(self, input_ids, dtype: torch.dtype):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dtype)
             + self.position_embeddings(pos)[None].to(dtype))
        return self.LayerNorm(x)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TextTowerConfig, device=None):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.q_lin = Linear(cfg.dim, cfg.dim, device=device)
        self.k_lin = Linear(cfg.dim, cfg.dim, device=device)
        self.v_lin = Linear(cfg.dim, cfg.dim, device=device)
        self.out_lin = Linear(cfg.dim, cfg.dim, device=device)

    def forward(self, x, attention_mask):
        B, S, D = x.shape
        H = self.n_heads
        hd = D // H

        def heads(t):
            return t.reshape(B, S, H, hd).transpose(1, 2)

        q = heads(self.q_lin(x)) * hd ** -0.5
        k = heads(self.k_lin(x))
        v = heads(self.v_lin(x))
        scores = q.float() @ k.float().transpose(-1, -2)
        keep = attention_mask[:, None, None, :].bool()
        scores = scores.masked_fill(~keep, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(B, S, D)
        return self.out_lin(out)


class FFN(nn.Module):
    def __init__(self, cfg: TextTowerConfig, device=None):
        super().__init__()
        self.lin1 = Linear(cfg.dim, cfg.hidden_dim, device=device)
        self.lin2 = Linear(cfg.hidden_dim, cfg.dim, device=device)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TextTowerConfig, device=None):
        super().__init__()
        self.attention = SelfAttention(cfg, device=device)
        self.sa_layer_norm = FusedLayerNorm(cfg.dim, cfg.ln_eps, device=device)
        self.ffn = FFN(cfg, device=device)
        self.output_layer_norm = FusedLayerNorm(cfg.dim, cfg.ln_eps,
                                                device=device)

    def forward(self, x, attention_mask):
        x = self.sa_layer_norm(self.attention(x, attention_mask) + x)
        return self.output_layer_norm(self.ffn(x) + x)


class Transformer(nn.Module):
    def __init__(self, cfg: TextTowerConfig, device=None):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(cfg, device=device)
                                   for _ in range(cfg.n_layers))


class DistilBert(nn.Module):
    def __init__(self, cfg: TextTowerConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = Embeddings(cfg, device=device)
        self.transformer = Transformer(cfg, device=device)

    def forward(self, input_ids, attention_mask):
        """``[B, S]`` ids and mask -> last hidden states ``[B, S, D]``."""
        x = self.embeddings(input_ids, self.dtype)
        for layer in self.transformer.layer:
            x = layer(x, attention_mask)
        return x
