"""Dual encoder: SpaceTimeTransformer video tower + DistilBERT text tower.

Counterpart of ``egovlp_tpu/models/dual_encoder.py``:

* text feature  = DistilBERT ``last_hidden[:, 0]`` -> ``txt_proj`` (ReLU, Linear);
* video feature = SpaceTimeTransformer CLS -> ``vid_proj`` (Linear);
* ``projection=''`` makes both heads the identity.

The heads are ``nn.Sequential`` so their parameters carry the reference
names ``txt_proj.1.*`` and ``vid_proj.0.*``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from egovlp_tpu_torch.core.precision import Linear
from egovlp_tpu_torch.models.text_tower import DistilBert, TextTowerConfig
from egovlp_tpu_torch.models.video_tower import (
    SpaceTimeTransformer,
    VideoTowerConfig,
)


@dataclasses.dataclass(frozen=True)
class DualEncoderConfig:
    video: VideoTowerConfig = VideoTowerConfig()
    text: TextTowerConfig = TextTowerConfig()
    projection_dim: int = 256
    projection: str = "minimal"  # 'minimal' | ''


class DualEncoder(nn.Module):
    def __init__(self, cfg: DualEncoderConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.video_model = SpaceTimeTransformer(cfg.video, dtype, device=device)
        self.text_model = DistilBert(cfg.text, dtype, device=device)
        if cfg.projection == "minimal":
            self.txt_proj = nn.Sequential(
                nn.ReLU(), Linear(cfg.text.dim, cfg.projection_dim,
                                  device=device))
            self.vid_proj = nn.Sequential(
                Linear(cfg.video.embed_dim, cfg.projection_dim,
                       device=device))
        elif cfg.projection == "":
            self.txt_proj = nn.Identity()
            self.vid_proj = nn.Identity()
        else:
            raise NotImplementedError(cfg.projection)

    def encode_video(self, video, generator: "torch.Generator | None" = None):
        """``[B, T, H, W, 3]`` -> ``[B, projection_dim]`` float32;
        ``generator`` draws the drop-path masks in training mode."""
        return self.vid_proj(self.video_model(video, generator)).float()

    def encode_text(self, input_ids, attention_mask):
        """-> ``[B, projection_dim]`` CLS-pooled projected text embedding."""
        hidden = self.text_model(input_ids, attention_mask)
        return self.txt_proj(hidden[:, 0]).float()

    def encode_text_tokens(self, input_ids, attention_mask):
        """Token-level projected embeddings ``[B, S, projection_dim]``."""
        return self.txt_proj(self.text_model(input_ids, attention_mask)).float()

    def forward(self, video, input_ids=None, attention_mask=None,
                generator: "torch.Generator | None" = None):
        """The training forward (``DualEncoder.__call__`` of the JAX
        package, :90-96): ``(text_embeddings, video_embeddings)``.  With
        no ``input_ids`` it is the video-only forward of the OSCC / PNR
        steps and returns the video embeddings alone: a step calls it
        through ``DistributedDataParallel`` so that the video tower's
        gradients are all-reduced."""
        if input_ids is None:
            return self.encode_video(video, generator)
        return (self.encode_text(input_ids, attention_mask),
                self.encode_video(video, generator))


def sim_matrix(a: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-8) -> torch.Tensor:
    """Cosine-similarity matrix with eps-clamped norms."""
    a, b = a.float(), b.float()
    a_n = a.norm(dim=1, keepdim=True).clamp_min(eps)
    b_n = b.norm(dim=1, keepdim=True).clamp_min(eps)
    return (a / a_n) @ (b / b_n).T
