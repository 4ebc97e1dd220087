"""Construct the model, tokenizer, datasets and loaders from a task config.

Counterpart of ``egovlp_tpu/train/build.py``: ``build_model_config`` (the
same ``arch.args`` schema, with ``drop_path_rate`` and ``remat``),
``build_model``, ``init_params`` with an explicit ``torch.Generator``,
``load_pretrained`` (torch ``.pth`` files only), ``build_tokenizer``,
``build_dataset`` and ``build_loader``.  A loader's batch size is per
process, and each process drives one GPU; the shard is the process's
``torch.distributed`` rank when that is initialized, else 0 of 1.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from egovlp_tpu_torch.core.dist_eval import process_shard
from egovlp_tpu_torch.core.precision import Linear, compute_dtype
from egovlp_tpu_torch.data.datasets import DatasetConfig, dataset_factory
from egovlp_tpu_torch.data.pipeline import Loader
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.kernels.fused_ln import FusedLayerNorm
from egovlp_tpu_torch.models.convert import load_pth, load_torch_weights
from egovlp_tpu_torch.models.dual_encoder import DualEncoder, DualEncoderConfig
from egovlp_tpu_torch.models.text_tower import TextTowerConfig
from egovlp_tpu_torch.models.video_tower import (
    PatchEmbed,
    SpaceTimeTransformer,
    VarAttention,
    VideoTowerConfig,
)


def build_model_config(arch: Dict[str, Any]) -> DualEncoderConfig:
    a = arch.get("args", arch)
    vp = dict(a.get("video_params", {}))
    tp = dict(a.get("text_params", {}))
    video = VideoTowerConfig(
        num_frames=int(vp.get("num_frames", 4)),
        time_init=vp.get("time_init", "zeros"),
        img_size=int(vp.get("img_size", 224)),
        patch_size=int(vp.get("patch_size", 16)),
        embed_dim=int(vp.get("embed_dim", 768)),
        depth=int(vp.get("depth", 12)),
        num_heads=int(vp.get("num_heads", 12)),
        attention_impl=vp.get("attention_impl", "auto"),
        drop_path_rate=float(vp.get("drop_path_rate", 0.0)),
        remat=vp.get("remat", False),
    )
    text = TextTowerConfig(
        vocab_size=int(tp.get("vocab_size", 30522)),
        dim=int(tp.get("dim", 768)),
        n_layers=int(tp.get("n_layers", 6)),
        n_heads=int(tp.get("n_heads", 12)),
        hidden_dim=int(tp.get("hidden_dim", 3072)),
        max_position_embeddings=int(tp.get("max_position_embeddings", 512)),
    )
    return DualEncoderConfig(
        video=video,
        text=text,
        projection_dim=int(a.get("projection_dim", 256)),
        projection=a.get("projection", "minimal"),
    )


def build_model(arch: Dict[str, Any], device: "torch.device | str",
                dtype: Optional[torch.dtype] = None
                ) -> Tuple[DualEncoder, DualEncoderConfig]:
    """An eval-mode model on ``device`` with UNINITIALISED parameters: call
    ``init_params`` or load weights next.  Compute dtype: ``dtype`` >
    ``arch.args.precision`` ('bf16'/'fp32') > bf16."""
    cfg = build_model_config(arch)
    if dtype is None:
        dtype = compute_dtype(arch.get("args", arch).get("precision", "bf16"))
    model = DualEncoder(cfg, dtype, device="meta").to_empty(device=device)
    return model.eval(), cfg


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in place: lecun-normal weights, zero biases, unit
    LayerNorms, 0.02-normal tokens and embeddings, zero temporal embed, and
    the reference's zero time attention where ``time_init='zeros'``."""
    device = next(model.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)

    def lecun(w, fan_in):
        w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Linear):
                lecun(m.weight, m.in_features)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FusedLayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, PatchEmbed):
                lecun(m.proj.weight, m.proj.weight[0].numel())
                m.proj.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 0.02, generator=g)
            elif isinstance(m, SpaceTimeTransformer):
                m.cls_token.normal_(0.0, 0.02, generator=g)
                m.pos_embed.normal_(0.0, 0.02, generator=g)
                m.temporal_embed.zero_()
        for m in model.modules():
            if isinstance(m, VarAttention) and m.zero_init:
                m.qkv.weight.zero_()
                if m.qkv.bias is not None:
                    m.qkv.bias.zero_()
                m.proj.weight.fill_(1.0)
                m.proj.bias.zero_()
    return model


def load_pretrained(model: DualEncoder, arch: Dict[str, Any],
                    logger=None) -> DualEncoder:
    """The reference's load order: a full EgoVLP checkpoint
    (``arch.args.load_checkpoint``, a torch pickle) when it exists, loaded
    strictly;
    otherwise timm ViT weights into the video tower and DistilBERT weights
    into the text tower, each where its file exists (keys the tower does
    not have are skipped, as the reference's ``strict=False`` does)."""
    a = arch.get("args", arch)
    fix = a.get("load_temporal_fix", "zeros")
    frames = model.cfg.video.num_frames

    def log(msg):
        if logger:
            logger.info(msg)

    ckpt = a.get("load_checkpoint") or ""
    if os.path.isdir(ckpt):
        raise ValueError(
            f"{ckpt} is a directory (an Orbax checkpoint?): reading Orbax "
            "needs jax; export it to a torch .pth with `python -m "
            "egovlp_tpu.cli.convert export_torch`")
    if ckpt and os.path.exists(ckpt):
        log(f"loading full checkpoint {ckpt}")
        model.load_state_dict(load_pth(ckpt, frames, fix), strict=True)
        return model

    def load_part(tower: nn.Module, sd):
        own = tower.state_dict()
        tower.load_state_dict({k: v for k, v in sd.items() if k in own},
                              strict=False)

    vit = a.get("video_params", {}).get(
        "vit_weights", "pretrained/jx_vit_base_p16_224-80ecf9dd.pth")
    if vit and os.path.exists(vit):
        log(f"initializing video tower from {vit}")
        load_part(model.video_model, load_pth(vit, frames, fix))
    txt = a.get("text_params", {}).get(
        "weights", "pretrained/distilbert-base-uncased/pytorch_model.bin")
    if txt and os.path.exists(txt):
        log(f"initializing text tower from {txt}")
        sd = {k.removeprefix("distilbert."): v.float()
              for k, v in load_torch_weights(txt).items()}
        load_part(model.text_model, sd)
    return model


def build_tokenizer(config: Config, max_length: int = 30
                    ) -> Optional[WordPieceTokenizer]:
    """WordPiece over ``arch.args.text_params.vocab`` (else ``$EGOVLP_VOCAB``,
    else the reference's path); None when the file does not exist."""
    vocab = config.get_path("arch.args.text_params.vocab") or os.environ.get(
        "EGOVLP_VOCAB", "pretrained/distilbert-base-uncased/vocab.txt")
    if not os.path.exists(vocab):
        return None
    return WordPieceTokenizer(vocab, max_length=max_length)


def build_dataset(dl_args: Dict[str, Any], split: str):
    name = dl_args["dataset_name"]
    vp = dl_args.get("video_params", {})
    ds_cfg = DatasetConfig(
        data_dir=dl_args.get("data_dir", ""),
        meta_dir=dl_args.get("meta_dir"),
        split=split,
        num_frames=int(vp.get("num_frames", dl_args.get("num_frames", 4))),
        pre_size=int(vp.get("pre_size", 256)),
        input_res=int(vp.get("input_res", 224)),
        loading=vp.get("loading", "strict"),
        neg_param=dl_args.get("neg_param"),
        subsample=dl_args.get("subsample", 1),
        max_samples=dl_args.get("max_samples"),
        sliding_window_stride=int(dl_args.get("sliding_window_stride", -1)),
        extra=dl_args.get("extra", {}),
    )
    return dataset_factory(name)(ds_cfg)


def build_loader(dl_args: Dict[str, Any], split: str,
                 tokenizer: Optional[WordPieceTokenizer],
                 batch_size: Optional[int] = None,
                 max_samples_per_epoch: Optional[int] = None) -> Loader:
    ds = build_dataset(dl_args, split)
    shard, num_shards = process_shard()
    return Loader(
        ds,
        batch_size=batch_size or int(dl_args.get("batch_size", 16)),
        tokenizer=tokenizer,
        num_workers=int(dl_args.get("num_workers", 8)),
        num_procs=int(dl_args.get("num_procs", 0)),
        seed=int(dl_args.get("seed", 0)),
        shard=shard,
        num_shards=num_shards,
        drop_last=(split == "train"),
        shuffle=(split == "train") if dl_args.get("shuffle") is None
        else bool(dl_args.get("shuffle")),
        max_samples_per_epoch=max_samples_per_epoch,
        item_timeout=dl_args.get("item_timeout_sec"),
    )
