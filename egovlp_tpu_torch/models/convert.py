"""Weights into the port's modules, under the reference's parameter names.

Counterpart of ``egovlp_tpu/models/convert.py``.  The port's modules use
the names ``export_dual_encoder`` (:254) emits, so one
``load_state_dict(strict=True)`` takes either source:

* ``params_from_jax(params)``: a Flax dual-encoder param tree (nested
  dicts of numpy arrays) -> state dict;
* ``load_pth(path, num_frames)``: a reference ``{state_dict: ...}`` pickle,
  with ``module.`` stripping and temporal-embed inflation.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def strip_data_parallel_prefix(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """Drop the ``module.`` DataParallel prefix when every key has it."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return dict(sd)


def inflate_temporal_embed(embed: torch.Tensor, target_frames: int,
                           mode: str = "zeros") -> torch.Tensor:
    """``[1, F, D]`` temporal embed -> ``[1, target_frames, D]``.

    More frames than the target: truncate.  Fewer: zero-pad (``zeros``),
    nearest (``nearest``: src = floor(i * F / F')), or linear interpolation
    with aligned corners (``interp``/``bilinear``).
    """
    _, f, d = embed.shape
    if f == target_frames:
        return embed
    if f > target_frames:
        return embed[:, :target_frames]
    if mode == "zeros":
        out = embed.new_zeros(1, target_frames, d)
        out[:, :f] = embed
        return out
    if mode == "nearest":
        idx = torch.arange(target_frames) * f // target_frames
        return embed[:, idx]
    if mode in ("interp", "bilinear"):
        src = (torch.arange(target_frames, dtype=torch.float64)
               * (f - 1) / (target_frames - 1))
        lo = src.floor().long()
        hi = (lo + 1).clamp_max(f - 1)
        w = (src - lo)[None, :, None]
        e = embed.double()
        return (e[:, lo] * (1 - w) + e[:, hi] * w).to(embed.dtype)
    raise NotImplementedError(mode)


def params_from_jax(params: Mapping[str, object]) -> StateDict:
    """Flax dual-encoder tree (numpy leaves) -> the port's state dict."""
    sd: StateDict = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))

    def lin(prefix, node):
        put(f"{prefix}.weight", np.asarray(node["kernel"]).T)
        if "bias" in node:
            put(f"{prefix}.bias", node["bias"])

    def ln(prefix, node):
        put(f"{prefix}.weight", node["scale"])
        put(f"{prefix}.bias", node["bias"])

    v = params["video_model"]
    put("video_model.patch_embed.proj.weight",
        np.asarray(v["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("video_model.patch_embed.proj.bias", v["patch_embed"]["bias"])
    for name in ("cls_token", "pos_embed", "temporal_embed"):
        put(f"video_model.{name}", v[name])
    ln("video_model.norm", v["norm"])
    blocks = sorted(k for k in v if k.startswith("block"))
    for i, key in enumerate(blocks):
        blk, t = v[key], f"video_model.blocks.{i}"
        for name in ("norm1", "norm2", "norm3"):
            ln(f"{t}.{name}", blk[name])
        for attn in ("attn", "timeattn"):
            lin(f"{t}.{attn}.qkv", blk[attn]["qkv"])
            lin(f"{t}.{attn}.proj", blk[attn]["proj"])
        lin(f"{t}.mlp.fc1", blk["mlp"]["fc1"])
        lin(f"{t}.mlp.fc2", blk["mlp"]["fc2"])

    tm = params["text_model"]
    put("text_model.embeddings.word_embeddings.weight",
        tm["word_embeddings"]["embedding"])
    put("text_model.embeddings.position_embeddings.weight",
        tm["position_embeddings"]["embedding"])
    ln("text_model.embeddings.LayerNorm", tm["embeddings_layer_norm"])
    layers = sorted(k for k in tm if k.startswith("layer"))
    for i, key in enumerate(layers):
        layer, t = tm[key], f"text_model.transformer.layer.{i}"
        for name in ("q_lin", "k_lin", "v_lin", "out_lin"):
            lin(f"{t}.attention.{name}", layer["attention"][name])
        ln(f"{t}.sa_layer_norm", layer["sa_layer_norm"])
        lin(f"{t}.ffn.lin1", layer["ffn_lin1"])
        lin(f"{t}.ffn.lin2", layer["ffn_lin2"])
        ln(f"{t}.output_layer_norm", layer["output_layer_norm"])

    if "txt_proj" in params:
        lin("txt_proj.1", params["txt_proj"])
    if "vid_proj" in params:
        lin("vid_proj.0", params["vid_proj"])
    return sd


def load_torch_weights(path: str) -> StateDict:
    """Tensors of a torch pickle, raw or under a ``state_dict`` field."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def load_pth(path: str, num_frames: int,
             load_temporal_fix: str = "zeros") -> StateDict:
    """A reference EgoVLP checkpoint -> the port's float32 state dict."""
    sd = strip_data_parallel_prefix(load_torch_weights(path))
    key = "video_model.temporal_embed"
    if key in sd:
        sd[key] = inflate_temporal_embed(sd[key], num_frames, load_temporal_fix)
    return {k: v.float() for k, v in sd.items()}
