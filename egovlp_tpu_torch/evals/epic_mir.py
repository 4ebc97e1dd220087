"""EPIC-Kitchens MIR evaluation, with optional dual-softmax.

Counterpart of ``egovlp_tpu/evals/epic_mir.py``: embed the whole test
split, score it with either the cosine similarity rescaled to [0, 1] or
the EgoVLP+ dual-softmax (raw dot products -> row softmax at temperature
500 times the raw matrix -> column softmax), take the columns of each
sentence's first matching video, then nDCG and mAP against the relevancy
matrix.  Scoring is numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from egovlp_tpu_torch.core.dist_eval import gather_eval
from egovlp_tpu_torch.metrics.mir import retrieval_metrics
from egovlp_tpu_torch.train.steps import embed_batch


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def dual_softmax(text_embeds: np.ndarray, vid_embeds: np.ndarray,
                 temperature: float = 500.0) -> np.ndarray:
    """EgoVLP+ dual-softmax rescoring, on RAW dot products (not
    cosine)."""
    s = text_embeds @ vid_embeds.T
    s = _softmax(s / temperature, axis=1) * s
    return _softmax(s, axis=0)


def cosine_rescaled(text_embeds: np.ndarray, vid_embeds: np.ndarray
                    ) -> np.ndarray:
    t = text_embeds / np.maximum(
        np.linalg.norm(text_embeds, axis=1, keepdims=True), 1e-8)
    v = vid_embeds / np.maximum(
        np.linalg.norm(vid_embeds, axis=1, keepdims=True), 1e-8)
    return (t @ v.T + 1) / 2


def evaluate_epic_mir(text_embeds: np.ndarray, vid_embeds: np.ndarray,
                      video_ids: Sequence, text_ids: Sequence,
                      relevancy: np.ndarray,
                      use_dual_softmax: bool = True) -> Dict[str, float]:
    """nDCG and mAP of raw text and video embeddings in dataset order (one
    row per test clip) against the relevancy matrix ``[video,
    sentence]``."""
    if use_dual_softmax:
        sim = dual_softmax(text_embeds, vid_embeds)
    else:
        sim = cosine_rescaled(text_embeds, vid_embeds)
    # each sentence's column: the first clip with its id
    first_pos: Dict = {}
    for i, v in enumerate(video_ids):
        first_pos.setdefault(v, i)
    indexes = [first_pos[t] for t in text_ids]
    return retrieval_metrics(sim.T[:, indexes], relevancy)


def embed_dataset(model, loader, input_res: int = 224,
                  return_meta: bool = False):
    """``(text_embeds, vid_embeds, item_indices)`` of every item of an EPIC
    loader's epoch 0, raw (not normalised) and in dataset order; with
    ``return_meta`` also ``{'texts', 'paths'}`` in the same order (for the
    ranking report).  In a multi-process run each rank embeds its shard
    and ``gather_eval``, by ``item_v``, drops the shard pads and gives
    every rank every row."""
    model.eval()
    t_all, v_all, idx_all, texts, paths = [], [], [], [], []
    for batch in loader.epoch(0):
        t, v = embed_batch(model, batch["frames"], batch["text_ids"],
                           batch["text_mask"], input_res)
        t_all.append(t.cpu().numpy())
        v_all.append(v.cpu().numpy())
        idx_all.append(np.asarray(batch["item_v"]))
        texts.extend(batch.get("text", [""] * len(t)))
        paths.extend(batch.get("path", [""] * len(t)))
    idx = np.concatenate(idx_all)
    g, meta = gather_eval({"t": np.concatenate(t_all),
                           "v": np.concatenate(v_all), "idx": idx},
                          index=idx, objects={"texts": texts, "paths": paths})
    out = (g["t"], g["v"], g["idx"])
    return out + (meta,) if return_meta else out
