"""EgoMCQ multiple-choice evaluation.

Counterpart of ``egovlp_tpu/evals/egomcq.py`` (:26-72): per item, the
query text's embedding against the 5 candidate clips' embeddings gives a
1x5 similarity row; accuracy is grouped by type (``metrics/egomcq.py``).

The 5 options fold into the batch axis (``[B, 5, T, H, W, 3]`` ->
``[B * 5, T, H, W, 3]``), so the video tower scores B items a call; a
batch of B items scores as B batches of one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from egovlp_tpu_torch.core.dist_eval import gather_eval
from egovlp_tpu_torch.data.transforms import eval_resize
from egovlp_tpu_torch.metrics.egomcq import egomcq_accuracy_metrics


def mcq_scores(model, batch: Dict[str, np.ndarray],
               input_res: int = 224) -> np.ndarray:
    """``[B, 5]`` cosine scores of a collated EgoMCQ batch
    (``frames_options`` uint8 ``[B, 5, T, H, W, 3]``, ``text_ids``,
    ``text_mask``), computed on the model's device."""
    device = next(model.parameters()).device
    frames = torch.as_tensor(batch["frames_options"]).to(device)
    B, O = frames.shape[:2]
    with torch.inference_mode():
        video = eval_resize(frames.reshape((B * O,) + frames.shape[2:]),
                            out_size=input_res)
        v = model.encode_video(video)
        t = model.encode_text(torch.as_tensor(batch["text_ids"]).to(device),
                              torch.as_tensor(batch["text_mask"]).to(device))
        t = t / t.norm(dim=1, keepdim=True).clamp_min(1e-8)
        v = v / v.norm(dim=1, keepdim=True).clamp_min(1e-8)
        scores = torch.einsum("bd,bod->bo", t, v.reshape(B, O, -1))
    return scores.cpu().numpy()


def evaluate_egomcq(model, loader, input_res: int = 224) -> Dict[str, float]:
    """EgoMCQ accuracies over ``loader``'s epoch 0, whose batches hold
    ``frames_options``, ``text_ids``, ``text_mask``, ``correct``, ``type``
    and ``_index``.  In a multi-process run each rank scores its shard
    (``build.build_loader`` shards by rank) and ``gather_eval`` gives every
    rank the whole dataset's rows, so every rank returns the same
    accuracies."""
    model.eval()
    preds, gts, types, idxs = [], [], [], []
    for batch in loader.epoch(0):
        preds.append(mcq_scores(model, batch, input_res))
        gts.append(np.asarray(batch["correct"]))
        types.append(np.asarray(batch["type"]))
        idxs.append(np.asarray(batch["_index"]))
    g, _ = gather_eval(
        {"preds": np.concatenate(preds), "gts": np.concatenate(gts),
         "types": np.concatenate(types)},
        index=np.concatenate(idxs))
    return egomcq_accuracy_metrics(g["preds"], g["gts"], g["types"])
