"""Ego4D OSCC / PNR evaluation.

Counterpart of ``egovlp_tpu/evals/oscc_pnr.py`` (:17-61): the video
head's logits of every item of the loader's epoch 0 under the eval
transform, with the label columns, then the binary accuracy (OSCC) or
the keyframe distance (PNR) on the host.  In a multi-process run each
rank embeds its shard and ``gather_eval`` gives every rank every row,
shard pads dropped and in dataset order, so every rank returns the same
metrics.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from egovlp_tpu_torch.core.dist_eval import gather_eval
from egovlp_tpu_torch.metrics.oscc_pnr import oscc_metrics, pnr_metrics
from egovlp_tpu_torch.train.steps import embed_video

PNR_KEYS = ("labels", "state", "fps", "parent_start_frame",
            "parent_end_frame", "parent_pnr_frame")


def _collect_logits(model, loader, input_res: int, keys: Sequence[str]):
    """``(logits, {key: column})`` of the whole dataset, float32 logits."""
    model.eval()
    logits, idxs = [], []
    extras = {k: [] for k in keys}
    for batch in loader.epoch(0):
        logits.append(embed_video(model, batch["frames"], input_res)
                      .cpu().numpy())
        for k in keys:
            extras[k].append(np.asarray(batch[k]))
        idxs.append(np.asarray(batch["_index"]))
    cols = {"logits": np.concatenate(logits)}
    cols.update({k: np.concatenate(v) for k, v in extras.items()})
    g, _ = gather_eval(cols, index=np.concatenate(idxs))
    return g.pop("logits"), g


def evaluate_oscc(model, loader, input_res: int = 224) -> Dict[str, float]:
    logits, ex = _collect_logits(model, loader, input_res, ("state",))
    return oscc_metrics(logits, ex["state"])


def evaluate_pnr(model, loader, input_res: int = 224) -> Dict[str, float]:
    logits, ex = _collect_logits(model, loader, input_res, PNR_KEYS)
    return pnr_metrics(logits, *(ex[k] for k in PNR_KEYS))
