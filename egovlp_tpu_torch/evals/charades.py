"""CharadesEgo video-level multi-label evaluation.

Counterpart of ``egovlp_tpu/evals/charades.py``: the 157 class sentences
of ``Charades_v1_classes.txt`` (the ``cXXX `` prefix stripped) are
embedded once as the text side; each test video's cosine similarity to
every class is its score, and the 157-class mAP masks videos with no
ground-truth action.
"""

from __future__ import annotations

import csv
from typing import Dict, List

import numpy as np
import torch

from egovlp_tpu_torch.core.dist_eval import gather_eval
from egovlp_tpu_torch.metrics.charades import charades_metrics
from egovlp_tpu_torch.models.dual_encoder import sim_matrix
from egovlp_tpu_torch.train.steps import embed_text, embed_video


def load_charades_classes(path: str) -> List[str]:
    """``Charades_v1_classes.txt`` lines ``'c092 someone is ...'`` -> the
    sentences."""
    with open(path) as f:
        return [line[0][5:] for line in csv.reader(f)]


def evaluate_charades(model, loader, class_sentences: List[str], tokenizer,
                      input_res: int = 224, visualizer=None,
                      epoch: int = 0) -> Dict[str, float]:
    """The mAP over ``loader``'s epoch 0, whose batches hold ``frames``,
    ``target`` and ``_index``.  In a multi-process run each rank embeds its
    shard and ``gather_eval`` gives every rank every video, so every rank
    returns the same mAP.  A ``visualizer`` writes each class's top videos
    for ``epoch`` (multi-label: no ground truth highlighted)."""
    model.eval()
    ids, mask = tokenizer(class_sentences)
    cls = embed_text(model, ids, mask).cpu()
    vids, targets, idxs, paths = [], [], [], []
    for batch in loader.epoch(0):
        v = embed_video(model, batch["frames"], input_res).cpu().numpy()
        vids.append(v)
        targets.append(np.asarray(batch["target"]))
        idxs.append(np.asarray(batch["_index"]))
        paths.extend(batch.get("path", [""] * len(v)))
    g, gobj = gather_eval({"vids": np.concatenate(vids),
                           "targets": np.concatenate(targets)},
                          index=np.concatenate(idxs),
                          objects={"paths": paths})
    sims = sim_matrix(cls, torch.from_numpy(g["vids"])).T.numpy()
    if visualizer is not None:
        visualizer.visualize_ranking(sims.T, epoch, class_sentences,
                                     gobj["paths"], show_gt=False)
    return charades_metrics(sims, g["targets"])
