"""The EgoClip training step.

Counterpart of ``make_egoclip_train_step`` (``egovlp_tpu/train/steps.py``
:89-188) on its ``global_sim='gather'``, ``n_micro=1`` path: scene
negatives concatenated to the batch (:116-122), the train transform drawn
from the step's ``torch.Generator``, the dual-encoder forward, the cosine
similarity matrix, EgoNCE with ``sim_matrix(verb_vec, verb_vec)`` /
``sim_matrix(noun_vec, noun_vec)`` masks (:177-183) or InfoNCE, backward
and the optimizer step.  The step returns the loss as a device tensor and
never syncs with the host.  ``'ring'`` similarity and gradient
accumulation are still to port (ROADMAP.md, Queue A, A12).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from egovlp_tpu_torch.data.transforms import resized_crop_flip, sample_crop_boxes
from egovlp_tpu_torch.models.dual_encoder import sim_matrix
from egovlp_tpu_torch.objectives.contrastive import egonce, info_nce

_NEG_KEYS = (("frames", "frames_neg"), ("text_ids", "text_neg_ids"),
             ("text_mask", "text_neg_mask"), ("noun_vec", "noun_vec_neg"),
             ("verb_vec", "verb_vec_neg"))


def numeric_batch(batch: dict) -> dict:
    """The batch without its host-side metadata: keeps numpy arrays,
    tensors and scalars, drops strings and ``_``-prefixed keys (:37-48)."""
    def ok(v):
        return isinstance(v, (np.ndarray, torch.Tensor)) or np.isscalar(v)

    return {k: v for k, v in batch.items()
            if ok(v) and not isinstance(v, str) and not k.startswith("_")}


def make_egoclip_train_step(loss_type: str = "EgoNCE", input_res: int = 224,
                            temperature: float = 0.05, noun: bool = True,
                            verb: bool = True, global_sim: str = "gather",
                            n_micro: int = 1) -> Callable:
    """``step(model, optimizer, batch, generator) -> loss`` (a 0-d device
    tensor).  ``batch`` holds device tensors shaped as the EgoClip collation
    gives them (``frames`` uint8 ``[B, T, pre, pre, 3]``, ``text_ids`` /
    ``text_mask`` ``[B, S]``, ``noun_vec`` / ``verb_vec``, and the ``_neg``
    twins when scene negatives are on)."""
    if global_sim != "gather":
        raise NotImplementedError(
            f"global_sim={global_sim!r}: only 'gather' is ported; the ring "
            "similarity is still to port (ROADMAP.md, Queue A, A12)")
    if n_micro != 1:
        raise NotImplementedError(
            "grad_accum > 1 (GradCache) is still to port (ROADMAP.md, Queue "
            "A, A12)")

    def step(model, optimizer, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        parts = {k: batch[k] for k, _ in _NEG_KEYS}
        if "frames_neg" in batch:
            # scene-aware negatives double the batch
            parts = {k: torch.cat([batch[k], batch[n]], dim=0)
                     for k, n in _NEG_KEYS}
        frames = parts["frames"]
        boxes, flips = sample_crop_boxes(generator, frames.shape[0],
                                         frames.shape[2])
        video = resized_crop_flip(frames, boxes, flips, out_size=input_res)

        model.train()
        t, v = model(video, parts["text_ids"], parts["text_mask"],
                     generator=generator)
        sim = sim_matrix(t, v)
        if loss_type == "EgoNCE":
            loss = egonce(sim, sim_matrix(parts["verb_vec"], parts["verb_vec"]),
                          sim_matrix(parts["noun_vec"], parts["noun_vec"]),
                          temperature, noun=noun, verb=verb)
        else:
            loss = info_nce(sim, temperature)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
