"""The training steps of EgoClip pretraining and the EPIC-Kitchens MIR,
CharadesEgo and Ego4D OSCC / PNR fine-tunes, and the evaluation
embedding steps.

EgoClip: counterpart of ``make_egoclip_train_step``
(``egovlp_tpu/train/steps.py`` :89-188): scene negatives concatenated to
the batch (:116-122), the train transform drawn from the step's
``torch.Generator``, the dual-encoder forward, the cosine similarity
matrix, EgoNCE with ``sim_matrix(verb_vec, verb_vec)`` /
``sim_matrix(noun_vec, noun_vec)`` masks (:177-183) or InfoNCE, backward
and the optimizer step.  The step returns the loss as a device tensor and
never syncs with the host.  ``n_micro > 1`` (``trainer.grad_accum``) takes
the gradient by GradCache (``train/grad_cache.py``, :127-151): the
transformed batch (negatives included) is split into ``n_micro``
micro-batches, the loss taken on the full batch's embeddings with the
full batch's verb and noun vectors.  ``global_sim='ring'`` builds each
rank's rows of the global similarity on a ring of ranks
(``objectives/ring.py``); with no process group it is the gather path, as
JAX falls back without a data mesh (:98).  Ring with ``n_micro > 1``
raises, as in JAX (:105-107).

In a multi-process run (one process per GPU, the model wrapped in
``DistributedDataParallel``) the step computes the JAX step's global-batch
loss.  The global batch is the ranks' local batches in rank order, with
the scene negatives concatenated on the global rows, ``[pos_all;
neg_all]`` (:116-122).  Each rank draws the crop boxes and flips of the
whole global batch from the step's generator (the same on every rank) and
keeps its own rows; the text and video embeddings and the noun and verb
vectors are all-gathered (``core.collectives.all_gather_rows``) and put
in global order before the similarity and the loss.  A world-N step so
equals the one-process step on the concatenated batch, its gradient that
of the global loss.

EPIC-Kitchens MIR (``make_epic_train_step``, :195-221): the max-margin
ranking loss on the cosine similarity matrix, or its adaptive form whose
margins scale with each clip's caption relevancy (``relation``).
CharadesEgo (``make_charades_train_step``, :228-246): InfoNCE.  Both
draw the crop boxes and flips of the global batch and keep their rows,
and under DDP all-gather ``t``, ``v`` (and ``relation``) in rank order,
which is global order (these batches have no negatives), as the EgoClip
step does.  Ego4D OSCC and PNR (``make_oscc_train_step`` /
``make_pnr_train_step``, :251-296): video only, the cross entropy of the
class head (2 logits; 16, one a sampled frame, masked by the
state-change flag); they draw the global batch's crop boxes too and
all-gather the logits, targets and mask, so the loss is the JAX step's
global-batch loss at any world size.  The evaluation steps (:303-328)
embed collated batches with the eval transform: text and video, video
alone, text alone.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from egovlp_tpu_torch.core.collectives import all_gather_rows
from egovlp_tpu_torch.core.dist import in_process_group, process_shard
from egovlp_tpu_torch.data.transforms import (
    eval_resize,
    resized_crop_flip,
    sample_crop_boxes,
)
from egovlp_tpu_torch.models.dual_encoder import sim_matrix
from egovlp_tpu_torch.objectives.classification import cross_entropy, nll
from egovlp_tpu_torch.objectives.contrastive import egonce, info_nce
from egovlp_tpu_torch.objectives.ranking import adaptive_max_margin, max_margin
from egovlp_tpu_torch.objectives.ring import egoclip_ring_loss
from egovlp_tpu_torch.train.grad_cache import grad_cache_value_and_grad

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


def _global_rows(b: int, rank: int, world: int, negatives: bool,
                device: "torch.device | str" = "cpu") -> torch.Tensor:
    """Positions of rank ``rank``'s local rows (its ``b`` positives, then
    its ``b`` negatives when ``negatives``) in the global batch
    ``[pos_all; neg_all]``."""
    pos = torch.arange(rank * b, (rank + 1) * b, device=device)
    return torch.cat([pos, world * b + pos]) if negatives else pos


def _update(optimizer, loss: torch.Tensor) -> torch.Tensor:
    """Backward and the optimizer step; the loss, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_egoclip_train_step(loss_type: str = "EgoNCE", input_res: int = 224,
                            temperature: float = 0.05, noun: bool = True,
                            verb: bool = True, global_sim: str = "gather",
                            n_micro: int = 1) -> Callable:
    """``step(model, optimizer, batch, generator) -> loss`` (a 0-d device
    tensor).  ``batch`` holds device tensors shaped as the EgoClip collation
    gives them (``frames`` uint8 ``[B, T, pre, pre, 3]``, ``text_ids`` /
    ``text_mask`` ``[B, S]``, ``noun_vec`` / ``verb_vec``, and the ``_neg``
    twins when scene negatives are on).  In a multi-process run ``model``
    is the ``DistributedDataParallel`` wrapper and ``batch`` this rank's
    part of the global batch.  ``global_sim``: 'gather' or 'ring';
    ``n_micro``: GradCache micro-batches (the doubled batch must divide
    by it)."""
    if global_sim not in ("gather", "ring"):
        raise ValueError(f"global_sim={global_sim!r}: expected 'gather' or "
                         "'ring'")
    if n_micro > 1 and global_sim == "ring":
        raise ValueError("grad_accum composes with global_sim='gather' "
                         "only (the ring loss already bounds memory)")

    def step(model, optimizer, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        rank, world = process_shard()
        parts = {k: batch[k] for k, _ in _NEG_KEYS}
        negatives = "frames_neg" in batch
        if negatives:
            # scene-aware negatives double the batch
            parts = {k: torch.cat([batch[k], batch[n]], dim=0)
                     for k, n in _NEG_KEYS}
        frames = parts["frames"]
        b = batch["frames"].shape[0]
        boxes, flips = sample_crop_boxes(generator, world * frames.shape[0],
                                         frames.shape[2])
        if world > 1:
            rows = _global_rows(b, rank, world, negatives, boxes.device)
            boxes, flips = boxes[rows], flips[rows]
        video = resized_crop_flip(frames, boxes, flips, out_size=input_res)
        verb_vec, noun_vec = parts["verb_vec"], parts["noun_vec"]
        model.train()

        def loss_of(t, v):
            if global_sim == "ring" and in_process_group():
                rows = torch.stack([_global_rows(b, r, world, negatives,
                                                 t.device)
                                    for r in range(world)])
                return egoclip_ring_loss(
                    t, v, noun_vec, verb_vec, rows, loss_type=loss_type,
                    temperature=temperature, noun=noun, verb=verb)
            nv, vv = noun_vec, verb_vec
            if world > 1:
                # gathered rows come rank-major; put them in global order
                order = torch.argsort(torch.cat([
                    _global_rows(b, r, world, negatives, t.device)
                    for r in range(world)]))
                t, v, vv, nv = (all_gather_rows(x)[order] for x in
                                (t, v, vv, nv))
            sim = sim_matrix(t, v)
            if loss_type == "EgoNCE":
                return egonce(sim, sim_matrix(vv, vv), sim_matrix(nv, nv),
                              temperature, noun=noun, verb=verb)
            return info_nce(sim, temperature)

        if n_micro == 1:
            t, v = model(video, parts["text_ids"], parts["text_mask"],
                         generator=generator)
            return _update(optimizer, loss_of(t, v))

        def embed(mb):
            return model(mb["video"], mb["ids"], mb["mask"],
                         generator=generator)

        optimizer.zero_grad(set_to_none=True)
        loss = grad_cache_value_and_grad(embed, loss_of, n_micro)(
            {"video": video, "ids": parts["text_ids"],
             "mask": parts["text_mask"]},
            generator, getattr(model, "no_sync", None))
        optimizer.step()
        return loss

    return step


def _train_video(model, frames: torch.Tensor, generator: torch.Generator,
                 input_res: int) -> torch.Tensor:
    """The train transform of a batch without negatives, its crop boxes
    and flips drawn for the global batch and this rank's rows kept; puts
    ``model`` in training mode."""
    rank, world = process_shard()
    b = frames.shape[0]
    boxes, flips = sample_crop_boxes(generator, world * b, frames.shape[2])
    if world > 1:
        rows = _global_rows(b, rank, world, False, boxes.device)
        boxes, flips = boxes[rows], flips[rows]
    model.train()
    return resized_crop_flip(frames, boxes, flips, out_size=input_res)


def _finetune_forward(model, batch: Dict[str, torch.Tensor],
                      generator: torch.Generator, input_res: int,
                      gathered: tuple = ()) -> tuple:
    """The train transform and forward of a batch without negatives:
    ``(t, v, *batch[k] for k in gathered)``, all-gathered in global order
    in a multi-process run."""
    video = _train_video(model, batch["frames"], generator, input_res)
    t, v = model(video, batch["text_ids"], batch["text_mask"],
                 generator=generator)
    return tuple(all_gather_rows(x) for x in
                 (t, v, *(batch[k] for k in gathered)))


def _video_only_forward(model, batch: Dict[str, torch.Tensor],
                        generator: torch.Generator, input_res: int,
                        gathered: tuple = ()) -> tuple:
    """``_finetune_forward`` of the video-only tasks: ``(v, *batch[k] for
    k in gathered)``.  The text tower takes no part, so under DDP the
    wrapper must look for unused parameters
    (``recipes.data_parallel``)."""
    video = _train_video(model, batch["frames"], generator, input_res)
    v = model(video, generator=generator)
    return tuple(all_gather_rows(x) for x in
                 (v, *(batch[k] for k in gathered)))


def make_epic_train_step(loss_type: str = "MaxMarginRankingLoss",
                         input_res: int = 224, margin: float = 0.2,
                         fix_norm: bool = True) -> Callable:
    """``step(model, optimizer, batch, generator) -> loss`` of the EPIC MIR
    fine-tune; ``batch`` holds ``frames``, ``text_ids``, ``text_mask`` and,
    for ``AdaptiveMaxMarginRankingLoss``, ``relation``."""
    adaptive = loss_type == "AdaptiveMaxMarginRankingLoss"

    def step(model, optimizer, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        if adaptive:
            t, v, relation = _finetune_forward(model, batch, generator,
                                               input_res, ("relation",))
            loss = adaptive_max_margin(sim_matrix(t, v), relation,
                                       margin=margin, fix_norm=fix_norm)
        else:
            t, v = _finetune_forward(model, batch, generator, input_res)
            loss = max_margin(sim_matrix(t, v), margin=margin,
                              fix_norm=fix_norm)
        return _update(optimizer, loss)

    return step


def make_charades_train_step(input_res: int = 224,
                             temperature: float = 0.05) -> Callable:
    """``step(model, optimizer, batch, generator) -> loss`` of the
    CharadesEgo fine-tune: InfoNCE over the batch's clip-narration
    pairs."""
    def step(model, optimizer, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        t, v = _finetune_forward(model, batch, generator, input_res)
        return _update(optimizer, info_nce(sim_matrix(t, v), temperature))

    return step


def make_oscc_train_step(input_res: int = 224) -> Callable:
    """``step(model, optimizer, batch, generator) -> loss`` of the Ego4D
    OSCC fine-tune: the cross entropy of the 2-logit video head against
    ``state``, over the global batch."""
    def step(model, optimizer, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        logits, state = _video_only_forward(model, batch, generator,
                                            input_res, ("state",))
        return _update(optimizer, cross_entropy(logits, state))

    return step


def make_pnr_train_step(input_res: int = 224) -> Callable:
    """``step(model, optimizer, batch, generator) -> loss`` of the Ego4D
    PNR fine-tune: the cross entropy of the 16-logit video head against
    ``argmax(labels)``, masked by the state-change flag, ``sum(nll *
    mask) / max(sum(mask), 1)`` over the global batch."""
    def step(model, optimizer, batch: Dict[str, torch.Tensor],
             generator: torch.Generator) -> torch.Tensor:
        logits, labels, state = _video_only_forward(
            model, batch, generator, input_res, ("labels", "state"))
        mask = state.float()
        loss = (nll(logits, labels.argmax(dim=1)) * mask).sum() / \
            mask.sum().clamp_min(1.0)
        return _update(optimizer, loss)

    return step


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def embed_batch(model, frames, ids, mask, input_res: int = 224) -> tuple:
    """``(text, video)`` embeddings, float32, of a collated batch under the
    eval transform, on the model's device."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        video = eval_resize(_tensor(frames, device), out_size=input_res)
        return model(video, _tensor(ids, device), _tensor(mask, device))


def embed_video(model, frames, input_res: int = 224) -> torch.Tensor:
    """Video embeddings, float32, under the eval transform."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        return model.encode_video(
            eval_resize(_tensor(frames, device), out_size=input_res))


def embed_text(model, ids, mask) -> torch.Tensor:
    """Text embeddings, float32."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        return model.encode_text(_tensor(ids, device), _tensor(mask, device))
