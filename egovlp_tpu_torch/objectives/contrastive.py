"""Contrastive objectives: InfoNCE (NormSoftmax) and EgoNCE.

Counterpart of ``egovlp_tpu/objectives/contrastive.py``: pure functions of
the (global-batch) similarity matrix, computed in float32.
"""

from __future__ import annotations

import torch


def info_nce(sim: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE with diagonal positives:
    ``-mean(diag(logsoftmax(S/t))) - mean(diag(logsoftmax(S.T/t)))``."""
    s = sim.float() / temperature
    i = torch.log_softmax(s, dim=1).diagonal()
    j = torch.log_softmax(s.T, dim=1).diagonal()
    return -(i.mean() + j.mean())


def egonce(sim: torch.Tensor, mask_v: torch.Tensor, mask_n: torch.Tensor,
           temperature: float = 0.05, noun: bool = True,
           verb: bool = True) -> torch.Tensor:
    """EgoNCE: action-aware positives.

    Positives for row i are the samples that share a verb and a noun class
    (``mask_v * mask_n``) plus the diagonal, binarised with ``> 0`` (:53).
    The per-row loss is the log of the positive softmax mass,
    ``logsumexp(positives) - logsumexp(all)`` in log space (:59-64), in
    both directions.  ``mask_v``, ``mask_n``: ``[N, N]`` similarity or 0/1
    matrices."""
    n = sim.shape[0]
    eye = torch.eye(n, dtype=torch.float32, device=sim.device)
    if noun and verb:
        mask = mask_v.float() * mask_n.float() + eye
    elif noun:
        mask = mask_n.float() + eye
    else:
        mask = mask_v.float() + eye
    pos = mask > 0

    s = sim.float() / temperature

    def direction(logits, m):
        log_pos = torch.logsumexp(logits.masked_fill(~m, -torch.inf), dim=1)
        return (log_pos - torch.logsumexp(logits, dim=1)).mean()

    return -(direction(s, pos) + direction(s.T, pos.T))
