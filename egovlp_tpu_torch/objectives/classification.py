"""Cross entropy of the Ego4D OSCC / PNR classification heads.

Counterpart of ``egovlp_tpu/objectives/classification.py`` (:12-20): the
mean softmax cross entropy over integer targets, in float32.  OSCC's head
has 2 logits (state change or not); PNR's 16, one a sampled frame, with
the keyframe's index as the target.
"""

from __future__ import annotations

import torch


def nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each row's ``-log softmax(logits)[target]``, float32, ``[B]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, targets.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mean softmax cross entropy; ``targets`` are class ids ``[B]``."""
    return nll(logits, targets).mean()
