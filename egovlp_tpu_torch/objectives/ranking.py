"""Max-margin ranking objectives (EPIC-Kitchens MIR fine-tuning).

Counterpart of ``egovlp_tpu/objectives/ranking.py``: for every ordered
pair (i, j) both retrieval directions contribute
``relu(margin_i - (S_ii - S_ij))`` and ``relu(margin_i - (S_ii - S_ji))``,
in float32.  With ``fix_norm`` (the default) the diagonal terms, which
are the margin itself, are masked and the sum is divided by the
``2 n (n - 1)`` off-diagonal pairs; without it by ``2 n^2``.  Under DDP
``sim`` is the global batch's matrix, so the mean runs over the global n.
"""

from __future__ import annotations

from typing import Union

import torch


def _loss(sim: torch.Tensor, margins: Union[float, torch.Tensor],
          fix_norm: bool) -> torch.Tensor:
    sim = sim.float()
    n = sim.shape[0]
    d = sim.diagonal()[:, None]  # S_ii of each row
    t2v = torch.relu(margins - (d - sim))
    v2t = torch.relu(margins - (d - sim.T))
    if fix_norm:
        off = 1.0 - torch.eye(n, dtype=torch.float32, device=sim.device)
        return ((t2v * off).sum() + (v2t * off).sum()) / (2.0 * n * (n - 1))
    return (t2v.sum() + v2t.sum()) / (2.0 * n * n)


def max_margin(sim: torch.Tensor, margin: float = 0.2,
               fix_norm: bool = True) -> torch.Tensor:
    """MaxMarginRankingLoss, margin 0.2 by default."""
    return _loss(sim, float(margin), fix_norm)


def adaptive_max_margin(sim: torch.Tensor, weight: torch.Tensor,
                        margin: float = 0.4,
                        fix_norm: bool = True) -> torch.Tensor:
    """AdaptiveMaxMarginRankingLoss ("Adaptive MI-MM"): ``weight`` is the
    per-sample relevancy w_i, and every pair anchored at row i takes the
    margin ``w_i * margin``."""
    return _loss(sim, weight.float()[:, None] * margin, fix_norm)
