"""EPIC-Kitchens retrieval mAP, numpy on the host.

The port's own copy of ``egovlp_tpu/metrics/map.py``: average precision
with the graded relevancy binarized at == 1 for the indicator, and
precision over the running sum of the ranked relevancies.
"""

from __future__ import annotations

import numpy as np


def calculate_mAP(sim_mat: np.ndarray, relevancy_matrix: np.ndarray) -> float:
    ranked_order = (-sim_mat).argsort()
    rows = np.arange(sim_mat.shape[0])[:, None]
    ranked_rel = relevancy_matrix[rows, ranked_order]

    hits = ranked_rel == 1
    cum = np.cumsum(ranked_rel, axis=1)
    cum = np.where(hits, cum, 0.0)
    divisor = np.arange(ranked_rel.shape[1]) + 1
    n_rel = hits.sum(axis=1)
    avg_precision = np.sum(cum / divisor, axis=1) / n_rel
    return float(np.mean(avg_precision))
