"""CharadesEgo 157-class video-level mAP, numpy on the host.

The port's own copy of ``egovlp_tpu/metrics/charades.py`` (an
approximation of the official Charades evaluation): per-class AP over
videos ranked by score, classes with no positives skipped (NaN, left out
of the mean), and videos with an empty ground-truth row forced to -inf
scores.
"""

from __future__ import annotations

import numpy as np


def charades_map(submission_array: np.ndarray, gt_array: np.ndarray):
    """Returns (mAP, weighted mAP, per-class AP array)."""
    sub = np.asarray(submission_array, np.float64)
    gt = np.asarray(gt_array)
    n_items, n_classes = sub.shape
    aps = np.full(n_classes, np.nan)
    for c in range(n_classes):
        order = np.argsort(-sub[:, c])
        tp = gt[order, c] == 1
        n_pos = tp.sum()
        if n_pos < 0.1:
            continue
        cum_tp = np.cumsum(tp)
        prec = cum_tp / (np.arange(n_items) + 1.0)
        aps[c] = prec[tp].sum() / float(n_pos)
    m_ap = float(np.nanmean(aps)) if np.isfinite(aps).any() else float("nan")
    with np.errstate(invalid="ignore"):
        w_ap = aps * gt.sum(axis=0) / float(gt.sum())
    return m_ap, w_ap, aps


def charades_metrics(submission_array: np.ndarray, gt_array: np.ndarray) -> dict:
    fix = np.array(submission_array, np.float64, copy=True)
    empty = np.sum(gt_array, axis=1) == 0
    fix[empty, :] = -np.inf
    m_ap, _, _ = charades_map(fix, gt_array)
    return {"mAP": m_ap}
