"""EgoMCQ multiple-choice accuracy.

The port's own copy of ``egovlp_tpu/metrics/egomcq.py`` (the reference's
``model/metric.py:218-234``).  Each item is
a 1x5 similarity row over the candidate videos; accuracy is grouped by the
item's ``type`` id: the ascending-sorted unique type ids map onto
["Intra-video", "Inter-video"] in that order — i.e. type 1 is reported as
"Intra-video" and type 2 as "Inter-video".

NOTE: the dataset source comments the opposite mapping ("1 for inter; 2 for
intra", EgoClip_EgoMCQ_dataset.py:149).  The published numbers
(Inter 90.7 / Intra 57.2, README.md:97) are produced by the *metric's*
mapping, so that is what we reproduce.
"""

from __future__ import annotations

import numpy as np

GROUPS = ("Intra-video", "Inter-video")


def egomcq_accuracy_metrics(preds: np.ndarray, labels: np.ndarray,
                            types: np.ndarray) -> dict:
    """preds: [N, 5] similarity rows; labels: [N] correct option index;
    types: [N] group ids."""
    preds = np.asarray(preds)
    labels = np.asarray(labels).reshape(-1)
    types = np.asarray(types).reshape(-1)
    metrics = {}
    for type_i, group in zip(np.unique(types), GROUPS):
        sel = types == type_i
        correct = (np.argmax(preds[sel], axis=1) == labels[sel]).sum()
        metrics[group] = 100.0 * float(correct) / float(sel.sum())
    return metrics
