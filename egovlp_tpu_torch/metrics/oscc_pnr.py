"""Ego4D OSCC accuracy and PNR keyframe distance, numpy on the host.

The port's own copy of ``egovlp_tpu/metrics/oscc_pnr.py`` (:11-49).
"""

from __future__ import annotations

import numpy as np


def oscc_metrics(preds: np.ndarray, labels: np.ndarray) -> dict:
    """preds: ``[N, 2]`` logits; labels: ``[N]`` state-change flags."""
    preds = np.asarray(preds)
    labels = np.asarray(labels).reshape(-1)
    acc = float(np.mean(np.argmax(preds, axis=1) == labels))
    return {"accuracy": acc * 100.0}


def pnr_metrics(preds: np.ndarray, labels: np.ndarray,
                sc_labels: np.ndarray, fps: np.ndarray,
                parent_start_frames: np.ndarray,
                parent_end_frames: np.ndarray,
                parent_pnr_frames: np.ndarray) -> dict:
    """The keyframe error in seconds over the state-change clips.

    preds: ``[N, 16]`` frame logits.  The argmax frame index maps back to
    a parent-clip frame as ``(end - start) / 16 * idx`` and is compared,
    in float64, with the annotated keyframe, scaled to seconds by the
    clip's fps.  ``labels`` is unused, as in the reference."""
    preds = np.asarray(preds)
    sc = np.asarray(sc_labels).reshape(-1)
    fps = np.asarray(fps, np.float64).reshape(-1)
    start = np.asarray(parent_start_frames, np.float64).reshape(-1)
    end = np.asarray(parent_end_frames, np.float64).reshape(-1)
    pnr = np.asarray(parent_pnr_frames, np.float64).reshape(-1)

    keep = sc == 1
    if not keep.any():
        return {"keyframe_distance": 0.0}
    idx = np.argmax(preds[keep], axis=1)
    mapped = (end[keep] - start[keep]) / 16.0 * idx
    gt = pnr[keep] - start[keep]
    err_sec = np.abs(mapped - gt) / fps[keep]
    return {"keyframe_distance": float(np.mean(err_sec))}
