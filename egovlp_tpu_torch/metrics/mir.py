"""EPIC-Kitchens-100 multi-instance retrieval (MIR) metrics: nDCG and mAP,
numpy on the host.

Counterpart of ``egovlp_tpu/metrics/mir.py``:

* ``mir_metrics_from_matrices``: similarities rescaled to [0, 1], rows
  put in dataset order by the gathered sample indices, the columns of
  each sentence's video selected, then nDCG and mAP in both directions
  against the relevancy matrix;
* ``load_epic_annotations``: the test csvs' first columns, as pandas'
  ``read_csv(...).values[:, 0]`` gives them, read with the standard
  library (``data/datasets/table.py``), and the relevancy pickle.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

from egovlp_tpu_torch.data.datasets.table import read_table
from egovlp_tpu_torch.metrics.map import calculate_mAP
from egovlp_tpu_torch.metrics.ndcg import (
    calculate_IDCG,
    calculate_k_counts,
    calculate_nDCG,
)


def retrieval_metrics(sim: np.ndarray, relevancy: np.ndarray) -> dict:
    """nDCG and mAP (in %) of a ``[video, sentence]`` score matrix against
    the ``[video, sentence]`` graded relevancy, video-to-text (rows) and
    text-to-video (columns)."""
    vis_k = calculate_k_counts(relevancy)
    txt_k = calculate_k_counts(relevancy.T)
    vis_nDCG = calculate_nDCG(sim, relevancy, vis_k,
                              IDCG=calculate_IDCG(relevancy, vis_k))
    txt_nDCG = calculate_nDCG(sim.T, relevancy.T, txt_k,
                              IDCG=calculate_IDCG(relevancy.T, txt_k))
    vis_mAP = calculate_mAP(sim, relevancy)
    txt_mAP = calculate_mAP(sim.T, relevancy.T)
    return {
        "nDCG_V2T": vis_nDCG * 100, "nDCG_T2V": txt_nDCG * 100,
        "nDCG_AVG": 50 * (vis_nDCG + txt_nDCG),
        "mAP_V2T": vis_mAP * 100, "mAP_T2V": txt_mAP * 100,
        "mAP_AVG": 50 * (vis_mAP + txt_mAP),
    }


def mir_metrics_from_matrices(
    similarity_matrix: np.ndarray,
    idx_arr: np.ndarray,
    video_ids: Sequence,
    text_ids: Sequence,
    relevancy: np.ndarray,
) -> dict:
    """``similarity_matrix``: ``[N_text, N_video]`` cosine similarities in
    model order; ``idx_arr``: the gathered dataset indices of the eval
    samples; ``video_ids`` / ``text_ids``: the first columns of the test
    csv and of its sentence csv; ``relevancy``: ``[N_video,
    N_sentence]``."""
    sim = (np.asarray(similarity_matrix) + 1) / 2
    video_list = list(video_ids)
    indexes = [video_list.index(t) for t in text_ids if t in video_list]
    idx_list = np.asarray(idx_arr).reshape(-1).tolist()
    order = [idx_list.index(i) for i in range(len(video_list))]
    sim = sim[order, :][:, order]
    return retrieval_metrics(sim.T[:, indexes], relevancy)


def _first_column(path: str) -> np.ndarray:
    """``pandas.read_csv(path).values[:, 0]``: the column in the frame's
    common numeric dtype when every column is numeric, else an object
    array of Python values."""
    cols = list(read_table(path).values())
    if all(isinstance(c, np.ndarray) for c in cols):
        return cols[0].astype(np.result_type(*cols))
    first = cols[0].tolist() if isinstance(cols[0], np.ndarray) else cols[0]
    out = np.empty(len(first), object)
    out[:] = first
    return out


def load_epic_annotations(annotation_dir: str):
    """``(video_ids, text_ids, relevancy)`` of the EPIC test split:
    ``EPIC_100_retrieval_test.csv``, ``..._test_sentence.csv`` and
    ``relevancy/caption_relevancy_EPIC_100_retrieval_test.pkl``."""
    video_ids = _first_column(
        os.path.join(annotation_dir, "EPIC_100_retrieval_test.csv"))
    text_ids = _first_column(
        os.path.join(annotation_dir, "EPIC_100_retrieval_test_sentence.csv"))
    with open(os.path.join(
            annotation_dir, "relevancy",
            "caption_relevancy_EPIC_100_retrieval_test.pkl"), "rb") as f:
        # the annotation release's own file
        relevancy = pickle.load(f)
    return video_ids, text_ids, relevancy


def mir_metrics(similarity_matrix: np.ndarray, idx_arr: np.ndarray,
                annotation_dir: str) -> dict:
    """``mir_metrics_from_matrices`` on the annotations of
    ``annotation_dir`` (``load_epic_annotations``)."""
    return mir_metrics_from_matrices(similarity_matrix, idx_arr,
                                     *load_epic_annotations(annotation_dir))
