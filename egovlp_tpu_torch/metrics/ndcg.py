"""EPIC-Kitchens nDCG (JPoSE protocol), numpy on the host.

The port's own copy of ``egovlp_tpu/metrics/ndcg.py`` (the EPIC retrieval
benchmark's ``nDCG.py``, vectorized).
"""

from __future__ import annotations

import numpy as np


def calculate_k_counts(relevancy_matrix: np.ndarray) -> np.ndarray:
    """Mask of the first k_i ranked slots per row, where k_i = number of
    non-zero relevancies for query i."""
    return (np.sort(relevancy_matrix)[:, ::-1] > 0).astype(int)


def calculate_DCG(similarity_matrix: np.ndarray, relevancy_matrix: np.ndarray,
                  k_counts: np.ndarray) -> np.ndarray:
    """sum over the first k retrieved items of rel / log2(rank + 2)."""
    x_sz, y_sz = similarity_matrix.shape
    ranks = np.argsort(similarity_matrix)[:, ::-1]
    divisors = np.log2(np.arange(y_sz) + 2)[None, :]
    gains = np.take_along_axis(relevancy_matrix, ranks, axis=1) * k_counts
    return np.sum(gains / divisors, axis=1)


def calculate_IDCG(relevancy_matrix: np.ndarray, k_counts: np.ndarray) -> np.ndarray:
    return calculate_DCG(relevancy_matrix, relevancy_matrix, k_counts)


def calculate_nDCG(similarity_matrix: np.ndarray, relevancy_matrix: np.ndarray,
                   k_counts: np.ndarray | None = None,
                   IDCG: np.ndarray | None = None,
                   reduction: str | None = "mean"):
    if k_counts is None:
        k_counts = calculate_k_counts(relevancy_matrix)
    DCG = calculate_DCG(similarity_matrix, relevancy_matrix, k_counts)
    if IDCG is None:
        IDCG = calculate_IDCG(relevancy_matrix, k_counts)
    if reduction == "mean":
        return np.mean(DCG / IDCG)
    return DCG / IDCG
