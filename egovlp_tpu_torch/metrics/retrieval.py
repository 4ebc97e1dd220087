"""Text <-> video retrieval metrics (R@k, MedR, MeanR), numpy on the host.

The port's own copy of ``egovlp_tpu/metrics/retrieval.py`` (:22-99), the
reference's ``t2v_metrics`` / ``v2t_metrics`` protocol: ranks by distance
subtraction against the sorted row, t2v breaking ties optimistically
(the first match), v2t averaging the ranks of ties and taking the
closest relevant caption of a video with several; the summary is
R@1/5/10/50 in percent, MedR and MeanR (1-based) and the geometric mean
of R@1, R@5 and R@10.  ``query_masks`` leave out masked queries (t2v) or
masked captions (v2t).  v2t compares in row blocks of at most
``_V2T_BLOCK_BUDGET`` elements.
"""

from __future__ import annotations

import numpy as np

# Comparison-tensor element budget for the blockwise v2t rank computation
# (bounds peak memory to ~2x this many bytes of bools per pass).
_V2T_BLOCK_BUDGET = 1 << 24


def _summarize(ranks: np.ndarray, num_queries: int) -> dict:
    ranks = np.asarray(ranks, np.float64)
    out = {
        "R1": 100 * float(np.mean(ranks == 0)),
        "R5": 100 * float(np.mean(ranks < 5)),
        "R10": 100 * float(np.mean(ranks < 10)),
        "R50": 100 * float(np.mean(ranks < 50)),
        "MedR": float(np.median(ranks)) + 1.0,
        "MeanR": float(np.mean(ranks)) + 1.0,
    }
    out["geometric_mean_R1-R5-R10"] = float(
        np.exp(np.mean(np.log([max(out["R1"], 1e-12),
                               max(out["R5"], 1e-12),
                               max(out["R10"], 1e-12)])))
    )
    return out


def t2v_metrics(sims: np.ndarray, query_masks: np.ndarray | None = None) -> dict:
    """sims: [num_texts, num_videos]; texts are grouped per video
    (queries_per_video = num_texts // num_videos)."""
    sims = np.asarray(sims)
    if sims.ndim != 2:
        raise ValueError(f"sims must be 2-D, got {sims.shape}")
    num_queries, num_vids = sims.shape
    dists = -sims
    sorted_dists = np.sort(dists, axis=1)

    queries_per_video = num_queries // num_vids
    # ground-truth distance of query i is dists[i, i // qpv]
    gt_cols = np.repeat(np.arange(num_vids), queries_per_video)
    gt_dists = dists[np.arange(num_queries), gt_cols][:, None]

    rows, cols = np.where(sorted_dists - gt_dists == 0)
    if rows.size > num_queries:  # ties: break optimistically (first match)
        _, first = np.unique(rows, return_index=True)
        cols = cols[first]
    if cols.size != num_queries:
        raise ValueError(f"{cols.size} ranks for {num_queries} queries")

    if query_masks is not None:
        keep = query_masks.reshape(-1).astype(bool)
        cols = cols[keep]
        num_queries = int(keep.sum())
    return _summarize(cols, num_queries)


def v2t_metrics(sims: np.ndarray, query_masks: np.ndarray | None = None) -> dict:
    """sims: [num_texts, num_videos]; transposed internally.  For each video
    the rank of its *closest* ground-truth caption counts; ties are
    rank-averaged (metric.py:157-190)."""
    sims = np.asarray(sims).T
    num_queries, num_caps = sims.shape
    dists = -sims
    caps_per_video = num_caps // num_queries
    MISSING = 1e8

    if query_masks is not None:
        keep = query_masks.reshape(-1).astype(bool)
        dists = np.where(keep[None, :], dists, MISSING)

    # The rank-averaged tie rank of value v within a row equals
    # count(row < v) + (count(row == v) - 1) / 2 — computed for the gt
    # captions only, in row blocks to bound the [block, cpv, caps]
    # comparison tensor (one vectorized pass instead of a per-video sort).
    gt_cols = (np.arange(num_queries)[:, None] * caps_per_video
               + np.arange(caps_per_video)[None, :])
    ranks = np.empty(num_queries, np.float64)
    block = max(1, _V2T_BLOCK_BUDGET // max(1, caps_per_video * num_caps))
    for s in range(0, num_queries, block):
        e = min(num_queries, s + block)
        d = dists[s:e]  # [b, caps]
        g = d[np.arange(e - s)[:, None], gt_cols[s:e]]  # [b, cpv]
        less = (d[:, None, :] < g[:, :, None]).sum(-1)
        eq = (d[:, None, :] == g[:, :, None]).sum(-1)
        avg = less + (eq - 1) / 2.0
        # masked-out gt captions never count (reference skips row[j]==MISSING)
        avg = np.where(g == MISSING, np.inf, avg)
        ranks[s:e] = avg.min(axis=1)
    return _summarize(ranks, num_queries)
