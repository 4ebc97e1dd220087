"""Gathering per-process evaluation results.

Counterpart of ``egovlp_tpu/core/dist_eval.py`` (:98-136).  Each process
evaluates its shard of the eval loader; ``gather_eval`` joins every
process's rows, drops the pad duplicates that ``shard_indices`` adds when
the dataset does not divide evenly, and restores dataset order, by the
dataset index the Loader attaches to every batch (``_index``).

In one process (``torch.distributed`` not initialized, or a world of 1)
the gather is the identity and the dedupe is a no-op.  A larger world
raises: multi-process training and evaluation come with DDP (``ROADMAP.md``,
Queue A, A9, the DDP item).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed``; (0, 1) without it."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def dedupe_order(index: np.ndarray) -> np.ndarray:
    """Row selection that (a) drops pad duplicates and (b) restores
    dataset order: positions into the gathered rows."""
    # np.unique returns values ascending with the FIRST occurrence of each:
    # dataset order with the pads dropped
    _, first = np.unique(np.asarray(index), return_index=True)
    return first


def gather_eval(arrays: Dict[str, np.ndarray],
                index: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """The full dataset's rows of ``arrays`` (this process's ``{name:
    [n_local, ...]}``), in dataset order when ``index`` (this process's
    ``[n_local]`` dataset indices, the Loader's ``_index``) is given."""
    if process_shard()[1] > 1:
        raise NotImplementedError(
            "gather_eval across processes comes with DDP (ROADMAP.md, Queue "
            "A, A9, the DDP item)")
    if index is None:
        return dict(arrays)
    sel = dedupe_order(index)
    return {k: np.asarray(v)[sel] for k, v in arrays.items()}
