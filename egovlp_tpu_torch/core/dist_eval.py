"""Gathering per-process evaluation results.

Counterpart of ``egovlp_tpu/core/dist_eval.py`` (:45-136).  Each process
evaluates its shard of the eval loader; ``gather_eval`` joins every
process's rows, drops the pad duplicates that ``shard_indices`` adds when
the dataset does not divide evenly, and restores dataset order, by the
dataset index the Loader attaches to every batch (``_index``).  The
result is the same on every rank, so metrics (and the monitored metric
that decides early stop) are too.

Across processes the arrays travel as tensors: one exchange of the local
lengths for all columns, then each column padded to the longest shard,
all-gathered (``dist.all_gather``) and trimmed.  Python objects travel
pickled, as bytes, the same way.  NCCL moves CUDA tensors only, so under
NCCL the columns pass through the current GPU; under gloo they stay on
the CPU.  In one process (``torch.distributed`` not initialized, or a
world of 1) the gather is the identity and the dedupe a no-op.  Under a
mesh the gather runs over the data group: the model ranks of a data
replica evaluated the same rows.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.mesh import data_group, data_shard


def process_shard():
    """(rank, size) of the ranks the gather runs over: the data group's
    (the world's without a mesh)."""
    return data_shard()


def _comm_device() -> torch.device:
    if dist.get_backend(data_group()) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(x: np.ndarray) -> List[np.ndarray]:
    """Every data rank's ``x`` (the same shape on every rank), in rank
    order."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(process_shard()[1])]
    dist.all_gather(parts, t, group=data_group())
    return [p.cpu().numpy() for p in parts]


def _gather_counts(n_local: int) -> np.ndarray:
    """Every rank's leading length, in one exchange."""
    return np.concatenate(_all_gather(np.asarray([n_local], np.int64)))


def _allgather_padded(x: np.ndarray, counts: Optional[np.ndarray] = None
                      ) -> List[np.ndarray]:
    """Every rank's ``x`` of a rank-dependent leading length, in rank
    order: padded to the longest, gathered, trimmed.  ``counts`` (from
    ``_gather_counts``) may be shared by many columns of one length."""
    if counts is None:
        counts = _gather_counts(x.shape[0])
    n_max = int(counts.max())
    if x.shape[0] < n_max:
        pad = np.zeros((n_max - x.shape[0],) + x.shape[1:], x.dtype)
        x = np.concatenate([x, pad])
    return [p[:c] for p, c in zip(_all_gather(x), counts)]


def gather_arrays(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Every process's ``{name: [n_local, ...]}`` arrays concatenated along
    axis 0 in rank order.  The columns share one local length, which may
    differ between processes.  The identity in one process."""
    if process_shard()[1] == 1:
        return dict(arrays)
    counts, out = None, {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if counts is None:
            counts = _gather_counts(v.shape[0])
        out[k] = np.concatenate(_allgather_padded(v, counts))
    return out


def gather_objects(objs: Sequence) -> List:
    """Every process's list of Python objects (paths, captions) joined in
    the row order of ``gather_arrays`` (rank-major)."""
    if process_shard()[1] == 1:
        return list(objs)
    raw = np.frombuffer(pickle.dumps(list(objs)), np.uint8)
    out: List = []
    for part in _allgather_padded(raw):
        # bytes this program's ranks pickled
        out.extend(pickle.loads(part.tobytes()))
    return out


def dedupe_order(index: np.ndarray) -> np.ndarray:
    """Row selection that (a) drops pad duplicates and (b) restores
    dataset order: positions into the gathered rows."""
    # np.unique returns values ascending with the FIRST occurrence of each:
    # dataset order with the pads dropped
    _, first = np.unique(np.asarray(index), return_index=True)
    return first


def gather_eval(arrays: Dict[str, np.ndarray],
                index: Optional[np.ndarray] = None,
                objects: Optional[Dict[str, Sequence]] = None):
    """``(arrays, objects)`` of the full dataset on every process.

    ``arrays``: this process's ``{name: [n_local, ...]}``; ``index``: its
    ``[n_local]`` dataset indices (the Loader's ``_index``), which turn on
    the pad dedupe and dataset order; ``objects``: ``{name: list}`` Python
    columns gathered alongside and reordered the same way (None when not
    given)."""
    if index is not None:
        arrays = dict(arrays)
        arrays["__idx"] = np.asarray(index)
    g = gather_arrays(arrays)
    gobj = ({k: gather_objects(v) for k, v in objects.items()}
            if objects is not None else None)
    if index is not None:
        sel = dedupe_order(g.pop("__idx"))
        g = {k: v[sel] for k, v in g.items()}
        if gobj is not None:
            gobj = {k: [v[i] for i in sel] for k, v in gobj.items()}
    return g, gobj
