"""The (data, model) process mesh.

Counterpart of ``egovlp_tpu/core/mesh.py`` (:26-146).  JAX lays its
devices out as a ``Mesh`` with a ``data`` and a ``model`` axis; here each
process drives one GPU, and the mesh is a grid of ``torch.distributed``
ranks with one process group for each row and each column:

* ``rank = (dcn * data + d) * model + m``: the model axis is consecutive
  ranks (one host; its all-to-alls and all-reduces are the latency-bound
  ones) and ``dcn_data`` folds into the data axis slice-major, as JAX's
  hybrid mesh does (:58-90);
* this rank's **model group** is its row (the ranks of one data replica:
  tensor and sequence parallelism), its **data group** its column (the
  ranks holding the same model shard: the batch, the gradient mean, the
  global similarity and ZeRO).  At ``model`` 1 the data group is the whole
  world (the default group), so data parallelism is unchanged.

``current_mesh()`` is the mesh ``run_task`` activates, as a context
manager (JAX's ``with mesh:``, :92-113), and None outside one.
``data_shard()`` / ``data_group()`` are the data axis's (rank, size) and
group, or the world's when no mesh is active: the steps, the collectives
of the global batch, the ring and the evaluation gather run over them.

Every parameter a mesh shards carries a ``ParamShard`` (``SHARD_ATTR``):
its full shape, the dim the model group splits (and whether it is the
head-aligned fused qkv), the dim ZeRO splits, whether its gradient is
summed over the model group and whether the split is storage only (both
for the sequence-parallel video tower).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.dist import in_process_group, process_shard

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the attribute a sharded parameter carries its ParamShard under
SHARD_ATTR = "mesh_shard"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh: ``data`` replicas within a slice (-1: the rest of
    the world), ``model`` ranks a replica, ``dcn_data`` slices."""

    data: int = -1
    model: int = 1
    dcn_data: int = 1

    def resolve(self, world: int) -> "MeshSpec":
        """The spec with ``data`` filled in for a world of ``world``
        ranks; raises when the product does not cover it."""
        dcn = max(1, self.dcn_data)
        data = self.data if self.data > 0 else world // (self.model * dcn)
        if data * self.model * dcn != world:
            raise ValueError(
                f"mesh {dcn}x{data}x{self.model} (dcn x data x model) "
                f"does not cover {world} devices")
        return MeshSpec(data=data, model=self.model, dcn_data=dcn)


def mesh_ranks(spec: MeshSpec) -> np.ndarray:
    """``[dcn * data, model]`` global ranks of a resolved spec: row i is
    data index i's model group, column m model index m's data group."""
    return np.arange(spec.dcn_data * spec.data * spec.model).reshape(
        spec.dcn_data * spec.data, spec.model)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its index along the axis, the
    axis size, the global ranks along it and their process group (None
    when the axis has one rank)."""

    rank: int
    size: int
    ranks: Tuple[int, ...]
    group: Optional[dist.ProcessGroup] = None


@dataclasses.dataclass(frozen=True)
class ParamShard:
    """How a mesh stores one parameter (see the module notes).
    ``tp_dim``: the dim the model group splits (None: whole); each model
    rank holds its own slice and its own slice's gradient;
    ``qkv``: the split is the head-aligned fused ``[q|k|v]`` rows;
    ``zero_dim``: the dim ZeRO splits over the data group;
    ``sum_over_model``: the gradient is summed over the model group before
    the data mean (the sequence-parallel video tower);
    ``whole_at_use``: the ``tp_dim`` split is storage only: the module
    computes with the whole tensor, gathered over the model group before
    it runs, and its summed gradient is reduce-scattered to the slice (the
    sequence-parallel video tower's tensor-parallel leaves)."""

    full_shape: Tuple[int, ...]
    tp_dim: Optional[int] = None
    qkv: bool = False
    zero_dim: Optional[int] = None
    sum_over_model: bool = False
    whole_at_use: bool = False


def param_shard(p: torch.Tensor) -> ParamShard:
    """``p``'s ParamShard (whole and unsharded when it has none)."""
    return getattr(p, SHARD_ATTR, None) or ParamShard(tuple(p.shape))


def set_param_shard(p: torch.Tensor, **changes) -> ParamShard:
    s = dataclasses.replace(param_shard(p), **changes)
    setattr(p, SHARD_ATTR, s)
    return s


_ACTIVE: List["Mesh"] = []


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A resolved ``MeshSpec`` and this rank's place on it."""

    spec: MeshSpec
    rank: int
    data: Axis
    model: Axis

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def create_mesh(spec: MeshSpec = MeshSpec()) -> Mesh:
    """This rank's place on ``spec`` over the current process group (one
    process: a 1 x 1 mesh).  Every rank makes every group, in the same
    order, as ``torch.distributed.new_group`` requires; an axis that
    spans the world is the default group."""
    rank, world = process_shard()
    spec = spec.resolve(world)
    grid = mesh_ranks(spec)
    d, m = divmod(rank, spec.model)
    groups = {}
    for name, lines in ((MODEL_AXIS, grid), (DATA_AXIS, grid.T)):
        for line in lines:
            ranks = tuple(int(r) for r in line)
            if len(ranks) == 1:
                group = None
            elif len(ranks) == world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(list(ranks))
            if rank in ranks:
                groups[name] = (ranks, group)
    return Mesh(spec=spec, rank=rank,
                data=Axis(d, grid.shape[0], *groups[DATA_AXIS]),
                model=Axis(m, spec.model, *groups[MODEL_AXIS]))


def current_mesh() -> Optional[Mesh]:
    """The innermost active mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def data_shard() -> Tuple[int, int]:
    """(rank, size) of the data axis; the world's without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return process_shard()
    return mesh.data.rank, mesh.data.size


def data_group() -> Optional[dist.ProcessGroup]:
    """The data axis's group (the default group without a mesh; None in
    one process)."""
    mesh = current_mesh()
    if mesh is None:
        return dist.group.WORLD if in_process_group() else None
    return mesh.data.group


def data_global_rank(index: int) -> int:
    """The global rank of data index ``index`` (modulo the data size) on
    this rank's model index."""
    mesh = current_mesh()
    if mesh is None:
        return index % process_shard()[1]
    return mesh.data.ranks[index % mesh.data.size]


def shard_batch(batch: dict, mesh: Optional[Mesh] = None,
                device: "torch.device | str" = "cpu") -> dict:
    """This data rank's rows of a global host batch, as tensors on
    ``device``: every model rank of a data replica gets the same rows.
    Underscore keys (the Loader's ``_index``, host metadata) stay on the
    host and are left out, as JAX leaves them (:125-143)."""
    mesh = mesh or current_mesh()
    rank, size = (mesh.data.rank, mesh.data.size) if mesh else (0, 1)
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        t = torch.as_tensor(v)
        if t.shape[0] % size:
            raise ValueError(f"{k}: {t.shape[0]} rows do not split over "
                             f"{size} data ranks")
        b = t.shape[0] // size
        out[k] = t[rank * b:(rank + 1) * b].to(device)
    return out


def local_batch_to_global(batch_per_device: int, mesh: Mesh) -> int:
    return batch_per_device * mesh.data.size
