"""ZeRO storage sharding over the data group, and the optimizer side of a
mesh run: the gradient reduction and the full state for checkpoints.

Counterpart of ``egovlp_tpu/core/zero.py``.  JAX places the AdamW moments
(stage 1), and the parameters too (stage 3), with data-axis shardings and
lets GSPMD partition the update; here the port's ``AdamW`` updates this
rank's slice itself (``MeshUpdate``):

* a leaf of at least ``min_size`` elements is split on its largest dim
  that the data size divides and tensor parallelism has not split (JAX's
  ``_with_data_axis``, :49-59; ties go to a Linear weight's input dim,
  the first dim of JAX's ``[in, out]`` kernel), its global shape deciding;
* stage 1: the moments hold this rank's slice; the gradient is averaged
  over the data group, this rank's slice updated in place, and the
  updated slices all-gathered into the parameter;
* stage 3: the parameter holds its slice between steps too.  A forward
  pre-hook on the module that owns it gathers it before its first use,
  the gradient is reduce-scattered, and after the update the parameter
  goes back to its slice;
* any other stage raises, with JAX's message (:69-70).

AdamW is elementwise, so an update of a slice is the slice of the
unsharded update.  ZeRO composes with tensor parallelism: it splits a
tensor-parallel leaf's local shard on another dim.

Without ZeRO, ``MeshUpdate`` takes the place of ``DistributedDataParallel``
whenever the mesh has a model axis: after the backward it sums the
sequence-parallel video tower's gradients over the model group
(``ParamShard.sum_over_model``) and averages every gradient over the data
group, in buckets.  The tower's leaves stored split over the model group
(``ParamShard.whole_at_use``, ``core/sp.py``) work as stage 3 does over
the data group: a forward pre-hook gathers them, their gradient is
reduce-scattered over the model group, and they go back to their slices
once the backward is over, at the start of the update; ZeRO then treats
them as tensor-parallel leaves.  ``full_state`` gathers the model's and
the optimizer's tensors whole, under the reference names, for
checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from egovlp_tpu_torch.core.collectives import (
    all_gather_dim,
    all_reduce,
    reduce_scatter_dim,
)
from egovlp_tpu_torch.core.mesh import Mesh, param_shard, set_param_shard
from egovlp_tpu_torch.core.tp import gather_tp, shard_slice

STAGES = (1, 3)
# gradients all-reduced together, in elements
BUCKET = 1 << 26


def zero_dim(full_shape, tp_dim: Optional[int], n_data: int,
             linear_weight: bool = False, min_size: int = 16384
             ) -> Optional[int]:
    """The dim ZeRO splits a leaf of ``full_shape`` on, or None."""
    if n_data <= 1 or not full_shape or int(np.prod(full_shape)) < min_size:
        return None
    free = [d for d in range(len(full_shape)) if d != tp_dim
            and full_shape[d] % n_data == 0 and full_shape[d] >= n_data]
    if not free:
        return None
    order = free[::-1] if linear_weight else free
    return max(order, key=lambda d: full_shape[d])


def _slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


class MeshUpdate:
    """What ``AdamW.step`` does under a mesh (see the module notes).
    Built by ``apply_mesh``."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, stage: int = 0,
                 min_size: int = 16384):
        if stage not in (0,) + STAGES:
            raise ValueError(f"zero stage must be 1 or 3, got {stage!r}")
        self.mesh, self.stage = mesh, stage
        self.params = list(model.parameters())
        # held as their data group slice (stage 3) / their model group
        # slice (whole_at_use; apply_mesh has cut them)
        self.released: set = set()
        self.model_split = [p for p in self.params
                            if param_shard(p).whole_at_use]
        self.model_released: set = set(self.model_split)
        if stage:
            from egovlp_tpu_torch.core.precision import Linear

            n = mesh.data.size
            for mod in model.modules():
                for p in mod.parameters(recurse=False):
                    s = param_shard(p)
                    d = zero_dim(s.full_shape, s.tp_dim, n,
                                 isinstance(mod, Linear) and p is mod.weight,
                                 min_size)
                    if d is not None:
                        set_param_shard(p, zero_dim=d)
        # each top-level part (a tower, a head) gathers the parameters it
        # stores split before it runs: a module may read a child's weights
        # without calling the child (PatchEmbed)
        for part in [model, *model.children()]:
            owned = tuple(
                p for p in (part.parameters(recurse=False)
                            if part is model else part.parameters())
                if param_shard(p).whole_at_use
                or (stage == 3 and param_shard(p).zero_dim is not None))
            if owned:
                part.register_forward_pre_hook(
                    lambda _m, _a, ps=owned: self.gather(ps))

    def sharded(self) -> List[torch.nn.Parameter]:
        return [p for p in self.params if param_shard(p).zero_dim is not None]

    # ---- storage ----------------------------------------------------------

    def shard_moments(self, optimizer) -> None:
        """Cut moments that already exist (a resume) to this rank's
        slices."""
        r, n = self.mesh.data.rank, self.mesh.data.size
        for p in self.sharded():
            state = optimizer.state.get(p, {})
            for k, v in list(state.items()):
                if torch.is_tensor(v) and v.shape == p.shape:
                    state[k] = _slice(v, param_shard(p).zero_dim, r,
                                      n).clone()

    def release(self) -> None:
        """Every parameter stored split back to its slice: the model
        group's (``whole_at_use``), then stage 3's."""
        self._release_model()
        if self.stage != 3:
            return
        r, n = self.mesh.data.rank, self.mesh.data.size
        with torch.no_grad():
            for p in self.sharded():
                if p not in self.released:
                    p.data = _slice(p.data, param_shard(p).zero_dim, r,
                                    n).clone()
                    p.grad = None
                    self.released.add(p)

    def _release_model(self) -> None:
        m = self.mesh.model
        with torch.no_grad():
            for p in self.model_split:
                if p not in self.model_released:
                    s = param_shard(p)
                    p.data = shard_slice(p.data, s.tp_dim, s.qkv, m.rank,
                                         m.size).clone()
                    p.grad = None
                    self.model_released.add(p)

    def gather(self, params) -> None:
        """``params`` whole again: stage 3's slices gathered over the
        data group, then ``whole_at_use`` slices over the model group."""
        todo = [p for p in params
                if p in self.released or p in self.model_released]
        if not todo:
            return
        # gathered weights must stay usable by autograd after an
        # inference-mode evaluation gathered them
        with torch.inference_mode(False), torch.no_grad():
            for p in todo:
                s = param_shard(p)
                if p in self.released:
                    p.data = all_gather_dim(p.data, s.zero_dim,
                                            self.mesh.data.group)
                    self.released.discard(p)
                if p in self.model_released:
                    p.data = gather_tp(p.data, s.tp_dim, s.qkv,
                                       self.mesh.model.group)
                    self.model_released.discard(p)

    # ---- the step ---------------------------------------------------------

    def gradients(self, params: List[List[torch.Tensor]]
                  ) -> Tuple[List[List[torch.Tensor]], List[List[torch.Tensor]]]:
        """``(grads, targets)``: the float32 gradients, reduced over the
        mesh and cut to this rank's ZeRO slices, and the tensors to update
        (the parameters, or views of their slices)."""
        mesh = self.mesh
        r, n = mesh.data.rank, mesh.data.size
        flat = [p for ps in params for p in ps]
        grads = {p: p.grad.float() for p in flat}
        # the backward is over: the leaves stored split over the model
        # group back to their slices, which the update then touches
        self._release_model()
        over_model = [p for p in flat if param_shard(p).sum_over_model]
        for p in over_model:  # in one order on every rank
            s = param_shard(p)
            if s.whole_at_use:
                grads[p] = reduce_scatter_dim(grads[p], s.tp_dim,
                                              mesh.model.group)
        self._bucketed([p for p in over_model
                        if not param_shard(p).whole_at_use], grads,
                       mesh.model.group)
        scatter = {p for p in flat if self.stage == 3
                   and param_shard(p).zero_dim is not None}
        for p in flat:  # in one order on every rank
            if p in scatter:
                grads[p] = reduce_scatter_dim(
                    grads[p], param_shard(p).zero_dim, mesh.data.group)
        self._bucketed([p for p in flat if p not in scatter], grads,
                       mesh.data.group)
        out_g, out_t = [], []
        for ps in params:
            gs, ts = [], []
            for p in ps:
                g, d = grads[p] / n, param_shard(p).zero_dim
                t = p
                if d is not None:
                    t = _slice(p.data, d, r, n)
                    if p not in scatter:
                        g = _slice(g, d, r, n)
                gs.append(g)
                ts.append(t)
            out_g.append(gs)
            out_t.append(ts)
        return out_g, out_t

    @staticmethod
    def _bucketed(params, grads: Dict, group) -> None:
        """``grads[p]`` summed over ``group`` in place, a few flat
        all-reduces for all of them."""
        if group is None or not params:
            return
        bucket: list = []

        def flush():
            if bucket:
                flat = all_reduce(torch.cat([grads[p].flatten()
                                             for p in bucket]), group)
                for p, part in zip(bucket, flat.split(
                        [grads[p].numel() for p in bucket])):
                    grads[p] = part.view_as(grads[p])
                bucket.clear()

        size = 0
        for p in params:
            if size + grads[p].numel() > BUCKET:
                flush()
                size = 0
            bucket.append(p)
            size += grads[p].numel()
        flush()

    def norm_sq(self, sq: torch.Tensor, params: List[torch.Tensor]
                ) -> torch.Tensor:
        """The global squared norm from each tensor's local squared norm
        ``sq`` (of the ``gradients`` output): a replicated tensor's share
        is divided by the group size, the sums all-reduced (a model-split
        leaf, ``whole_at_use`` too, is this rank's slice: counted once)."""
        mesh = self.mesh
        w = []
        for p in params:
            s = param_shard(p)
            w.append((1.0 if s.tp_dim is not None else 1.0 / mesh.model.size)
                     * (1.0 if s.zero_dim is not None
                        else 1.0 / mesh.data.size))
        total = (sq * torch.tensor(w, device=sq.device)).sum()
        total = all_reduce(total, mesh.model.group)
        return all_reduce(total, mesh.data.group)

    def finish(self) -> None:
        """After the update: stage 1 all-gathers the updated slices into
        the parameters, stage 3 releases them."""
        if self.stage == 3:
            self.release()
            return
        with torch.no_grad():
            for p in self.sharded():
                d = param_shard(p).zero_dim
                p.data = all_gather_dim(
                    _slice(p.data, d, self.mesh.data.rank,
                           self.mesh.data.size).contiguous(), d,
                    self.mesh.data.group)

    # ---- checkpoints ------------------------------------------------------

    def full(self, t: torch.Tensor, p: torch.Tensor, sliced: bool
             ) -> torch.Tensor:
        """``t`` (``p``'s value or a moment of it; ``sliced``: cut to the
        ZeRO slice) whole: ZeRO's split gathered over the data group,
        then tensor parallelism's over the model group."""
        s = param_shard(p)
        if sliced and s.zero_dim is not None:
            t = all_gather_dim(t.contiguous(), s.zero_dim,
                               self.mesh.data.group)
        if s.tp_dim is not None:
            t = gather_tp(t.contiguous(), s.tp_dim, s.qkv,
                          self.mesh.model.group)
        return t


def zero_bytes(update: MeshUpdate, mu_dtype: Optional[str]) -> int:
    """Bytes of the state ZeRO splits (global shapes, as JAX counts)."""
    mu = torch.finfo(getattr(torch, mu_dtype or "float32")).bits // 8
    per = mu + 4 + (4 if update.stage == 3 else 0)
    return sum(int(np.prod(param_shard(p).full_shape)) * per
               for p in update.sharded())


def apply_mesh(model: torch.nn.Module, optimizer, mesh: Mesh,
               sequence_parallel: bool = False, zero: int = 0,
               logger: Optional[Any] = None, min_size: int = 16384
               ) -> Optional[MeshUpdate]:
    """Spread ``model`` and ``optimizer`` (full, after any resume) over
    ``mesh``: sequence parallelism of the video tower, tensor parallelism
    of the rest (of everything without ``sequence_parallel``), ZeRO
    ``zero`` (leaves of at least ``min_size`` elements), and the
    optimizer's ``MeshUpdate``.  Returns it, or None
    when the mesh needs none (no model axis, no ZeRO:
    ``DistributedDataParallel`` reduces the gradients)."""
    from egovlp_tpu_torch.core.sp import enable_sequence_parallel
    from egovlp_tpu_torch.core.tp import shard_state_tp

    if zero and zero not in STAGES:
        raise ValueError(f"zero stage must be 1 or 3, got {zero!r}")
    if mesh.model.size == 1 and not zero:
        return None
    if mesh.model.size > 1:
        skip, n = (), 0
        if sequence_parallel:
            n = enable_sequence_parallel(model, mesh, optimizer)
            skip = ("video_model", "vid_proj")
        n += shard_state_tp(model, optimizer, mesh, skip=skip)
        if logger is not None:
            logger.info("tensor parallelism: model axis %d, %d parameters "
                        "split%s", mesh.model.size, n,
                        " (the video tower sequence-parallel)"
                        if sequence_parallel else "")
    update = MeshUpdate(model, mesh, zero, min_size)
    update.shard_moments(optimizer)
    update.release()
    optimizer.mesh_update = update
    if zero and logger is not None:
        moved = zero_bytes(update, optimizer.param_groups[0].get("mu_dtype"))
        n_data = mesh.data.size
        logger.info(
            "ZeRO stage %d over data axis %d: %.2f GB of state sharded "
            "(%.2f GB saved per chip)", zero, n_data, moved / 1e9,
            moved * (1 - 1 / n_data) / 1e9)
    return update


def full_state(model: torch.nn.Module, optimizer
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(model.state_dict(), optimizer.state_dict())`` with every sharded
    tensor whole, on every rank (a collective: every rank calls it)."""
    update = getattr(optimizer, "mesh_update", None)
    if update is None:
        return model.state_dict(), optimizer.state_dict()
    # every parameter at its stored slice (an evaluation may have gathered)
    update.release()
    sd, osd = model.state_dict(), optimizer.state_dict()
    names = {id(p): k for k, p in model.named_parameters()}
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    for p in update.params:
        released = p in update.released
        sd[names[id(p)]] = update.full(p.data, p, released)
        state = osd["state"].get(index[id(p)])
        if state:
            osd["state"][index[id(p)]] = {
                k: update.full(v, p, True) if torch.is_tensor(v) else v
                for k, v in state.items()}
    return sd, osd
