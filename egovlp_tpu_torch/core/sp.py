"""Sequence (context) parallelism of divided space-time attention over the
mesh's model group.

Counterpart of ``egovlp_tpu/core/sp.py``: Ulysses-style context
parallelism that shards the ``[B, f, n, D]`` patch grid over the axis the
coming attention does not attend along.  JAX places sharding constraints
and lets GSPMD insert the all-to-alls; here they are explicit:

* **time** attention groups by patch column (attends across frames), so
  its grid is sharded over the patch columns, ``[B, f, n / m, D]``;
  **space** attention groups by frame, so its grid is sharded over the
  frames, ``[B, f / m, n, D]``;
* each phase change is one ``all_to_all`` (``time_to_space`` /
  ``space_to_time``), an autograd Function whose backward is the inverse
  ``all_to_all``.  A block changes phase twice: its time residual goes to
  the space layout for ``norm1`` and the space attention, and the space
  attention's output comes back to the time layout, where the residual
  from the block's input, ``norm2`` and the MLP run;
* the tower slices its patch embedding to this rank's columns before the
  first block (the model size must divide both f and n; anything else
  raises, naming them) and returns the CLS row, which every rank holds
  whole.

**The CLS row** attends over every token (``_cls_row_parts``).  Here it
is a split softmax at the JAX op's rounding points: the row max
all-reduced (max), then the float32 exp-sum and the float32 value sum of
this rank's patches all-reduced (sum, ``all_reduce_sum``, whose backward
is the same all-reduce), the CLS key's term added once after it.

**Gradients.**  The CLS stream (the CLS token, the norms, qkv, proj and
MLP applied to it, ``vid_proj``) is computed the same way on every model
rank; the patch stream is split.  Each rank carries the CLS stream's
gradient as a partial sum: the loss's gradient into the video embedding
is scaled by ``1 / m`` (``scale_grad``), the combine's backward all-reduce
turns the partials into the full gradient that the local patches need,
and the CLS gradients of K1 / K2 (reduced over this rank's frames or
columns) are this rank's part.  Every video parameter's gradient is then
the sum over the model group of the ranks' gradients
(``ParamShard.sum_over_model``), before the data mean.

**Storage.**  As JAX stores the whole train state with tensor-parallel
shardings under sequence parallelism too (``recipes.py:231-236``), the
video tower's leaves that tensor parallelism's rules split (``qkv`` and
``fc1`` weights and biases by their rows, ``proj`` and ``fc2`` weights by
their columns; ``core/tp.py``'s ``split_dim``) and their AdamW moments
are held as this rank's contiguous slice between steps
(``ParamShard.whole_at_use``).  ``core/zero.MeshUpdate`` gathers them
whole in a forward pre-hook on the tower, before its first use in a step,
and keeps them whole through the backward (recompute and GradCache's
second pass included); their summed gradient is reduce-scattered to the
slice, the update touches the slice, and the leaves go back to it.  Only
the storage is split: the tower computes with the whole weights, so the
activations and collectives above do not change.  The other video leaves
(the norms, ``cls_token``, the embeddings, the row biases) and
``vid_proj`` stay whole, their gradients all-reduced over the model group;
the text tower is tensor-parallel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.collectives import all_reduce, all_to_all
from egovlp_tpu_torch.core.mesh import Mesh, set_param_shard
from egovlp_tpu_torch.core.tp import _slice_, split_dim


class SPGroup:
    """The model group a sequence-parallel tower runs over."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def check(self, frames: int, patches: int) -> None:
        if frames % self.size or patches % self.size:
            raise ValueError(
                f"sequence parallelism over {self.size} model ranks needs "
                f"frames ({frames}) and patches ({patches}) divisible by "
                f"{self.size}")

    def columns(self, xp: torch.Tensor) -> torch.Tensor:
        """This rank's patch columns of a whole ``[B, f, n, D]`` grid."""
        n = xp.shape[2] // self.size
        return xp[:, :, self.rank * n:(self.rank + 1) * n]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        # an output that reaches no loss (the last block's patch part)
        # passes None back, on every rank alike: no exchange, and the
        # attention backward before it is skipped, as in one process
        ctx.set_materialize_grads(False)
        return _all_to_all(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        if grad is None:
            return None, None, None, None
        split_dim, cat_dim = ctx.dims
        return _all_to_all(grad, cat_dim, split_dim, ctx.group), None, None, \
            None


def _all_to_all(x, split_dim, cat_dim, group):
    size = dist.get_world_size(group)
    return torch.cat(all_to_all(list(x.chunk(size, split_dim)), group),
                     dim=cat_dim)


def time_to_space(xp: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """``[B, f, n / m, D]`` (patch columns) -> ``[B, f / m, n, D]``
    (frames)."""
    return _AllToAll.apply(xp, 1, 2, sp.group)


def space_to_time(xp: torch.Tensor, sp: SPGroup) -> torch.Tensor:
    """``[B, f / m, n, D]`` -> ``[B, f, n / m, D]``."""
    return _AllToAll.apply(xp, 2, 1, sp.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; its backward sums the ranks' partial
    gradients the same way."""
    return _AllReduceSum.apply(x, group)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x``, with its gradient scaled by ``scale`` on the way back."""
    return _ScaleGrad.apply(x, scale)


def cls_row_parts(qc, kc, vc, kp, vp, heads: int, scale: float,
                  sp: SPGroup) -> torch.Tensor:
    """``divided_attention._cls_row_parts`` over the patches of every rank
    of ``sp`` (``kp``, ``vp``: this rank's ``[B, ..., D]`` patches): the
    same rounding points, float32 sums in another order."""
    B, D = kp.shape[0], kp.shape[-1]
    hd = D // heads
    dt = kp.dtype
    q3c = (qc.reshape(B, heads, hd) * scale).float()
    k4 = kp.reshape(B, -1, heads, hd).float()
    v4 = vp.reshape(B, -1, heads, hd).float()
    lg_c = (q3c * kc.reshape(B, heads, hd).float()).sum(-1, keepdim=True)
    lg_p = torch.einsum("bhd,bshd->bhs", q3c, k4)
    with torch.no_grad():  # a shift the softmax does not see
        top = torch.maximum(lg_c, lg_p.amax(-1, keepdim=True))
        top = all_reduce(top, sp.group, dist.ReduceOp.MAX)
    e_c, e_p = torch.exp(lg_c - top), torch.exp(lg_p - top)
    total = all_reduce_sum(e_p.sum(-1, keepdim=True), sp.group) + e_c
    pr_p, pr_c = (e_p / total).to(dt), (e_c / total).to(dt)
    oc = all_reduce_sum(torch.einsum("bhs,bshd->bhd", pr_p.float(), v4),
                        sp.group).to(dt)
    oc = oc + pr_c * vc.reshape(B, heads, hd)
    return oc.reshape(B, 1, D)


def enable_sequence_parallel(model: torch.nn.Module, mesh: Mesh,
                             optimizer=None) -> int:
    """Run ``model``'s video tower (a ``DualEncoder``) sequence-parallel
    over ``mesh``'s model group, mark its and ``vid_proj``'s parameters to
    be summed over that group, and cut the tower's tensor-parallel leaves
    and ``optimizer``'s moments of them to this rank's slices (see the
    module notes); returns the number of leaves cut."""
    sp = SPGroup(mesh.model.group, mesh.model.rank, mesh.model.size)
    tower = model.video_model
    tower.sp = sp
    for blk in tower.blocks:
        blk.sp = sp
        blk.attn.sp = blk.timeattn.sp = sp
    for mod in (tower, model.vid_proj):
        for p in mod.parameters():
            set_param_shard(p, sum_over_model=True)
    n = 0
    for name, p in tower.named_parameters():
        d = split_dim(name, tuple(p.shape), sp.size)
        if d is not None:
            set_param_shard(p, tp_dim=d, whole_at_use=True)
            _slice_(p, optimizer, d, False, sp.rank, sp.size)
            n += 1
    return n
