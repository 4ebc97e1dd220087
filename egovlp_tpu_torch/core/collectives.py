"""The differentiable all-gather of global-batch contrastive training.

Counterpart of ``all_gather_from_data_axis`` and ``psum_scalar`` /
``pmean_scalar`` of ``egovlp_tpu/core/collectives.py`` (:33-50).  The JAX
step runs on global arrays sharded over the ``data`` axis, so its
gradient is exactly d L_global / d theta.  Here each rank computes the
same L_global from the gathered embeddings, and the gradient of the
global loss comes from two pieces (design (a)):

* ``all_gather_rows``' backward sums the incoming gradient over the ranks
  and keeps this rank's rows (a reduce-scatter, as an all-reduce and a
  slice): rank r gets sum_s dL_s / dx_r = N * dL / dx_r, as every rank's
  L_s is the same L;
* ``DistributedDataParallel`` averages the parameter gradients over the N
  ranks, so the N cancels: the result is d L_global / d theta, not 1/N of
  it (the reference's ``AllGather_multi`` keeps the slice alone and gets
  1/N after DDP's mean, a different AdamW update through eps).

One code path serves NCCL and gloo, on CPU and CUDA tensors:
``dist.all_gather`` into a list and ``dist.all_reduce`` (no warning in
either torch the port runs on; ``all_gather_into_tensor`` warns in newer
ones).  Without a process group, or at world 1, the gather is the
identity.  The ring similarity (``chunked_global_similarity``) is
``objectives/ring.py``.

Under a mesh (``core/mesh.py``) the ranks of the global batch are the
data group's: the gather, ``psum_scalar`` and ``pmean_scalar`` run over
it (the world without a mesh).  The group collectives below
(``all_reduce``, ``all_gather_dim``, ``reduce_scatter_dim``,
``all_to_all``) serve the mesh's tensor, sequence and ZeRO parallelism;
gloo's all-to-all moves host memory only, so on a gloo group it moves a
CUDA tensor through the host (the caller chose gloo for CUDA tensors: two
ranks on one GPU).  ``traffic`` counts the
calls and bytes of each.
"""

from __future__ import annotations

from collections import Counter
from typing import List

import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.mesh import data_group, data_shard

# calls and bytes sent of the group collectives, by name (``{name}`` and
# ``{name}_bytes``); whoever reads them resets them
traffic: Counter = Counter()


def _count(name: str, *xs: torch.Tensor) -> None:
    traffic[name] += 1
    traffic[f"{name}_bytes"] += sum(x.numel() * x.element_size() for x in xs)


def _through_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``group`` (``x`` itself without a
    group)."""
    if group is None:
        return x
    _count("all_reduce", x)
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank of ``group``'s ``x`` concatenated along ``dim`` in group
    order."""
    if group is None:
        return x
    _count("all_gather", x)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over
    ``group``.  Gloo has no reduce-scatter in every torch the port runs
    on (2.11 has none): on a gloo group it is an all-reduce and a slice."""
    if group is None:
        return x
    _count("reduce_scatter", x)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "gloo":
        full = x.contiguous().clone()
        dist.all_reduce(full, group=group)
        return full.narrow(dim, r * (x.shape[dim] // n), x.shape[dim] // n)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty(src.shape[0] // n, *src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_to_all(chunks: List[torch.Tensor], group) -> List[torch.Tensor]:
    """``chunks[s]`` sent to rank s of ``group``; what each rank sent this
    one, in group order (every chunk of one shape).  One
    ``all_to_all_single`` (gloo has no list all-to-all in torch 2.11)."""
    _count("all_to_all", *chunks)
    host = _through_host(chunks[0], group)
    send = torch.stack([c.cpu() if host else c for c in chunks])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    out = list((recv.to(chunks[0].device) if host else recv).unbind(0))
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        rank, world = data_shard()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        ctx.group = group
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rows[0]:ctx.rows[1]], None


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along axis 0 in rank order
    (every rank's ``x`` has the same shape); differentiable as set out
    above."""
    if data_shard()[1] == 1:
        return x
    return _AllGatherRows.apply(x, data_group())


def psum_scalar(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (not differentiable)."""
    if data_shard()[1] == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=data_group())
    return x


def pmean_scalar(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (not differentiable)."""
    return psum_scalar(x) / data_shard()[1]

