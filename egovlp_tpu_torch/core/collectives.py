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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.dist import process_shard


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        rank, world = process_shard()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[ctx.rows[0]:ctx.rows[1]]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0 in rank order (every
    rank's ``x`` has the same shape); differentiable as set out above."""
    if process_shard()[1] == 1:
        return x
    return _AllGatherRows.apply(x)


def psum_scalar(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (not differentiable)."""
    if process_shard()[1] == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x


def pmean_scalar(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (not differentiable)."""
    return psum_scalar(x) / process_shard()[1]
