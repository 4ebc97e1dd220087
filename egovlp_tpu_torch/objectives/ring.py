"""Memory-lean global-batch contrastive losses over a ring of ranks.

Counterpart of ``egovlp_tpu/objectives/ring.py`` (:47-82) and
``chunked_global_similarity`` (``egovlp_tpu/core/collectives.py`` :51-74).
The gather path builds the ``[G, G]`` similarity of the global batch on
every GPU.  Here each rank builds only its ``[l, G]`` row blocks, ``t2v``
and ``v2t``, by passing the other side's shard around the ranks (rank r
sends to r + 1 and receives from r - 1, ``dist.batch_isend_irecv``): no
``[G, G]`` tensor lives on one GPU.  Each loss direction is a row-wise
reduction, so a rank's complete rows are all it needs; the global mean is
one all-reduce.

A rank's rows need not be one contiguous block of the global batch: with
scene negatives they are ``[pos_r; neg_r]`` in the global order ``[pos_all;
neg_all]``.  So the caller gives every rank's row positions (``rows``,
``[world, l]``, from ``train.steps._global_rows``): a column block lands
at its owner's positions, and this rank's diagonal sits at its own.

Gradients: the ring's backward passes each rank's share of every column
block's gradient back around the ring to the block's owner, who adds them.
The loss is the global mean, but it back-propagates as this rank's rows'
loss alone; so rank r's embeddings get the sum over ranks of d L_s / d x_r,
N times d L / d x_r, and ``DistributedDataParallel``'s mean gives d L /
d theta, as ``core.collectives.all_gather_rows`` does on the gather path.

Gloo moves host memory only: on a gloo group a CUDA shard goes through the
host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.collectives import all_gather_rows, psum_scalar
from egovlp_tpu_torch.core.dist import process_shard


def _shift(x: torch.Tensor) -> torch.Tensor:
    """``x`` sent to rank + 1; what rank - 1 sent, received."""
    rank, world = process_shard()
    host = x.is_cuda and dist.get_backend() == "gloo"
    send = x.detach().cpu() if host else x.detach().contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, (rank + 1) % world),
            dist.P2POp(dist.irecv, recv, (rank - 1) % world)]):
        req.wait()
    return recv.to(x.device) if host else recv


class _RingSimilarity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rows):
        rank, world = process_shard()
        out = a.new_empty(a.shape[0], rows.numel())
        blocks, lb = [], b.contiguous()
        for step in range(world):
            blocks.append(lb)
            out[:, rows[(rank - step) % world]] = a @ lb.T
            if step != world - 1:
                lb = _shift(lb)
        ctx.save_for_backward(a, rows, *blocks)
        return out

    @staticmethod
    def backward(ctx, grad):
        a, rows, *blocks = ctx.saved_tensors
        rank, world = process_shard()
        da = sum(grad[:, rows[(rank - s) % world]] @ blk
                 for s, blk in enumerate(blocks))
        # rank r adds its share of owner (r - k - 1)'s block gradient at
        # step k and passes the sum on: after the last step it holds the
        # sum over ranks of its own block's gradient
        acc = None
        for k in range(world):
            part = grad[:, rows[(rank - k - 1) % world]].T @ a
            acc = part if acc is None else acc + part
            if k != world - 1:
                acc = _shift(acc)
        return da, acc, None


def ring_similarity(a: torch.Tensor, b: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """``a @ b_all.T``: this rank's ``[l, P]`` rows against every rank's
    ``b``, ``[l, G]`` with rank s's columns at ``rows[s]``."""
    return _RingSimilarity.apply(a, b, rows)


def _normalize(x, eps=1e-8):
    """The eps-clamped rows of ``models.dual_encoder.sim_matrix``."""
    x = x.float()
    return x / x.norm(dim=1, keepdim=True).clamp_min(eps)


def _row_direction_egonce(rows, mask, temperature):
    s = rows / temperature
    log_pos = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=1)
    return (log_pos - torch.logsumexp(s, dim=1)).mean()


def _row_direction_infonce(rows, diag_cols, temperature):
    logp = torch.log_softmax(rows / temperature, dim=1)
    return logp.gather(1, diag_cols[:, None]).mean()


def _global(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` in global row order (not differentiated)."""
    out = x.new_empty(rows.numel(), *x.shape[1:])
    out[rows.reshape(-1)] = all_gather_rows(x.detach())
    return out


def egoclip_ring_loss(t, v, noun_vec, verb_vec, rows, *, loss_type: str,
                      temperature: float = 0.05, noun: bool = True,
                      verb: bool = True) -> torch.Tensor:
    """The global-batch EgoNCE (or InfoNCE) loss from this rank's rows.

    ``t``, ``v``, ``noun_vec``, ``verb_vec``: this rank's ``[l, ...]``
    rows; ``rows``: ``[world, l]``, every rank's positions in the global
    batch.  Returns the global loss, equal to ``egonce(sim_matrix(t, v),
    ...)`` / ``info_nce`` on the gathered batch; its gradient is that of
    this rank's rows' share (see the module notes)."""
    rank, _ = process_shard()
    mine = rows[rank]
    tn, vn = _normalize(t), _normalize(v)
    rows_t2v = ring_similarity(tn, vn, rows)
    rows_v2t = ring_similarity(vn, tn, rows)
    if loss_type == "EgoNCE":
        # positives share a verb and a noun class, plus the diagonal; the
        # mask is symmetric, so both directions take the same rows
        diag = mine[:, None] == torch.arange(rows.numel(), device=t.device)
        by_noun = noun_vec @ _global(noun_vec, rows).T
        by_verb = verb_vec @ _global(verb_vec, rows).T
        if noun and verb:
            pos = by_noun * by_verb
        else:
            pos = by_noun if noun else by_verb
        mask = (pos > 0) | diag
        d1 = _row_direction_egonce(rows_t2v, mask, temperature)
        d2 = _row_direction_egonce(rows_v2t, mask, temperature)
    else:  # InfoNCE: diagonal positives
        d1 = _row_direction_infonce(rows_t2v, mine, temperature)
        d2 = _row_direction_infonce(rows_v2t, mine, temperature)
    local = -(d1 + d2)
    total = psum_scalar(local.detach()) / process_shard()[1]
    return local + (total - local.detach())
