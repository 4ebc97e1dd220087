"""Pipeline parallelism of the video tower's block stack (GPipe).

Counterpart of ``egovlp_tpu/core/pp.py``: the depth-D block stack is cut
into ``n_stages`` runs of D / S consecutive blocks, one a rank of a
``stage`` group the caller gives, and the batch into ``n_micro``
microbatches.  Each rank runs ``n_micro + S - 1`` ticks: stage 0 injects
microbatch t at tick t, every stage applies its blocks to the activation
it holds (when that is a microbatch, not the bubble), the last stage banks
its outputs, and the activations move one hop around the ring
(``objectives.ring._shift``: rank + 1; through the host only when the
caller chose gloo for CUDA tensors).  The banked outputs are summed over
the stage group (zeros elsewhere), so every stage holds them.  The bubble
is (S - 1) / (n_micro + S - 1).

JAX differentiates its ``scan`` + ``ppermute``.  Here the whole schedule
is one autograd Function, whose backward runs the ticks in reverse: the
gradient hops one rank back (rank - 1), each stage recomputes its blocks
from the activation it saved for that microbatch and back-propagates
through them (GPipe's recompute), stage 0 hands the injected
microbatches' gradients on.  Every rank runs every hop in the same order,
so the sends and receives pair up.

Gradients: a block's reach its own stage only and the tower's embedding
stage 0 only (sum both over the stage group); the head's are whole on
every stage.  ``data_group``: each data rank pipelines its rows of every
microbatch (``pp_rows``) through the same stages, and returns those rows;
its gradients cover them (sum over the data group).

``block_names`` / ``stack_block_params`` / ``unstack_block_params`` map
a state dict's ``blocks.{i}.*`` entries to and from tensors stacked on a
leading depth dim, as JAX stacks its ``blockNN`` subtrees.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from egovlp_tpu_torch.core.collectives import all_reduce
from egovlp_tpu_torch.objectives.ring import _shift

_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def block_names(state: Dict[str, torch.Tensor]) -> List[str]:
    """The ``blocks.{i}`` prefixes of ``state``, in depth order."""
    ids = sorted({int(m.group(1)) for k in state
                  if (m := _BLOCK.fullmatch(k))})
    if not ids:
        raise ValueError("no blocks.N entries in the state dict")
    return [f"blocks.{i}" for i in ids]


def stack_block_params(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """``{blocks.{i}.name: t}`` -> ``{name: [depth, ...]}``."""
    names = block_names(state)
    suffixes = [k[len(names[0]) + 1:] for k in state
                if k.startswith(names[0] + ".")]
    return {s: torch.stack([state[f"{n}.{s}"] for n in names])
            for s in suffixes}


def unstack_block_params(stacked: Dict[str, torch.Tensor], depth: int
                         ) -> Dict[str, torch.Tensor]:
    return {f"blocks.{i}.{s}": t[i] for s, t in stacked.items()
            for i in range(depth)}


def pp_rows(batch: int, n_micro: int, data_rank: int = 0,
            data_size: int = 1) -> torch.Tensor:
    """The global rows a data rank's ``pipeline_blocks`` output holds, in
    its order (microbatch-major)."""
    mb = batch // n_micro
    loc = mb // data_size
    return torch.cat([torch.arange(m * mb + data_rank * loc,
                                   m * mb + (data_rank + 1) * loc)
                      for m in range(n_micro)])


class _Stage:
    """One rank's part of the schedule."""

    def __init__(self, blocks: Sequence[Callable], block_apply: Callable,
                 n_stages: int, n_micro: int, group):
        self.blocks, self.block_apply = list(blocks), block_apply
        self.S, self.M, self.group = n_stages, n_micro, group
        self.stage = dist.get_rank(group)
        ranks = dist.get_process_group_ranks(group)
        self.peers = lambda i: ranks[i % n_stages]

    def apply(self, pair):
        for blk in self.blocks:
            pair = self.block_apply(blk, pair)
        return pair

    def hop(self, pair, step):
        return tuple(_shift(t, self.group, self.stage, self.peers, step)
                     for t in pair)


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage, mc, mx):
        s, S, M = stage.stage, stage.S, stage.M
        held = (torch.zeros_like(mc[0]), torch.zeros_like(mx[0]))
        oc, ox = torch.zeros_like(mc), torch.zeros_like(mx)
        saved = {}
        for t in range(M + S - 1):
            if s == 0 and t < M:
                held = (mc[t], mx[t])
            m = t - s
            if 0 <= m < M:
                saved[m] = held
                held = stage.apply(held)
                if s == S - 1:
                    oc[m], ox[m] = held
            held = stage.hop(held, 1)
        ctx.stage, ctx.saved = stage, saved
        ctx.shapes = (mc.shape, mx.shape)
        # the last stage's outputs on every stage; the gradient arrives
        # whole on each, and the last stage takes it
        return all_reduce(oc, stage.group), all_reduce(ox, stage.group)

    @staticmethod
    def backward(ctx, goc, gox):
        stage, saved = ctx.stage, ctx.saved
        s, S, M = stage.stage, stage.S, stage.M
        dmc = goc.new_zeros(ctx.shapes[0])
        dmx = gox.new_zeros(ctx.shapes[1])
        grad = (torch.zeros_like(goc[0]), torch.zeros_like(gox[0]))
        for t in reversed(range(M + S - 1)):
            grad = stage.hop(grad, -1)
            m = t - s
            if 0 <= m < M:
                if s == S - 1:
                    grad = (grad[0] + goc[m], grad[1] + gox[m])
                with torch.enable_grad():
                    inputs = tuple(x.detach().requires_grad_()
                                   for x in saved.pop(m))
                    outs = stage.apply(inputs)
                torch.autograd.backward(outs, grad)
                grad = tuple(x.grad for x in inputs)
            if s == 0 and t < M:
                dmc[t], dmx[t] = grad
                grad = tuple(torch.zeros_like(g) for g in grad)
        return None, dmc, dmx


def pipeline_blocks(pair, blocks: Sequence, block_apply: Callable, *,
                    n_stages: int, n_micro: int, stage_group,
                    data_group=None):
    """Run ``blocks`` (this stage's) as stage ``rank(stage_group)`` of an
    ``n_stages``-deep pipeline over ``n_micro`` microbatches.

    ``pair``: the tower's ``(cls [B, 1, D], grid [B, f, n, D])``, the same
    on every rank; ``block_apply(block, pair) -> pair``.  Returns the
    transformed pair (with ``data_group``: this data rank's ``pp_rows``)."""
    cls, xp = pair
    B = cls.shape[0]
    if B % n_micro:
        raise ValueError(f"B={B} % n_micro={n_micro} != 0")
    if dist.get_world_size(stage_group) != n_stages:
        raise ValueError(f"the stage group has "
                         f"{dist.get_world_size(stage_group)} ranks, not "
                         f"n_stages={n_stages}")
    mb = B // n_micro
    mc = cls.reshape(n_micro, mb, *cls.shape[1:])
    mx = xp.reshape(n_micro, mb, *xp.shape[1:])
    if data_group is not None:
        n, r = dist.get_world_size(data_group), dist.get_rank(data_group)
        if mb % n:
            raise ValueError(f"microbatch rows B/n_micro={mb} must divide "
                             f"the data axis size {n}")
        mc, mx = (t[:, r * mb // n:(r + 1) * mb // n] for t in (mc, mx))
    stage = _Stage(blocks, block_apply, n_stages, n_micro, stage_group)
    oc, ox = _Pipeline.apply(stage, mc, mx)
    return oc.flatten(0, 1), ox.flatten(0, 1)


def video_tower_pp_apply(tower, video: torch.Tensor, *, n_stages: int,
                         n_micro: int, stage_group,
                         data_group=None) -> torch.Tensor:
    """``tower(video)`` (a ``SpaceTimeTransformer``) with its block stack
    pipelined: the embedding (``tower.embed``) and the head run on every
    stage, the D blocks stream through ``n_stages`` stages, D / S each.
    Stochastic layers are not supported (drop-path in training mode
    raises)."""
    cfg = tower.cfg
    if cfg.drop_path_rate and tower.training:
        raise NotImplementedError(
            "the pipelined tower draws no drop-path masks; run with "
            "drop_path_rate=0 or in eval mode")
    depth = len(tower.blocks)
    if depth % n_stages:
        raise ValueError(f"depth={depth} % n_stages={n_stages} != 0")
    per = depth // n_stages
    s = dist.get_rank(stage_group)
    pair = tower.embed(video)
    pair = pipeline_blocks(
        pair, tower.blocks[s * per:(s + 1) * per],
        lambda blk, pr: blk(*pr), n_stages=n_stages, n_micro=n_micro,
        stage_group=stage_group, data_group=data_group)
    return tower.norm(pair[0])[:, 0]


def stage_owner(name: str, depth: int, n_stages: int) -> Optional[int]:
    """The stage whose gradient a tower parameter ``name`` is: its block's
    stage, 0 for the embedding, None for the head (whole on every
    stage)."""
    m = _BLOCK.fullmatch(name)
    if m:
        return int(m.group(1)) // (depth // n_stages)
    return None if name.startswith("norm.") else 0
