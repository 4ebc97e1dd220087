"""Gradient accumulation for global-batch contrastive losses (GradCache).

Counterpart of ``egovlp_tpu/train/grad_cache.py`` (:40-94).  Naive
accumulation is wrong for EgoNCE / InfoNCE: the similarity matrix couples
every sample of the batch, so the loss is no sum over micro-batches.  The
two-pass scheme (Gao et al., 2021) gives the exact full-batch gradient
while holding the tower activations of one micro-batch only:

* pass 1 embeds every micro-batch under ``torch.no_grad()``;
* the loss and its gradient are taken at the embedding level, on the full
  batch in its original row order;
* pass 2 re-runs each micro-batch's forward with grad and back-propagates
  that micro-batch's rows of the embedding gradient; the parameter
  gradients add up in ``.grad``.

Both passes of a micro-batch draw the same random numbers (drop-path
masks): the generator's state before its pass-1 forward is restored before
its pass-2 forward (JAX gives both passes the same key, :70, :85), and the
state after pass 1 is restored at the end.  Under
``DistributedDataParallel`` pass 2 runs every micro-batch but the last in
the wrapper's ``no_sync()``, so the gradients are all-reduced once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch


def grad_cache_value_and_grad(embed_fn: Callable[[Dict[str, torch.Tensor]],
                                                 Sequence[torch.Tensor]],
                              loss_fn: Callable[..., torch.Tensor],
                              n_micro: int) -> Callable:
    """``fn(batch, generator=None, no_sync=None) -> loss`` (detached) that
    adds the gradient of ``loss_fn(*embed_fn(batch))`` into the parameters'
    ``.grad``, as ``loss.backward()`` of the monolithic composition would.

    ``embed_fn(micro_batch)`` returns the per-sample embeddings (the micro
    axis leading); ``loss_fn(*embeddings)`` couples the full batch's rows.
    ``batch`` maps names to ``[B, ...]`` tensors, ``B`` divisible by
    ``n_micro`` (else ``ValueError``).  ``generator``: the one
    ``embed_fn`` draws from, replayed in pass 2.  ``no_sync``: a
    ``DistributedDataParallel`` wrapper's ``no_sync``."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")

    def split(batch):
        for k, x in batch.items():
            if x.shape[0] % n_micro:
                raise ValueError(f"batch axis {x.shape[0]} of {k!r} not "
                                 f"divisible by n_micro={n_micro}")
        parts = {k: x.chunk(n_micro) for k, x in batch.items()}
        return [{k: p[j] for k, p in parts.items()} for j in range(n_micro)]

    def vg(batch: Dict[str, torch.Tensor],
           generator: Optional[torch.Generator] = None,
           no_sync: Optional[Callable] = None) -> torch.Tensor:
        micro = split(batch)
        states, embs = [], []
        with torch.no_grad():
            for mb in micro:
                states.append(None if generator is None
                              else generator.get_state())
                embs.append(tuple(embed_fn(mb)))
        end = None if generator is None else generator.get_state()
        full = [torch.cat(parts).requires_grad_() for parts in zip(*embs)]
        with torch.enable_grad():
            loss = loss_fn(*full)
        d_full = torch.autograd.grad(loss, full)
        rows = [len(e[0]) for e in embs]
        d_micro = list(zip(*(g.split(rows) for g in d_full)))
        for j, (mb, cts) in enumerate(zip(micro, d_micro)):
            if generator is not None:
                generator.set_state(states[j])
            last = j == n_micro - 1
            with (contextlib.nullcontext() if last or no_sync is None
                  else no_sync()):
                torch.autograd.backward(tuple(embed_fn(mb)), cts)
        if generator is not None:
            generator.set_state(end)
        return loss.detach()

    return vg
