"""The EgoClip epoch function over collated batches.

Counterpart of ``_make_train_epoch_fn`` (``egovlp_tpu/train/recipes.py``
:75-130): one optimizer step per loader per batch index (the reference
zips its loaders), the batches copied to the device, per-loader DEVICE
losses kept through the epoch (a host sync only every ``log_step``
batches and once for the epoch means ``loss_{i}``), and ``max_samples``
cutting the epoch.  Each step draws its randomness from its own
``torch.Generator`` on the device, seeded from ``(seed, epoch, step)``.
``run_task`` waits for the EgoClip dataset and Loader (ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Sequence

import numpy as np
import torch

from egovlp_tpu_torch.train.steps import numeric_batch


def to_device(batch: dict, device: "torch.device | str"
              ) -> Dict[str, torch.Tensor]:
    """numpy arrays (and tensors) of a collated batch -> device tensors."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in numeric_batch(batch).items()}


def step_generator(device: "torch.device | str", seed: int, epoch: int,
                   index: int) -> torch.Generator:
    """The generator of one step, a fixed function of (seed, epoch, step)."""
    s = np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def make_train_epoch_fn(loaders: Sequence[Iterable], step_fn: Callable,
                        device: "torch.device | str", max_samples: int = 0,
                        log_step: int = 100, seed: int = 0) -> Callable:
    """``train_epoch(model, optimizer, epoch, logger) -> {'loss_{i}': ...}``.
    A loader is any iterable of collated numpy batches."""
    def train_epoch(model, optimizer, epoch, logger):
        t0 = time.time()
        losses = [[] for _ in loaders]
        nl, n = len(loaders), 0
        for i, batch_tuple in enumerate(zip(*loaders)):
            bs = len(batch_tuple[0]["frames"])
            if max_samples and (i + 1) * bs > max_samples:
                break
            for dl_idx, batch in enumerate(batch_tuple):
                gen = step_generator(device, seed, epoch, i * nl + dl_idx)
                loss = step_fn(model, optimizer, to_device(batch, device), gen)
                losses[dl_idx].append(loss)
                n += 1
            if i % log_step == 0:
                for dl_idx in range(nl):
                    logger.info("epoch %d step %d dl%d loss %.4f (%.2f s/it)",
                                epoch, i, dl_idx, float(losses[dl_idx][-1]),
                                (time.time() - t0) / max(n, 1))
        return {f"loss_{dl_idx}": float(torch.stack(ls).mean()) if ls else 0.0
                for dl_idx, ls in enumerate(losses)}

    return train_epoch
