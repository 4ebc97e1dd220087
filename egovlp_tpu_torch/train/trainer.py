"""Epoch-loop trainer: monitoring, early stop, checkpoint save and resume.

Counterpart of ``egovlp_tpu/train/trainer.py`` with the same loop
(:66-118): ``init_val`` validation before the first epoch, a monitored
metric with min/max mode and best tracking, early stop after more than
``early_stop`` epochs without improvement, and a checkpoint every
``save_period`` epochs or on improvement.  The task specifics are two
callables: ``train_epoch_fn(model, optimizer, epoch, logger) -> log`` and
``valid_fn(model, epoch, logger) -> log``.  The model and the optimizer
are the train state.  In a multi-process run ``train`` takes the
``DistributedDataParallel`` wrapper: the epoch function trains through
it, validation takes the module inside it, and the checkpoint manager
saves that module.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, Optional

import torch

from egovlp_tpu_torch.core.dist import unwrap
from egovlp_tpu_torch.io.checkpoints import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 10
    save_period: int = 1
    monitor: str = "off"        # e.g. 'max Inter-video' / 'min loss_0'
    early_stop: int = 10
    init_val: bool = False
    save_dir: Optional[str] = None
    start_epoch: int = 1


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_epoch_fn: Callable,
                 valid_fn: Optional[Callable] = None,
                 ckpt: Optional[CheckpointManager] = None,
                 logger: Optional[logging.Logger] = None):
        self.cfg = cfg
        self.train_epoch_fn = train_epoch_fn
        self.valid_fn = valid_fn
        self.ckpt = ckpt or (CheckpointManager(cfg.save_dir)
                             if cfg.save_dir else None)
        self.logger = logger or logging.getLogger("egovlp_tpu_torch")
        if cfg.monitor == "off":
            self.mnt_mode, self.mnt_metric = "off", None
            self.mnt_best = 0.0
        else:
            self.mnt_mode, self.mnt_metric = cfg.monitor.split(maxsplit=1)
            if self.mnt_mode not in ("min", "max"):
                raise ValueError(f"monitor {cfg.monitor!r}: mode must be "
                                 "'min' or 'max'")
            self.mnt_best = math.inf if self.mnt_mode == "min" else -math.inf

    def resume(self, model: torch.nn.Module,
               optimizer: torch.optim.Optimizer,
               path: Optional[str] = None) -> Dict[str, Any]:
        """Load the latest checkpoint (or ``path``) into the model and the
        optimizer; training goes on at the epoch after it."""
        payload = self.ckpt.restore(model, optimizer, path)
        self.cfg.start_epoch = payload["epoch"] + 1
        self.mnt_best = payload["monitor_best"]
        return payload

    def _improved(self, log: Dict[str, Any]) -> bool:
        if self.mnt_mode == "off" or self.mnt_metric not in log:
            return False
        v = log[self.mnt_metric]
        if self.mnt_mode == "min":
            return v <= self.mnt_best
        return v >= self.mnt_best

    def train(self, model: torch.nn.Module,
              optimizer: torch.optim.Optimizer) -> torch.nn.Module:
        cfg = self.cfg
        not_improved = 0
        module = unwrap(model)

        if cfg.init_val and self.valid_fn is not None:
            log = self.valid_fn(module, cfg.start_epoch - 1, self.logger)
            self.logger.info("init_val: %s", log)
            if cfg.epochs < cfg.start_epoch:  # eval-only configs (epochs: 0)
                return model

        for epoch in range(cfg.start_epoch, cfg.epochs + 1):
            log = self.train_epoch_fn(model, optimizer, epoch, self.logger)
            if self.valid_fn is not None:
                log.update(self.valid_fn(module, epoch, self.logger))
            for k, v in log.items():
                self.logger.info("  epoch %d: %s: %s", epoch, k, v)

            best = False
            if self.mnt_mode != "off":
                if self.mnt_metric not in log:
                    self.logger.warning(
                        "monitored metric %r not in log; disabling monitor",
                        self.mnt_metric)
                    self.mnt_mode = "off"
                elif self._improved(log):
                    self.mnt_best = log[self.mnt_metric]
                    not_improved = 0
                    best = True
                else:
                    not_improved += 1
                if not_improved > cfg.early_stop:
                    self.logger.info(
                        "no improvement for %d epochs; early stopping",
                        not_improved)
                    break

            if self.ckpt is not None and (epoch % cfg.save_period == 0 or best):
                self.ckpt.save_epoch(epoch, model, optimizer, self.mnt_best,
                                     is_best=best)
        return model
