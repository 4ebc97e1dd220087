"""Logging for the port's entry points: Python logging, scalar metrics
and device traces.

Counterpart of ``egovlp_tpu/io/logging.py``:

* ``setup_logging`` (:21-38): a stdout handler and, given a directory, a
  rotating ``info.log`` on the ``egovlp_tpu_torch`` logger.  In a
  multi-process run only rank 0 logs at INFO; the other ranks log
  warnings and errors.
* ``MetricLogger`` (:41-93): scalars tagged ``{mode}/{name}`` at a step,
  one JSON line each in ``{log_dir}/metrics.jsonl`` and, when
  ``tensorboardX`` imports, a TensorBoard event file; ``set_step`` logs
  ``steps_per_sec`` since the previous ``set_step``.  ``run_task``
  enables it on rank 0 only, in the run's ``tf`` directory.
* ``Profiler`` (:96-125): a ``torch.profiler`` trace (CPU, and CUDA when a
  device is present) from step ``start`` to step ``stop``, written as a
  Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from egovlp_tpu_torch.core.dist import is_main_process


def setup_logging(save_dir: Optional[str] = None,
                  level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("egovlp_tpu_torch")
    logger.setLevel(level if is_main_process() else logging.WARNING)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            Path(save_dir) / "info.log", maxBytes=10 * 1024 ** 2,
            backupCount=20)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Scalar logging to JSONL and, when ``tensorboardX`` imports, to
    TensorBoard; a no-op unless ``enabled`` and given a ``log_dir``."""

    def __init__(self, log_dir: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled and log_dir is not None
        self._tb = None
        self._jsonl = None
        self._step = 0
        self._mode = ""
        self._t0 = None
        if self.enabled:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(log_dir) / "metrics.jsonl", "a")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def set_step(self, step: int, mode: str = "train") -> None:
        self._step = step
        self._mode = mode
        now = time.time()
        if self._t0 is not None and step > 0:
            self.scalar("steps_per_sec", 1.0 / max(now - self._t0, 1e-9))
        self._t0 = now

    def scalar(self, name: str, value: float,
               step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        step = self._step if step is None else step
        tag = f"{self._mode}/{name}" if self._mode else name
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        self._jsonl.write(json.dumps(
            {"step": step, "tag": tag, "value": float(value),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def scalars(self, values: Dict[str, float],
                step: Optional[int] = None) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class Profiler:
    """A ``torch.profiler`` trace of chosen steps: ``prof = Profiler(
    log_dir, start=10, stop=13)``, then ``prof.step(i)`` once a step; the
    steps from ``start`` up to ``stop`` are written to
    ``{log_dir}/trace_steps{start}-{stop}.json``.  ``start < 0`` or no
    ``log_dir`` turns it off."""

    def __init__(self, log_dir: Optional[str], start: int = -1,
                 stop: int = -1):
        self.log_dir = log_dir
        self.start_step = start
        self.stop_step = stop
        self._prof = None

    def step(self, step: int) -> None:
        if self.log_dir is None or self.start_step < 0:
            return
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif step == self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        """Stop an active trace and write it."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(
            Path(self.log_dir)
            / f"trace_steps{self.start_step}-{self.stop_step}.json"))
