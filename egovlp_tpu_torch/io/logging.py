"""Python logging for the port's entry points.

Counterpart of ``setup_logging`` in ``egovlp_tpu/io/logging.py`` (:21-38):
a stdout handler and, given a directory, a rotating ``info.log`` on the
``egovlp_tpu_torch`` logger.  In a multi-process run only rank 0 logs
at INFO (the JAX ``MetricLogger`` is enabled on process 0 only); the
other ranks log warnings and errors.  The TensorBoard ``MetricLogger``
and the ``Profiler`` are still to port (``ROADMAP.md``, Queue A, A12).
"""

from __future__ import annotations

import logging
import logging.handlers
import sys
from pathlib import Path
from typing import Optional

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
