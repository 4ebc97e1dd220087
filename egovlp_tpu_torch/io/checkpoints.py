"""Training checkpoints as torch pickles.

The role of ``egovlp_tpu/io/checkpoints.py`` (which writes Orbax
directories): one file per save, ``checkpoint-epoch{N}.pth``, plus
``model_best.pth`` when the monitored metric improves, and resume from the
latest epoch.  The payload is the reference's ``{state_dict, epoch,
monitor_best, arch}`` (``egovlp_tpu/models/convert.py:313-322``), so a
published-checkpoint loader reads the weights, plus ``optimizer`` (the
optimizer's ``state_dict()``) and ``step`` (the optimizer step count).
Each file is written to a temporary name and renamed into place, so a
crash mid-write leaves the previous checkpoint whole.  An Orbax directory
from the JAX package is not read: export it to a ``.pth`` first
(``python -m egovlp_tpu.cli.convert export_torch``).
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

import torch

ARCH = "FrozenInTime"


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def save_epoch(self, epoch: int, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, monitor_best: float,
                   is_best: bool = False) -> Path:
        payload = {
            "state_dict": model.state_dict(),
            "epoch": int(epoch),
            "monitor_best": float(monitor_best),
            "arch": ARCH,
            "optimizer": optimizer.state_dict(),
            "step": int(optimizer.param_groups[0].get("count", 0)),
        }
        path = self.directory / f"checkpoint-epoch{epoch}.pth"
        self._write(path, payload)
        if is_best:
            self._write(self.directory / "model_best.pth", payload)
        return path

    def _write(self, path: Path, payload: Dict[str, Any]) -> None:
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def latest(self) -> Optional[Path]:
        best, best_epoch = None, -1
        for child in self.directory.glob("checkpoint-epoch*.pth"):
            m = re.fullmatch(r"checkpoint-epoch(\d+)\.pth", child.name)
            if m and int(m.group(1)) > best_epoch:
                best, best_epoch = child, int(m.group(1))
        return best

    def restore(self, model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None,
                path: Optional[str] = None) -> Dict[str, Any]:
        """Load ``path`` (default: the latest epoch) into the model, and the
        optimizer when given; returns the payload."""
        p = Path(path) if path else self.latest()
        if p is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        payload = torch.load(p, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["state_dict"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])
        return payload
