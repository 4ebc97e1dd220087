"""JSON task configuration (the ``configs/**/*.json`` schema).

Counterpart of ``egovlp_tpu/io/config.py``: ``load_config``, dotted-path
``get_path`` and ``override``, ``clone``, and run directories in the
reference's layout, ``{save_dir}/{models,log,tf}/{name}/{timestamp}``,
with the config written to ``models/.../config.json``.
"""

from __future__ import annotations

import copy
import datetime
import json
import os
from pathlib import Path
from typing import Any, Dict, Optional


class Config(dict):
    """Dict with dotted-path access and overrides."""

    def override(self, dotted: str, value: Any) -> "Config":
        """Set ``a.b.c = value``, creating missing levels."""
        keys = dotted.split(".")
        node = self
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
        return self

    def get_path(self, dotted: str, default=None):
        node = self
        for k in dotted.split("."):
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

    def clone(self) -> "Config":
        return Config(copy.deepcopy(dict(self)))

    def make_run_dirs(self, timestamp: Optional[str] = None
                      ) -> Dict[str, Path]:
        save_dir = Path(self.get_path("trainer.save_dir", "results"))
        name = self.get("name", "run")
        ts = timestamp or datetime.datetime.now().strftime("%m%d_%H%M%S")
        dirs = {kind: save_dir / kind / name / ts
                for kind in ("models", "log", "tf")}
        for d in dirs.values():
            d.mkdir(parents=True, exist_ok=True)
        with open(dirs["models"] / "config.json", "w") as f:
            json.dump(dict(self), f, indent=2, default=str)
        return dirs


def load_config(path: str,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    with open(os.path.expandvars(path)) as f:
        cfg = Config(json.load(f))
    for k, v in (overrides or {}).items():
        cfg.override(k, v)
    return cfg
