"""JSON task configuration (the ``configs/**/*.json`` schema).

A jax-free counterpart of ``egovlp_tpu/io/config.py`` with what the serve
CLI needs: ``load_config``, dotted-path ``get_path`` and ``override``.
"""

from __future__ import annotations

import json
import os
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


def load_config(path: str,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    with open(os.path.expandvars(path)) as f:
        cfg = Config(json.load(f))
    for k, v in (overrides or {}).items():
        cfg.override(k, v)
    return cfg
