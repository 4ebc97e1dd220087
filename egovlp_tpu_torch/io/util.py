"""Small host utilities of the reference's ``utils/util.py``.

The port's own copy of ``egovlp_tpu/io/util.py``: the config-tree helpers
``replace_nested_dict_item`` and ``read_json`` / ``write_json`` (order
kept), ``inf_loop`` (a Loader's epochs one after another, or a plain
iterable cycled), ``np_loader`` / ``memcache`` (``.npy`` feature files,
optionally l2-normalised rows, cached per process), ``Timer`` (split
times on the monotonic clock), and ``memory_summary``, which reports the
CUDA allocator's memory (``torch.cuda.memory_stats``) where the JAX
package reports the host's.
"""

from __future__ import annotations

import functools
import json
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Iterator

import numpy as np
import torch


def replace_nested_dict_item(obj: Dict, key: str, replace_value) -> Dict:
    """Replace every occurrence of ``key`` anywhere in a nested dict
    (reference util.py:16-22; used by its multi-loader val derivation)."""
    for k, v in obj.items():
        if isinstance(v, dict):
            obj[k] = replace_nested_dict_item(v, key, replace_value)
    if key in obj:
        obj[key] = replace_value
    return obj


def read_json(fname) -> OrderedDict:
    with Path(fname).open("rt") as handle:
        return json.load(handle, object_hook=OrderedDict)


def write_json(content, fname) -> None:
    with Path(fname).open("wt") as handle:
        json.dump(content, handle, indent=4, sort_keys=False)


def inf_loop(loader) -> Iterator[Dict[str, Any]]:
    """Endless batch stream over a Loader (reference util.py:96-99).

    The reference re-iterates its torch DataLoader forever; here each
    cycle advances the Loader's ``epoch`` counter so shuffling loaders
    reshuffle per cycle (epoch-bounded stretching inside ONE epoch is the
    Loader's own ``max_samples_per_epoch`` cycling, data/pipeline.py).
    Plain iterables (e.g. lists of batches) cycle unchanged.
    """
    if hasattr(loader, "epoch"):
        e = 0
        while True:
            yield from loader.epoch(e)
            e += 1
    else:
        while True:
            yield from loader


def np_loader(np_path, l2norm: bool = False):
    """Load a .npy feature file, unwrapping numpy's 0-d dict-storage
    convention; optional row-wise l2 normalization (util.py:120-137)."""
    with open(np_path, "rb") as f:
        data = np.load(f, encoding="latin1", allow_pickle=True)
    if isinstance(data, np.ndarray) and data.size == 1:
        data = data[()]
    if l2norm:
        if isinstance(data, dict):
            data = {k: v / max(np.linalg.norm(v), 1e-6)
                    for k, v in data.items()}
        elif data.ndim == 2:
            norm = np.linalg.norm(data, axis=1)
            data = data / np.maximum(norm.reshape(-1, 1), 1e-6)
        else:
            raise ValueError(f"unexpected data format {type(data)}")
    return data


@functools.lru_cache(maxsize=64, typed=False)
def memcache(path):
    """Process-cached feature-file loader (util.py:106-117)."""
    suffix = Path(path).suffix
    if suffix != ".npy":
        raise ValueError(f"unknown suffix: {suffix} for path {path}")
    return np_loader(path)


class Timer:
    """Split timer with the reference's check()/reset() API
    (util.py:140-151); monotonic clock instead of datetime."""

    def __init__(self):
        self.cache = time.monotonic()

    def check(self) -> float:
        now = time.monotonic()
        duration, self.cache = now - self.cache, now
        return duration

    def reset(self) -> None:
        self.cache = time.monotonic()


def memory_summary(device: "torch.device | str | None" = None) -> str:
    """One line of the CUDA caching allocator's memory on ``device`` (the
    current one by default): allocated now and at peak, and reserved;
    printed and returned.  Without a CUDA device it says so."""
    if not torch.cuda.is_available():
        msg = ">>> memory_summary: no CUDA device"
    else:
        stats = torch.cuda.memory_stats(device)

        def gib(key):
            return stats.get(key, 0) / 2 ** 30

        msg = (f">>> {torch.cuda.get_device_name(device)}: allocated "
               f"{gib('allocated_bytes.all.current'):.2f}G (peak "
               f"{gib('allocated_bytes.all.peak'):.2f}G), reserved "
               f"{gib('reserved_bytes.all.current'):.2f}G")
    print(msg)
    return msg
