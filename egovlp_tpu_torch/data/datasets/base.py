"""Dataset base: host-side metadata and frame extraction.

The port's own copy of ``egovlp_tpu/data/datasets/base.py`` (:25-145).
Datasets emit plain numpy items (fixed-shape uint8 frames plus metadata)
and every pixel op runs on the model's device
(``egovlp_tpu_torch/data/transforms.py``).  Items take an explicit numpy
``Generator``, so whichever thread or process decodes an item gets the
same frames.

Behaviours kept from the reference:
  * ``loading='lax'`` substitutes black frames when a decode fails;
    ``'strict'`` raises;
  * the train split samples frames at random, val/test uniformly;
  * the output shape is static, ``[num_frames, pre_size, pre_size, 3]``;
  * the test-time sliding-window expansion (``sliding_window_stride``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class DatasetConfig:
    data_dir: str = ""
    meta_dir: Optional[str] = None
    split: str = "train"
    num_frames: int = 4
    pre_size: int = 256
    input_res: int = 224
    loading: str = "strict"  # 'strict' | 'lax'
    reader_backend: str = "auto"
    neg_param: Optional[int] = None   # EgoClip scene-negative window (sec)
    subsample: Any = 1                # NLQ: 'video'|'text'; others: frac
    max_samples: Optional[int] = None
    sliding_window_stride: int = -1   # test-time dense sampling (-1 = off)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.data_dir = os.path.expandvars(self.data_dir)
        self.meta_dir = os.path.expandvars(self.meta_dir or self.data_dir)


class TextVideoDataset:
    """Minimal dataset protocol: __len__ + get(idx, rng) -> dict."""

    def __init__(self, cfg: DatasetConfig):
        self.cfg = cfg
        self._windows: Optional[list] = None
        self._load_metadata()
        if cfg.sliding_window_stride != -1:
            # reference base_dataset.py:51-54: test-time only, computed once
            # right after metadata load
            if cfg.split != "test":
                raise ValueError(
                    "Fixing frame sampling is for test time only"
                )
            self._windows = self.expand_temporal_windows(
                self._video_lens(), cfg.sliding_window_stride
            )

    # -- subclass hooks ------------------------------------------------
    def _load_metadata(self):
        raise NotImplementedError

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        raise NotImplementedError

    # -- helpers --------------------------------------------------------
    @property
    def frame_sample(self) -> str:
        return "rand" if self.cfg.split == "train" else "uniform"

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx: int):
        return self.get(idx, np.random.default_rng(idx))

    def _black_frames(self) -> np.ndarray:
        return np.zeros(
            (self.cfg.num_frames, self.cfg.pre_size, self.cfg.pre_size, 3),
            np.uint8,
        )

    # -- test-time sliding-window expansion ------------------------------
    def _video_lens(self):
        """Frame counts per metadata row, for the sliding-window expansion
        (reference base_dataset.py:68-74 `_get_video_lens`).  Implemented by
        datasets whose reader supports ``fix_start`` offsets."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support sliding_window_stride"
        )

    def expand_temporal_windows(self, vlens, stride: int):
        """Sliding-window test-time expansion (reference
        base_dataset.py:76-83 `_fix_temporal_samples`): each video of
        ``vlen`` frames becomes multiple items with ``fix_start`` offsets
        0, stride, 2*stride, ... within one sampling-interval length.

        The interval length follows the reference quirk exactly:
        ``int(vlen / (min(vlen, num_frames) + 1))`` — the ``len(x - 1)``
        in base_dataset.py:81 is the length of the intervals ARRAY
        (num_frames + 1 boundaries), not num_frames.  When that range is
        empty (very short videos) the video keeps a single fix_start=0
        item; the reference's pandas ``explode`` would emit a NaN
        fix_start there, which crashes its reader.

        Returns a list of (orig_index, fix_start) pairs; datasets remap
        item indices through this list and pass fix_start to the reader."""
        assert self.cfg.split == "test", (
            "sliding-window sampling is test-time only"
        )
        out = []
        for i, vlen in enumerate(vlens):
            acc = min(vlen, self.cfg.num_frames)
            stop = int(vlen / (acc + 1))
            starts = list(range(0, stop, stride)) or [0]
            for fs in starts:
                out.append((i, fs))
        return out

    def _resolve_index(self, idx: int, base_len: int):
        """Map a loader index to (metadata_index, fix_start), through the
        sliding-window table when active (reference base_dataset.py:88-100:
        ``item % len(metadata)`` then the exploded row's fix_start)."""
        if self._windows is None:
            return idx % base_len, None
        return self._windows[idx % len(self._windows)]

    def _expanded_len(self, base_len: int) -> int:
        return len(self._windows) if self._windows is not None else base_len

    def _decode_or_black(self, fn, *args, **kw) -> np.ndarray:
        """Run a reader; on failure follow the loading policy."""
        try:
            frames, _ = fn(*args, **kw)
            return frames
        except Exception as e:
            if self.cfg.loading == "strict":
                raise ValueError(f"video loading failed ({e}); "
                                 "loading for this dataset is strict") from e
            return self._black_frames()
