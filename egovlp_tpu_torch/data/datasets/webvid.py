"""WebVid-2M video-text dataset (the legacy Frozen-in-Time pretraining
data).

Counterpart of ``egovlp_tpu/data/datasets/webvid.py``: the
``metadata/results_{cut}_{split}.csv`` rows (``videoid``, ``name``; cut
``2M`` unless ``extra['cut']`` says otherwise, split ``train`` or else
``val``) and ``videos/{videoid}.mp4`` under ``data_dir``.  The csv is read
with the standard library (``table.read_table``), each column typed as
pandas types it.  ``subsample < 1`` keeps that fraction of the rows in
random order, as ``DataFrame.sample(frac=...)`` does, drawn from a numpy
generator seeded with 0 (the JAX package draws them unseeded).  The test
split takes ``sliding_window_stride``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.datasets.table import n_rows, read_table, row
from egovlp_tpu_torch.data.readers import get_video_len, read_frames


class WebVidDataset(TextVideoDataset):
    def _load_metadata(self):
        cut = self.cfg.extra.get("cut", "2M")
        split = "train" if self.cfg.split == "train" else "val"
        self.metadata = read_table(os.path.join(
            self.cfg.meta_dir, "metadata", f"results_{cut}_{split}.csv"))
        n = n_rows(self.metadata)
        self._rows = np.arange(n)
        frac = self.cfg.subsample
        if isinstance(frac, (int, float)) and frac < 1:
            self._rows = np.random.default_rng(0).permutation(n)[
                :int(round(frac * n))]

    def _sample(self, i: int) -> Dict[str, Any]:
        return row(self.metadata, int(self._rows[i]))

    def _video_path(self, sample) -> str:
        return os.path.join(self.cfg.data_dir, "videos",
                            str(sample["videoid"]) + ".mp4")

    def _video_lens(self):
        return [get_video_len(self._video_path(self._sample(i)),
                              self.cfg.reader_backend)
                for i in range(len(self._rows))]

    def __len__(self):
        return self._expanded_len(len(self._rows))

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        idx, fix_start = self._resolve_index(idx, len(self._rows))
        sample = self._sample(idx)
        frames = self._decode_or_black(
            read_frames, self._video_path(sample), self.cfg.num_frames,
            self.frame_sample, fix_start=fix_start,
            pre_size=self.cfg.pre_size, rng=rng,
            backend=self.cfg.reader_backend)
        return {"frames": frames, "text": str(sample["name"])}
