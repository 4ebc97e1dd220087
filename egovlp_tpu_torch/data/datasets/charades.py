"""CharadesEgo video-text dataset.

Counterpart of ``egovlp_tpu/data/datasets/charades.py``.  Train: the
tab-separated ``metadata_train.csv`` (made from the official annotations
by the JAX package's ``tools/charades_meta.py``), one row per action
segment with its narration, class and time bounds.  Val/test:
``CharadesEgo_v1_test_only1st.csv``, whose ``actions`` column ("c092
11.9 21.2;...") gives each video a 157-d multi-hot ``target``.  Both csvs
are read with the standard library (``table.read_table``), each column
typed as pandas types it.

``subsample < 1`` keeps that fraction of the rows, drawn without
replacement in random order as ``DataFrame.sample(frac=...)`` draws them,
but from a numpy generator seeded with 0: the JAX package draws them
unseeded, so its rows differ from run to run.  Every shipped config sets
``subsample`` 1.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.datasets.table import n_rows, read_table, row
from egovlp_tpu_torch.data.readers import read_frames_charades

NUM_CLASSES = 157


def parse_charades_actions(path: str) -> dict:
    """id -> ``[{'class': 'c092', 'start': s, 'end': e}, ...]``."""
    labels = {}
    with open(path) as f:
        for r in csv.DictReader(f):
            actions = r["actions"]
            if actions == "":
                labels[r["id"]] = []
            else:
                parsed = [a.split(" ") for a in actions.split(";")]
                labels[r["id"]] = [
                    {"class": x, "start": float(y), "end": float(z)}
                    for x, y, z in parsed]
    return labels


class CharadesEgoDataset(TextVideoDataset):
    def _load_metadata(self):
        if self.cfg.split == "train":
            self.metadata = read_table(
                os.path.join(self.cfg.meta_dir, "metadata_train.csv"), "\t")
        else:
            path = os.path.join(self.cfg.meta_dir,
                                "CharadesEgo_v1_test_only1st.csv")
            self.metadata = read_table(path)
            self.label = parse_charades_actions(path)
        n = n_rows(self.metadata)
        self._rows = np.arange(n)
        frac = self.cfg.subsample
        if isinstance(frac, (int, float)) and frac < 1:
            self._rows = np.random.default_rng(0).permutation(n)[
                :int(round(frac * n))]

    def __len__(self):
        return len(self._rows)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        sample = row(self.metadata, int(self._rows[idx % len(self)]))
        video_fp = os.path.join(self.cfg.data_dir, sample["id"] + ".mp4")
        if self.cfg.split == "train":
            frames = self._decode_or_black(
                read_frames_charades, video_fp, self.cfg.num_frames,
                self.frame_sample, start_sec=float(sample["t_start"]),
                end_sec=float(sample["t_end"]), pre_size=self.cfg.pre_size,
                rng=rng, backend=self.cfg.reader_backend)
            return {
                "frames": frames,
                "text": str(sample["narration"]),
                "target": np.int32(int(str(sample["cls"])[1:])),
            }
        target = np.zeros(NUM_CLASSES, np.int32)
        for a in self.label[sample["id"]]:
            target[int(a["class"][1:])] = 1
        frames = self._decode_or_black(
            read_frames_charades, video_fp, self.cfg.num_frames,
            self.frame_sample, pre_size=self.cfg.pre_size, rng=rng,
            backend=self.cfg.reader_backend)
        return {
            "frames": frames,
            "text": str(list(sample.values())[6]),
            "path": sample["id"] + ".mp4",
            "target": target,
        }
