"""EPIC-Kitchens-100 multi-instance retrieval dataset.

Counterpart of ``egovlp_tpu/data/datasets/epic.py``.  Metadata:
``EPIC_100_retrieval_{train,test}.csv`` (clips; column 2 the frame
directory relative to ``data_dir``, columns 6 / 7 the start / stop frame,
column 8 the narration), the sentence csv beside it, and the graded
relevancy matrix ``relevancy/caption_relevancy_EPIC_100_retrieval_
{train,test}.pkl`` (``[clips, sentences]``).  The csvs are read with the
standard library (``table.read_table``), each column typed as pandas
types it; the pickle holds a numpy array.

Training draws the caption among the sentences whose relevancy to the
clip passes 0.1, with the item's numpy generator (``rng.choice``, the
draw the JAX package makes), and carries that relevancy as ``relation``,
the weight of the adaptive max-margin loss.  Test items carry their own
narration, ``relation`` 1 and ``item_t`` -1.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.datasets.table import n_rows, read_table
from egovlp_tpu_torch.data.readers import read_frames_epic

RELEVANCY_THRESHOLD = 0.1


class EpicMIRDataset(TextVideoDataset):
    def _load_metadata(self):
        name = "train" if self.cfg.split == "train" else "test"
        meta = self.cfg.meta_dir
        self.metadata = read_table(
            os.path.join(meta, f"EPIC_100_retrieval_{name}.csv"))
        self._columns = list(self.metadata.values())
        self._sentences = list(read_table(os.path.join(
            meta, f"EPIC_100_retrieval_{name}_sentence.csv")).values())[1]
        with open(os.path.join(
                meta, "relevancy",
                f"caption_relevancy_EPIC_100_retrieval_{name}.pkl"),
                "rb") as f:
            # the annotation release's own file
            self.relevancy_mat = pickle.load(f)

    def __len__(self):
        return n_rows(self.metadata)

    def _caption(self, idx: int, rng: np.random.Generator):
        """``(sentence, relevancy weight, sentence index)``."""
        narration = str(self._columns[8][idx])
        if self.cfg.split != "train":
            return narration, 1.0, -1
        positives = np.where(self.relevancy_mat[idx] > RELEVANCY_THRESHOLD)[0]
        if len(positives):
            pos = int(rng.choice(positives))
            if (pos < len(self._sentences)
                    and pos < self.relevancy_mat.shape[1]):
                return (str(self._sentences[pos]),
                        float(self.relevancy_mat[idx][pos]), pos)
        return narration, 1.0, 0

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        idx = idx % len(self)
        path = str(self._columns[2][idx])
        text, relation, tidx = self._caption(idx, rng)
        frames = self._decode_or_black(
            read_frames_epic, os.path.join(self.cfg.data_dir, path),
            int(self._columns[6][idx]), int(self._columns[7][idx]),
            self.cfg.num_frames, self.frame_sample,
            pre_size=self.cfg.pre_size, rng=rng)
        return {
            "frames": frames,
            "text": text,
            "path": path,
            "relation": np.float32(relation),
            "item_v": np.int32(idx),
            "item_t": np.int32(tidx),
        }
