"""Conceptual Captions 3M image-text dataset (legacy).

Counterpart of ``egovlp_tpu/data/datasets/cc3m.py``: a tab-separated
metadata file under ``meta_dir`` (``extra['metadata_file']``, else
``cc3m_{train|val}.tsv``) whose first column is the caption and second
the image path under ``data_dir``, read with the standard library
(``table.read_table``); each image is a 1-frame clip (``read_image``).
Under ``loading='lax'`` an image that does not read gives a black frame.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.datasets.table import n_rows, read_table, row
from egovlp_tpu_torch.data.readers import read_image


class ConceptualCaptionsDataset(TextVideoDataset):
    def _load_metadata(self):
        split = "train" if self.cfg.split == "train" else "val"
        self.metadata = read_table(os.path.join(
            self.cfg.meta_dir,
            self.cfg.extra.get("metadata_file", f"cc3m_{split}.tsv")), "\t")

    def __len__(self):
        return n_rows(self.metadata)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        caption, path = list(row(self.metadata, idx % len(self)).values())[:2]
        try:
            frames = read_image(os.path.join(self.cfg.data_dir, str(path)),
                                self.cfg.pre_size)
        except OSError:  # the image does not read
            if self.cfg.loading == "strict":
                raise
            frames = np.zeros((1, self.cfg.pre_size, self.cfg.pre_size, 3),
                              np.uint8)
        return {"frames": frames, "text": str(caption)}
