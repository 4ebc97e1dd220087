"""EgoClip pretraining and EgoMCQ evaluation datasets.

Counterpart of ``egovlp_tpu/data/datasets/egoclip.py``.

EgoClip (train): the tab-separated ``egoclip.csv`` of narrated clips.
Videos are stored as 600-second chunk files ``{video_uid}/{chunk}.mp4``.
Captions carry Ego4D taxonomy tags, made into noun (dim 582) and verb
(dim 118) one-hot vectors for the EgoNCE masks.  ``neg_param`` (seconds)
turns on scene-aware negatives: another narration of the same
``{video_uid}_{narration_time // neg_param}`` segment.

The csv is read with the standard library (``table.read_tsv``), as
``pandas.read_csv(sep='\\t', on_bad_lines='skip')`` reads it, each
column typed as pandas types it: the frame indices of a clip follow from
its times.  The segment groups hold row
positions in file order, so a scene negative drawn with ``rng.choice``
is the row the JAX package draws.

EgoMCQ (val/test): ``egomcq.json`` items with one text query, 5
candidate clips, the index of the correct one and the inter/intra
``types`` id.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.datasets.table import n_rows, read_tsv, row
from egovlp_tpu_torch.data.readers import CHUNK_SEC, read_frames_egoclip

NOUN_DIM = 582
VERB_DIM = 118


def _tag_vec(tag_str: str, dim: int) -> np.ndarray:
    """Parse '[1, 5]'-style taxonomy tags into a one-hot vector."""
    vec = np.zeros(dim, np.float32)
    try:
        ids = json.loads(tag_str) if isinstance(tag_str, str) else tag_str
    except (ValueError, TypeError):
        ids = []
    for i in np.atleast_1d(ids):
        i = int(i)
        if 0 <= i < dim:
            vec[i] = 1.0
    return vec


def _clip_paths(data_dir: str, sample):
    start = max(float(sample["clip_start"]), 0.0)
    end = max(float(sample["clip_end"]), 0.0)
    c0 = int(start // CHUNK_SEC)
    c1 = int(end // CHUNK_SEC)
    fp0 = os.path.join(data_dir, sample["video_uid"], f"{c0}.mp4")
    fp1 = os.path.join(data_dir, sample["video_uid"], f"{c1}.mp4")
    bound = (c0 + 1) * CHUNK_SEC
    return (fp0, fp1), (start, end), bound


def _read_clip(dataset: TextVideoDataset, sample, rng) -> np.ndarray:
    cfg = dataset.cfg
    (fp0, fp1), (start, end), bound = _clip_paths(cfg.data_dir, sample)
    return dataset._decode_or_black(
        read_frames_egoclip, fp0, fp1, cfg.num_frames, dataset.frame_sample,
        start, end, bound, pre_size=cfg.pre_size, rng=rng,
        backend=cfg.reader_backend)


class EgoClipDataset(TextVideoDataset):
    def _load_metadata(self):
        self.metadata = read_tsv(os.path.join(self.cfg.meta_dir,
                                              "egoclip.csv"))
        self._n = n_rows(self.metadata)
        if self.cfg.neg_param:
            groups: Dict[str, List[int]] = {}
            uids, times = (self.metadata["video_uid"],
                           self.metadata["narration_time"])
            self._segment_ids = []
            for i in range(self._n):
                key = f"{uids[i]}_{times[i] // self.cfg.neg_param}"
                self._segment_ids.append(key)
                groups.setdefault(key, []).append(i)
            self._segment_groups = {k: np.asarray(v, np.int64)
                                    for k, v in groups.items()}

    def __len__(self):
        return self._n

    def _row(self, idx: int) -> Dict[str, Any]:
        return row(self.metadata, idx)

    def _caption(self, sample):
        return (
            str(sample["clip_text"]),
            _tag_vec(sample["tag_noun"], NOUN_DIM),
            _tag_vec(sample["tag_verb"], VERB_DIM),
        )

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        idx = idx % self._n
        sample = self._row(idx)
        text, noun_vec, verb_vec = self._caption(sample)
        item = {
            "frames": _read_clip(self, sample, rng),
            "text": text,
            "noun_vec": noun_vec,
            "verb_vec": verb_vec,
        }
        if self.cfg.neg_param:
            group = self._segment_groups[self._segment_ids[idx]]
            neg = self._row(int(rng.choice(group)))
            text_n, noun_n, verb_n = self._caption(neg)
            item.update(
                frames_neg=_read_clip(self, neg, rng),
                text_neg=text_n,
                noun_vec_neg=noun_n,
                verb_vec_neg=verb_n,
            )
        return item


class EgoMCQDataset(TextVideoDataset):
    NUM_OPTIONS = 5

    def _load_metadata(self):
        path = os.path.join(self.cfg.meta_dir, "egomcq.json")
        with open(path) as f:
            self.metadata = json.load(f)
        self._keys = sorted(self.metadata.keys(), key=lambda k: int(k))

    def __len__(self):
        return len(self._keys)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        item = self.metadata[self._keys[idx % len(self._keys)]]
        query = str(item["query"]["clip_text"])
        options = item["choices"]
        videos = np.zeros(
            (self.NUM_OPTIONS, self.cfg.num_frames, self.cfg.pre_size,
             self.cfg.pre_size, 3), np.uint8,
        )
        # output slots follow the options' order in the file, but the
        # decode runs in (video, start) order, so that options in one chunk
        # read forward through the decoder instead of seeking back (the
        # val sampler is deterministic: the order cannot change the frames)
        keys = list(options.keys())
        texts = [str(options[k]["clip_text"]) for k in keys]
        decode_order = sorted(
            range(len(keys)),
            key=lambda i: (str(options[keys[i]]["video_uid"]),
                           float(options[keys[i]].get("clip_start", 0.0))),
        ) if self.frame_sample != "rand" else range(len(keys))
        for i in decode_order:
            videos[i] = _read_clip(self, options[keys[i]], rng)
        return {
            "frames_options": videos,
            "text": query,
            "text_options": texts,
            "correct": int(item["answer"]),
            "type": int(item["types"]),
        }
