"""Ego4D NLQ / MQ datasets of the dense feature extractor.

Counterpart of ``egovlp_tpu/data/datasets/nlq_mq.py`` (:25-96).
Metadata: ``nlq_{train,val,test_unannotated}.json`` (MQ:
``moments_*.json``) in ``meta_dir``, one row a clip of a video.
``subsample='video'``: an item is the clip's frames, decoded densely from
``{data_dir}/{video_uid}.mp4`` at ``FEATURE_FPS`` frames a second times
``num_frames`` (at least ``num_frames``), at the midpoints of equal
intervals of the clip's 30-fps frame span; ``cli.extract`` cuts them
into ``num_frames`` windows.  ``subsample='text'`` (NLQ only): an item a
non-empty language query.  MQ is video only.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.readers import open_video
from egovlp_tpu_torch.data.samplers import sample_frames_clips

FEATURE_FPS = 1.87  # dense sampling rate of the episodic-memory features


class Ego4DNLQDataset(TextVideoDataset):
    split_files = {
        "train": "nlq_train.json",
        "val": "nlq_val.json",
        "test": "nlq_test_unannotated.json",
    }

    def _load_metadata(self):
        if self.cfg.subsample not in ("video", "text"):
            raise ValueError("NLQ/MQ datasets require subsample='video' or "
                             f"'text', not {self.cfg.subsample!r}")
        path = os.path.join(self.cfg.meta_dir,
                            self.split_files[self.cfg.split])
        with open(path) as f:
            anno = json.load(f)
        rows = []
        for video in anno["videos"]:
            for clip in video["clips"]:
                base = {
                    "video_uid": video["video_uid"],
                    "clip_uid": clip["clip_uid"],
                    "video_start_sec": float(clip["video_start_sec"]),
                    "video_end_sec": float(clip["video_end_sec"]),
                }
                if self.cfg.subsample == "video":
                    rows.append(base)
                    continue
                for ann in clip.get("annotations", []):
                    for q in ann.get("language_queries", []):
                        if q.get("query"):
                            rows.append({**base, "query": q["query"]})
        self.metadata = rows

    def __len__(self):
        return len(self.metadata)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        sample = self.metadata[idx % len(self.metadata)]
        meta = {"video_uid": sample["video_uid"],
                "clip_uid": sample["clip_uid"]}
        if self.cfg.subsample == "text":
            return {"text": str(sample["query"]), "meta": meta}
        video_fp = os.path.join(self.cfg.data_dir,
                                sample["video_uid"] + ".mp4")
        start_f = sample["video_start_sec"] * 30
        end_f = sample["video_end_sec"] * 30
        n_dense = int((sample["video_end_sec"] - sample["video_start_sec"])
                      * FEATURE_FPS * self.cfg.num_frames)
        n_dense = max(n_dense, self.cfg.num_frames)
        with open_video(video_fp, self.cfg.reader_backend) as v:
            idxs = sample_frames_clips(int(start_f), int(end_f),
                                       max(v.frame_count, 1), n_dense)
            frames, _ = v.read_frames(idxs, self.cfg.pre_size)
        return {"frames": frames, "meta": meta}


class Ego4DMQDataset(Ego4DNLQDataset):
    split_files = {
        "train": "moments_train.json",
        "val": "moments_val.json",
        "test": "moments_test_unannotated.json",
    }

    def _load_metadata(self):
        self.cfg.subsample = "video"  # MQ is video only
        super()._load_metadata()
