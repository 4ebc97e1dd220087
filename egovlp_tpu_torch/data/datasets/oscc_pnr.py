"""Ego4D hands-and-objects state-change datasets (OSCC and PNR).

Counterpart of ``egovlp_tpu/data/datasets/oscc_pnr.py`` (:38-176).
Metadata: ``fho_oscc-pnr_{train,val}.json`` in ``meta_dir`` (its
``clips``; any split but ``train`` reads ``val``), ``max_samples``
cutting it.  Frames: pre-extracted JPEGs ``{dir}/{unique_id}/
{frame}.jpeg``, where ``dir`` is ``frames_jpeg`` for a state-change clip
and ``frames_jpeg_neg`` otherwise (``extra.clips_dir`` / ``no_sc_dir``
override them), read with OpenCV, short-side resized and center cropped.
An item is 16 frames of the 8-s clip at 2 fps.

Reference quirks the JAX package keeps, kept here:
  * a keyframe at frame 0 counts as no keyframe (``if pnr``), so such a
    clip reads from the negatives' directory, gets the ``dists`` labels
    and keeps the widened-bounds rule off;
  * train draws a random 5-8 s sub-clip and widens its bounds to the
    parent clip's when the keyframe falls outside;
  * frames are picked by the lower / upper stride-modulo scheme
    (``sample_state_change_frames``);
  * ``fps = clip_frames / clip_len`` with an inclusive frame count;
  * a clip without a keyframe is labelled with the ``dists`` list (all
    zeros), not a one-hot;
  * PNR keeps the state-change clips alone.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from egovlp_tpu_torch.data.datasets.base import TextVideoDataset
from egovlp_tpu_torch.data.readers import _resize_center_crop_cv2

SAMPLING_FPS = 2
CLIP_LEN_SEC = 8
NUM_FRAMES = SAMPLING_FPS * CLIP_LEN_SEC  # 16
VIDEO_FPS = 30


def sample_state_change_frames(start_frame: int, end_frame: int,
                               num_required: int,
                               pnr_frame: Optional[int]
                               ) -> Tuple[List[int], List[float]]:
    """The frames of ``[start_frame, end_frame)`` whose index divides by
    ``floor`` or ``ceil(len / num_required)``, the sparser ``ceil`` stride
    when it yields enough, and each one's distance to the keyframe (0
    without one)."""
    num_frames = end_frame - start_frame
    if num_frames < num_required:
        raise ValueError(f"cannot sample {num_required} frames from "
                         f"[{start_frame}, {end_frame})")
    lower = int(np.floor(num_frames / num_required))
    upper = int(np.ceil(num_frames / num_required))
    lower_frames, upper_frames = [], []
    lower_dist, upper_dist = [], []
    for fc in range(start_frame, end_frame):
        d = abs(fc - pnr_frame) if pnr_frame else 0.0
        if fc % lower == 0:
            lower_frames.append(fc)
            lower_dist.append(d)
        if fc % upper == 0:
            upper_frames.append(fc)
            upper_dist.append(d)
    if len(upper_frames) < num_required:
        return lower_frames[:num_required], lower_dist[:num_required]
    return upper_frames[:num_required], upper_dist[:num_required]


class Ego4DOSCCDataset(TextVideoDataset):
    keep_only_state_change = False

    def _load_metadata(self):
        split = "train" if self.cfg.split == "train" else "val"
        path = os.path.join(self.cfg.meta_dir, f"fho_oscc-pnr_{split}.json")
        with open(path) as f:
            clips = json.load(f)["clips"]
        if self.cfg.max_samples:
            clips = clips[: self.cfg.max_samples]
        self.clips_dir = self.cfg.extra.get(
            "clips_dir", os.path.join(self.cfg.data_dir, "frames_jpeg"))
        self.no_sc_dir = self.cfg.extra.get(
            "no_sc_dir", os.path.join(self.cfg.data_dir, "frames_jpeg_neg"))
        self.metadata = []
        for c in clips:
            state = 1 if c.get("state_change") else 0
            if self.keep_only_state_change and state != 1:
                continue
            self.metadata.append({
                "unique_id": c["unique_id"],
                "state": state,
                "pnr_frame": c.get("parent_pnr_frame") if state else None,
                "parent_start_sec": c["parent_start_sec"],
                "parent_end_sec": c["parent_end_sec"],
                "parent_start_frame": c["parent_start_frame"],
                "parent_end_frame": c["parent_end_frame"],
            })

    def __len__(self):
        return len(self.metadata)

    def _clip_bounds(self, info, rng: np.random.Generator):
        pnr = info["pnr_frame"]
        if self.cfg.split == "train":
            length = rng.uniform(5, CLIP_LEN_SEC)
            start_sec = info["parent_start_sec"] + rng.uniform(
                0, CLIP_LEN_SEC - length)
            start_f = int(np.floor(start_sec * VIDEO_FPS))
            end_sec = min(start_sec + length, info["parent_end_sec"])
            end_f = int(np.floor(end_sec * VIDEO_FPS))
            if pnr:
                if pnr > end_f:
                    end_f = info["parent_end_frame"]
                if pnr < start_f:
                    start_f = info["parent_start_frame"]
            return start_f, end_f
        return info["parent_start_frame"], info["parent_end_frame"]

    def _load_jpeg(self, path: str) -> Optional[np.ndarray]:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            return None
        return _resize_center_crop_cv2(img, self.cfg.pre_size)

    def get(self, idx: int, rng: np.random.Generator) -> Dict[str, Any]:
        info = self.metadata[idx % len(self.metadata)]
        pnr = info["pnr_frame"]
        clip_dir = os.path.join(self.clips_dir if pnr else self.no_sc_dir,
                                info["unique_id"])
        start_f, end_f = self._clip_bounds(info, rng)
        frame_nums, dists = sample_state_change_frames(start_f, end_f,
                                                       NUM_FRAMES, pnr)
        pre = self.cfg.pre_size
        frames = np.zeros((NUM_FRAMES, pre, pre, 3), np.uint8)
        last = None
        for i, fn in enumerate(frame_nums):
            img = self._load_jpeg(os.path.join(clip_dir, f"{fn}.jpeg"))
            if img is None:
                if self.cfg.loading == "strict":
                    raise ValueError(f"missing frame {fn} in {clip_dir}")
                img = last if last is not None else frames[0]
            frames[i] = img
            last = img

        if pnr:
            labels = np.zeros(NUM_FRAMES, np.float32)
            labels[int(np.argmin(dists))] = 1.0
        else:
            labels = np.asarray(dists, np.float32)
        clip_len = info["parent_end_sec"] - info["parent_start_sec"]
        clip_frames = (info["parent_end_frame"]
                       - info["parent_start_frame"] + 1)
        return {
            "frames": frames,
            "labels": labels,
            "state": np.int32(info["state"]),
            "fps": np.float32(clip_frames / clip_len),
            "parent_start_frame": np.int32(info["parent_start_frame"]),
            "parent_end_frame": np.int32(info["parent_end_frame"]),
            "parent_pnr_frame": np.int32(pnr or 0),
            "unique_id": info["unique_id"],
        }


class Ego4DPNRDataset(Ego4DOSCCDataset):
    """PNR keyframe localisation: the state-change clips alone."""

    keep_only_state_change = True
