"""Host-side frame reader for the embedding service.

The port's own copy of what ``read_frames`` needs from
``egovlp_tpu/data/readers.py`` (:33-195): the OpenCV backend, the native
decoder (``data/native.py``) when its library is built, a small
per-thread cache of open handles, and last-frame padding.  The reader
returns a FIXED ``[num_frames, pre, pre, 3]`` uint8 array (short-side
resized and center cropped) and the sampled indices.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from egovlp_tpu_torch.data import native
from egovlp_tpu_torch.data.samplers import sample_frames


def _resize_center_crop_cv2(frame_bgr: np.ndarray, pre: int) -> np.ndarray:
    import cv2

    h, w = frame_bgr.shape[:2]
    if w <= h:
        sw, sh = pre, int(h * pre / w)
    else:
        sh, sw = pre, int(w * pre / h)
    img = cv2.resize(frame_bgr, (sw, sh), interpolation=cv2.INTER_LINEAR)
    y0, x0 = (sh - pre) // 2, (sw - pre) // 2
    img = img[y0:y0 + pre, x0:x0 + pre]
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class _Cv2Video:
    def __init__(self, path: str):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cv2 cannot open {path}")
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS))

    def read_frames(self, indices, pre_size=256):
        import cv2

        out = np.zeros((len(indices), pre_size, pre_size, 3), np.uint8)
        ok = 0
        last = None
        for i, idx in enumerate(indices):
            idx = int(np.clip(idx, 0, max(self.frame_count - 1, 0)))
            # the reference seeks to index - 1, then reads
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, max(idx - 1, 0))
            ret, frame = self.cap.read()
            if ret:
                last = _resize_center_crop_cv2(frame, pre_size)
                out[i] = last
                ok += 1
            elif last is not None:
                out[i] = last
        return out, ok

    def close(self):
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_video(path: str, backend: str = "auto"):
    if backend in ("auto", "native") and native.available():
        try:
            return native.NativeVideo(path)
        except Exception:
            if backend == "native":
                raise
    return _Cv2Video(path)


# Per-thread LRU of open decoders: container open and stream probe are a
# large share of a clip's decode time.  EGOVLP_READER_CACHE sets the
# capacity (0 disables).
_CACHE_CAP = int(os.environ.get("EGOVLP_READER_CACHE", "4"))
_tls = threading.local()


def _cache_dict() -> OrderedDict:
    d = getattr(_tls, "videos", None)
    if d is None:
        d = _tls.videos = OrderedDict()
    return d


class cached_video:
    """Context manager over an open handle from this thread's cache;
    a handle whose read raised is closed, not cached."""

    def __init__(self, path: str, backend: str = "auto"):
        self.key = (path, backend)
        v = _cache_dict().pop(self.key, None) if _CACHE_CAP > 0 else None
        self.video = v if v is not None else open_video(path, backend)

    def __enter__(self):
        return self.video

    def __exit__(self, exc_type, *exc):
        if _CACHE_CAP <= 0 or exc_type is not None:
            self.video.close()
            return False
        d = _cache_dict()
        old = d.pop(self.key, None)
        if old is not None and old is not self.video:
            old.close()  # a second handle on the same file: keep the newest
        d[self.key] = self.video
        while len(d) > _CACHE_CAP:
            _, old = d.popitem(last=False)
            old.close()
        return False


def _pad_to(frames: np.ndarray, valid: int, num_frames: int) -> np.ndarray:
    """Repeat the last valid frame up to num_frames (static shape)."""
    if valid == 0:
        return np.zeros((num_frames,) + frames.shape[1:], np.uint8)
    if frames.shape[0] == num_frames and valid == num_frames:
        return frames
    out = np.zeros((num_frames,) + frames.shape[1:], np.uint8)
    n = min(valid, num_frames)
    out[:n] = frames[:n]
    out[n:] = frames[n - 1]
    return out


def read_frames(video_path: str, num_frames: int, sample: str = "rand",
                fix_start: Optional[int] = None, pre_size: int = 256,
                rng: Optional[np.random.Generator] = None,
                backend: str = "auto") -> Tuple[np.ndarray, List[int]]:
    """Whole-video reader: ``num_frames`` sampled frames, padded."""
    with cached_video(video_path, backend) as v:
        idxs = sample_frames(num_frames, max(v.frame_count, 1), sample,
                             fix_start=fix_start, rng=rng)
        frames, ok = v.read_frames(idxs, pre_size)
    return _pad_to(frames, ok, num_frames), idxs
