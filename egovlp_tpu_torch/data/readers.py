"""Host-side frame readers.

The port's own copy of ``egovlp_tpu/data/readers.py`` (:25-291) for the
embedding service and the EgoClip, EPIC-Kitchens and CharadesEgo
datasets: the OpenCV backend, the native decoder (``data/native.py``)
when its library is built, a small per-thread cache of open handles
(``acquire_video`` / ``release_video``), last-frame padding, the
whole-video reader, the EgoClip chunked reader, the EPIC JPEG-frame
reader, the CharadesEgo reader, the CC3M image reader ``read_image``
(:294) and the raw-resolution ``load_frames_from_video_path`` (:304).
Each dataset reader returns a FIXED ``[num_frames, pre, pre, 3]`` uint8 array
(short-side resized and center cropped) and the sampled indices.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

from egovlp_tpu_torch.data import native
from egovlp_tpu_torch.data.samplers import sample_frames, sample_frames_start_end

EGOCLIP_FPS = 30  # EgoClip chunks are 30 fps
CHUNK_SEC = 600   # 600-second chunk files


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


def acquire_video(path: str, backend: str = "auto"):
    """An open handle for ``path``, from this thread's cache when there is
    one, freshly opened otherwise.  Pair with ``release_video``."""
    if _CACHE_CAP <= 0:
        return open_video(path, backend)
    v = _cache_dict().pop((path, backend), None)
    return v if v is not None else open_video(path, backend)


def release_video(path: str, backend: str, video, ok: bool = True) -> None:
    """Return a handle to this thread's cache (least recently used evicted
    past the capacity); ``ok=False`` (a read raised: the decoder's state is
    suspect) closes it instead."""
    if _CACHE_CAP <= 0 or not ok:
        video.close()
        return
    d = _cache_dict()
    old = d.pop((path, backend), None)
    if old is not None and old is not video:
        old.close()  # a second handle on the same file: keep the newest
    d[(path, backend)] = video
    while len(d) > _CACHE_CAP:
        _, old = d.popitem(last=False)
        old.close()


class cached_video:
    """Context manager over ``acquire_video`` / ``release_video``."""

    def __init__(self, path: str, backend: str = "auto"):
        self.path, self.backend = path, backend
        self.video = acquire_video(path, backend)

    def __enter__(self):
        return self.video

    def __exit__(self, exc_type, *exc):
        release_video(self.path, self.backend, self.video,
                      ok=exc_type is None)
        return False


def get_video_len(path: str, backend: str = "auto") -> int:
    """The frame count of ``path``; 0 when it cannot be opened."""
    try:
        with cached_video(path, backend) as v:
            return v.frame_count
    except Exception:
        return 0


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


def read_frames_egoclip(video_path_1: str, video_path_2: str,
                        num_frames: int, sample: str,
                        start_sec: float, end_sec: float, bound_sec: float,
                        pre_size: int = 256,
                        rng: Optional[np.random.Generator] = None,
                        backend: str = "auto"):
    """EgoClip chunked reader: a clip may span two 600-s chunk files.  The
    global frame index is ``sec * 30``, the local one that index modulo
    the chunk length, clamped to the file's frame count; frames past
    ``bound_sec`` come from the second chunk."""
    start_f = max(0, int(start_sec * EGOCLIP_FPS))
    end_f = max(0, int(end_sec * EGOCLIP_FPS))
    bound_f = int(bound_sec * EGOCLIP_FPS)
    idxs = sample_frames_start_end(num_frames, start_f, end_f, sample=sample,
                                   rng=rng)

    same = video_path_1 == video_path_2
    ok = False
    v1 = acquire_video(video_path_1, backend)
    v2 = v1 if same else acquire_video(video_path_2, backend)
    try:
        chunk_len = CHUNK_SEC * EGOCLIP_FPS
        locals_1, locals_2, order = [], [], []
        for i, gidx in enumerate(idxs):
            lidx = gidx % chunk_len
            if gidx > bound_f:
                locals_2.append(min(lidx, max(v2.frame_count - 1, 0)))
                order.append((i, 2, len(locals_2) - 1))
            else:
                locals_1.append(min(lidx, max(v1.frame_count - 1, 0)))
                order.append((i, 1, len(locals_1) - 1))
        empty = (np.zeros((0, pre_size, pre_size, 3), np.uint8), 0)
        f1, _ = v1.read_frames(locals_1, pre_size) if locals_1 else empty
        f2, _ = v2.read_frames(locals_2, pre_size) if locals_2 else empty
        if not locals_2:
            out = f1  # the clip lies in one chunk: already in frame order
        else:
            out = np.zeros((len(idxs), pre_size, pre_size, 3), np.uint8)
            for i, which, j in order:
                out[i] = f1[j] if which == 1 else f2[j]
        ok = True
    finally:
        # back to this thread's cache (the item's scene negative mostly
        # reads the same chunk); a read that raised closes them
        release_video(video_path_1, backend, v1, ok=ok)
        if not same:
            release_video(video_path_2, backend, v2, ok=ok)
    return _pad_to(out, len(idxs), num_frames), idxs


def read_frames_epic(frame_dir: str, start_frame: int, stop_frame: int,
                     num_frames: int, sample: str = "rand",
                     fix_start: Optional[int] = None, pre_size: int = 256,
                     rng: Optional[np.random.Generator] = None):
    """EPIC-Kitchens pre-extracted JPEG frames, ``frame_%010d.jpg`` in
    ``frame_dir``; a frame that does not read stays black."""
    import cv2

    idxs = sample_frames_start_end(num_frames, start_frame, stop_frame,
                                   sample=sample, fix_start=fix_start, rng=rng)
    out = np.zeros((len(idxs), pre_size, pre_size, 3), np.uint8)
    for i, idx in enumerate(idxs):
        img = cv2.imread(os.path.join(frame_dir, f"frame_{int(idx):010d}.jpg"))
        if img is not None:
            out[i] = _resize_center_crop_cv2(img, pre_size)
    return _pad_to(out, len(idxs), num_frames), idxs


def read_frames_charades(video_path: str, num_frames: int, sample: str,
                         start_sec: Optional[float] = None,
                         end_sec: Optional[float] = None,
                         pre_size: int = 256,
                         rng: Optional[np.random.Generator] = None,
                         backend: str = "auto"):
    """CharadesEgo: the whole video, or the frames within optional
    second bounds scaled by the container's fps (30 when it reports
    none)."""
    with cached_video(video_path, backend) as v:
        if not start_sec and not end_sec:
            idxs = sample_frames(num_frames, max(v.frame_count, 1), sample,
                                 rng=rng)
        else:
            fps = v.fps or 30.0
            start_f = max(0, int(start_sec * fps))
            end_f = min(int(end_sec * fps), max(v.frame_count, 1))
            idxs = sample_frames_start_end(num_frames, start_f, end_f,
                                           sample=sample, rng=rng)
        frames, ok = v.read_frames(idxs, pre_size)
    return _pad_to(frames, ok, num_frames), idxs


def read_image(path: str, pre_size: int = 256) -> np.ndarray:
    """One image as a 1-frame clip (CC3M): uint8 ``[1, pre, pre, 3]``,
    short-side resized and center cropped."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image {path}")
    return _resize_center_crop_cv2(img, pre_size)[None]


def load_frames_from_video_path(path: str, num_frames: int,
                                sample: str = "rand",
                                rng: Optional[np.random.Generator] = None,
                                save_dir: Optional[str] = None,
                                ) -> Tuple[np.ndarray, List[int]]:
    """Frames at the video's own resolution (a demo and debug helper):
    ``sample_frames`` over the whole video, each frame read by a seek to
    its index, channel-last float32 ``[T, H, W, 3]`` in [0, 1] RGB, and the
    indices.  ``save_dir`` also writes each frame as ``{index}.jpg``.
    Raises ``IOError`` when the video does not open and ``ValueError``
    when a sampled frame does not decode."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cv2 cannot open {path}")
    try:
        vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if sample == "rand" and rng is None:
            rng = np.random.default_rng()
        frame_idxs = sample_frames(num_frames, vlen, sample, rng=rng)
        frames = []
        for index in frame_idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, index)
            ret, frame = cap.read()
            if not ret:
                raise ValueError(f"failed to decode frame {index} of {path}")
            if save_dir is not None:
                os.makedirs(save_dir, exist_ok=True)
                cv2.imwrite(os.path.join(save_dir, f"{index}.jpg"), frame)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        out = np.stack(frames).astype(np.float32) / 255.0
    finally:
        cap.release()
    return out, frame_idxs
