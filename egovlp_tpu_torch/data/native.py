"""ctypes binding for the native decode runtime (``native/egodecode.cc``).

The port's own copy of the binding in ``egovlp_tpu/data/native.py``: the
readers' ``NativeVideo``, the decoder's per-phase profile
(``decode_stats``) and the mpeg4 encoder that writes B-frame test clips
(``encode_video``).  It loads the same shared library,
``native/libegodecode.so`` at the repository root (built with
``make -C native``); where it is missing the readers use OpenCV.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native",
                 "libegodecode.so"),
    "libegodecode.so",
)

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        for p in _LIB_PATHS:
            try:
                lib = ctypes.CDLL(os.path.abspath(p) if os.path.sep in p else p)
            except OSError:
                continue
            lib.ed_open.restype = ctypes.c_void_p
            lib.ed_open.argtypes = [ctypes.c_char_p]
            lib.ed_close.argtypes = [ctypes.c_void_p]
            lib.ed_frame_count.restype = ctypes.c_int64
            lib.ed_frame_count.argtypes = [ctypes.c_void_p]
            lib.ed_fps.restype = ctypes.c_double
            lib.ed_fps.argtypes = [ctypes.c_void_p]
            lib.ed_width.restype = ctypes.c_int
            lib.ed_width.argtypes = [ctypes.c_void_p]
            lib.ed_height.restype = ctypes.c_int
            lib.ed_height.argtypes = [ctypes.c_void_p]
            lib.ed_read_frames.restype = ctypes.c_int
            lib.ed_read_frames.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            # the decode profile and the encoder (a library built from an
            # older egodecode.cc lacks them)
            if hasattr(lib, "ed_stats9"):
                lib.ed_stats9.argtypes = [ctypes.POINTER(ctypes.c_double)]
                lib.ed_stats9.restype = None
                lib.ed_stats_reset.argtypes = []
                lib.ed_stats_reset.restype = None
            if hasattr(lib, "ed_encode_video"):
                lib.ed_encode_video.restype = ctypes.c_int
                lib.ed_encode_video.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_double, ctypes.c_int, ctypes.c_int,
                ]
            _lib = lib
            return _lib
        return None


def available() -> bool:
    return _load() is not None


def decode_stats(reset: bool = False) -> dict:
    """The process-wide decode profile the library has accumulated since
    it was loaded or last reset (``reset`` resets it after the read):
    seconds in container open and probe, seek, codec decode and
    scale + crop, and the counts of opens, seeks, frames decoded, frames
    returned and frames skipped.  Empty without the library or its
    counters."""
    lib = _load()
    if lib is None or not hasattr(lib, "ed_stats9"):
        return {}
    buf = (ctypes.c_double * 9)()
    lib.ed_stats9(buf)
    if reset:
        lib.ed_stats_reset()
    return {
        "open_s": buf[0], "seek_s": buf[1], "decode_s": buf[2],
        "sws_s": buf[3], "n_open": int(buf[4]), "n_seek": int(buf[5]),
        "n_frames_decoded": int(buf[6]), "n_frames_out": int(buf[7]),
        "n_frames_skipped": int(buf[8]),
    }


def encode_video(path: str, frames: np.ndarray, fps: float = 30.0,
                 gop: int = 12, max_b_frames: int = 0) -> bool:
    """Encode uint8 RGB frames ``[n, h, w, 3]`` to an mpeg4 ``.mp4`` with
    a keyframe every ``gop`` frames and up to ``max_b_frames`` B-frames in
    a row: the way to write reordered streams for tests (OpenCV's writer
    emits no B-frames).  Raises ValueError on another shape; returns
    False without the library or its encoder."""
    lib = _load()
    if lib is None or not hasattr(lib, "ed_encode_video"):
        return False
    arr = np.ascontiguousarray(frames, np.uint8)
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"frames must be [n, h, w, 3], got {arr.shape}")
    n, h, w, _ = arr.shape
    rc = lib.ed_encode_video(
        str(path).encode(), arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, w, h, float(fps), int(gop), int(max_b_frames))
    return rc == 0


class NativeVideo:
    """Random-access frame extraction from one video file."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libegodecode.so not available; "
                               "build with `make -C native`")
        self._lib = lib
        self._h = lib.ed_open(path.encode())
        if not self._h:
            raise IOError(f"egodecode: cannot open {path}")

    @property
    def frame_count(self) -> int:
        return int(self._lib.ed_frame_count(self._h))

    @property
    def fps(self) -> float:
        return float(self._lib.ed_fps(self._h))

    @property
    def width(self) -> int:
        return int(self._lib.ed_width(self._h))

    @property
    def height(self) -> int:
        return int(self._lib.ed_height(self._h))

    def read_frames(self, indices: Sequence[int], pre_size: int = 256
                    ) -> tuple[np.ndarray, int]:
        """Decode frames at ``indices`` -> (uint8 [n, pre, pre, 3], n_ok).
        Short-side resize and center crop happen inside the decoder."""
        idx = np.asarray(indices, np.int64)
        out = np.empty((len(idx), pre_size, pre_size, 3), np.uint8)
        n_ok = self._lib.ed_read_frames(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx),
            pre_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out, int(n_ok)

    def close(self):
        if self._h:
            self._lib.ed_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
