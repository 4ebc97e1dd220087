"""ctypes binding for the native decode runtime (``native/egodecode.cc``).

The port's own copy of the binding in ``egovlp_tpu/data/native.py``, for
what the readers use.  It loads the same shared library,
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
            _lib = lib
            return _lib
        return None


def available() -> bool:
    return _load() is not None


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
