"""Frame-index samplers (pure functions).

The port's own copy of ``sample_frames``, ``sample_frames_start_end``
and ``sample_frames_clips`` from ``egovlp_tpu/data/samplers.py``.  The
clip is divided into ``num_frames`` equal intervals; ``'rand'`` picks a
random index inside each, ``'uniform'`` the midpoint.  Quirks kept for parity with the
reference:

* the random pick excludes the last index of each interval;
* ``sample_frames_start_end`` clamps the frame count by
  ``min(num_frames, end)``, the END frame index, not the span length;
* an empty interval falls back to its lower boundary.

Randomness is an explicit numpy ``Generator``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _intervals(start: float, stop: float, n: int) -> np.ndarray:
    return np.linspace(start=start, stop=stop, num=n + 1).astype(int)


def _pick(lo: int, hi: int, sample: str, fix_start: Optional[int],
          rng: Optional[np.random.Generator]) -> int:
    """An index in [lo, hi], where hi = next_boundary - 1."""
    if fix_start is not None:
        return lo + int(fix_start)
    if sample == "rand":
        if hi <= lo:
            return lo
        if rng is None:
            raise ValueError("rand sampling requires an rng")
        return int(rng.integers(lo, hi))  # excludes hi, like the reference
    if sample == "uniform":
        return (lo + hi) // 2
    raise NotImplementedError(sample)


def sample_frames(num_frames: int, vlen: int, sample: str = "rand",
                  fix_start: Optional[int] = None,
                  rng: Optional[np.random.Generator] = None) -> List[int]:
    """Up to ``num_frames`` indices from a video of ``vlen`` frames."""
    acc = min(num_frames, vlen)
    iv = _intervals(0, vlen, acc)
    return [_pick(iv[i], iv[i + 1] - 1, sample, fix_start, rng)
            for i in range(acc)]


def sample_frames_start_end(num_frames: int, start: int, end: int,
                            sample: str = "rand",
                            fix_start: Optional[int] = None,
                            rng: Optional[np.random.Generator] = None
                            ) -> List[int]:
    """Indices within the [start, end] frame bounds."""
    acc = min(num_frames, end)  # reference quirk: min with the END index
    iv = _intervals(start, end, acc)
    return [_pick(iv[i], iv[i + 1] - 1, sample, fix_start, rng)
            for i in range(acc)]


def sample_frames_clips(start: int, end: int, vlen: int,
                        acc_samples: int) -> List[int]:
    """The midpoints of ``acc_samples`` equal intervals of ``[start,
    end]`` clamped to the video (the NLQ/MQ dense windows)."""
    start = max(0, start)
    end = min(vlen, end)
    iv = _intervals(start, end, int(acc_samples))
    return [(iv[i] + iv[i + 1] - 1) // 2 for i in range(int(acc_samples))]
