"""Eval-time video transform on the device.

Counterpart of ``eval_resize`` in ``egovlp_tpu/data/transforms.py`` (:161):
the host decoder delivers uint8 ``[B, T, pre, pre, 3]`` frames (short-side
resize and center crop to ``pre`` = 256); this is the final bilinear
resize to ``out_size`` (align_corners=False, source coordinates clamped
into the frame, :75) and the ImageNet normalize.  Channels stay last; the
JAX package's channel-folded layout was a TPU lane workaround.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _interp_weights(src_size: int, out_size: int,
                    device: "torch.device | str") -> torch.Tensor:
    """``[out, src]`` bilinear (align_corners=False) interpolation matrix."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    src = ((i + 0.5) * (src_size / out_size) - 0.5).clamp(0.0, src_size - 1.0)
    lo = src.floor()
    w_hi = (src - lo)[:, None]
    lo_i = lo.long().clamp(0, src_size - 1)[:, None]
    hi_i = (lo_i + 1).clamp_max(src_size - 1)
    j = torch.arange(src_size, device=device)[None, :]
    return (j == lo_i) * (1.0 - w_hi) + (j == hi_i) * w_hi


def eval_resize(frames: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """uint8 or float ``[B, T, H, W, 3]`` -> normalized float32
    ``[B, T, out_size, out_size, 3]`` on the same device."""
    x = frames.float()
    if frames.dtype == torch.uint8:
        x = x / 255.0
    H, W = x.shape[2:4]
    if (H, W) != (out_size, out_size):
        wy = _interp_weights(H, out_size, x.device)
        wx = _interp_weights(W, out_size, x.device)
        x = torch.einsum("yh,bthwc->btywc", wy, x)
        x = torch.einsum("xw,btywc->btyxc", wx, x)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std
