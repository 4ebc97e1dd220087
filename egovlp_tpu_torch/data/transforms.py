"""Video transforms on the device.

Counterpart of ``egovlp_tpu/data/transforms.py``.  The host decoder
delivers uint8 ``[B, T, pre, pre, 3]`` frames (short-side resize and
center crop to ``pre`` = 256):

* ``eval_resize`` (:161): bilinear resize to ``out_size`` and the ImageNet
  normalize;
* the train transform ``random_resized_crop_flip`` (:106-157), split in
  two so that a test can hand both packages the same boxes:
  ``sample_crop_boxes`` draws one crop box and one flip per clip from an
  explicit ``torch.Generator`` with the JAX package's clamped arithmetic
  (``_sample_crop_box``), and ``resized_crop_flip`` resamples each clip's
  box to ``out_size`` (flipped where asked) and normalizes.

Resampling is bilinear, align_corners=False, source coordinates clamped
into the frame (``_interp_weights`` :75), as two batched matmuls with
interpolation matrices.  The eval-time multi-crop helpers (:201-245)
``center_plus_four_crops``, ``center_plus_two_horizontal_crops`` and
``two_horizontal_crop`` cut static boxes out of ``[..., H, W, 3]``.
Channels stay last; the JAX package's channel-folded layout and its
``kron`` matrices were a TPU lane workaround.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _interp_weights(src_size: int, out_size: int, start, length,
                    device: "torch.device | str") -> torch.Tensor:
    """``[..., out, src]`` bilinear (align_corners=False) interpolation
    matrices for the windows ``[start, start + length)`` of a ``src_size``
    axis; ``start`` and ``length`` are floats or float32 tensors ``[...]``."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if torch.is_tensor(start):
        start, length = start[..., None], length[..., None]
    src = start + (i + 0.5) * (length / out_size) - 0.5
    src = src.clamp(0.0, src_size - 1.0)
    lo = src.floor()
    w_hi = (src - lo)[..., None]
    lo_i = lo.long().clamp(0, src_size - 1)[..., None]
    hi_i = (lo_i + 1).clamp_max(src_size - 1)
    j = torch.arange(src_size, device=device)
    return (j == lo_i) * (1.0 - w_hi) + (j == hi_i) * w_hi


def _to_float(frames: torch.Tensor) -> torch.Tensor:
    x = frames.float()
    return x / 255.0 if frames.dtype == torch.uint8 else x


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def eval_resize(frames: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """uint8 or float ``[B, T, H, W, 3]`` -> normalized float32
    ``[B, T, out_size, out_size, 3]`` on the same device."""
    x = _to_float(frames)
    H, W = x.shape[2:4]
    if (H, W) != (out_size, out_size):
        wy = _interp_weights(H, out_size, 0.0, float(H), x.device)
        wx = _interp_weights(W, out_size, 0.0, float(W), x.device)
        x = torch.einsum("yh,bthwc->btywc", wy, x)
        x = torch.einsum("xw,btywc->btyxc", wx, x)
    return _normalize(x)


def sample_crop_boxes(generator: torch.Generator, B: int, src: int,
                      scale: Tuple[float, float] = (0.5, 1.0),
                      ratio: Tuple[float, float] = (3 / 4, 4 / 3)):
    """torchvision-style random resized crop boxes on a ``src x src`` frame,
    one per clip, and one horizontal flip per clip.

    Area uniform in ``scale * src^2``, aspect log-uniform in ``ratio``,
    sides clamped into ``[8, src]`` and the box placed uniformly inside the
    frame (the JAX package's static version of the 10-attempt rejection
    loop).  Returns float32 ``boxes [B, 4]`` as ``(top, left, h, w)`` and
    bool ``flips [B]``, on the generator's device."""
    u = torch.rand(B, 5, generator=generator, device=generator.device)
    area = (scale[0] + u[:, 0] * (scale[1] - scale[0])) * src * src
    lo_r, hi_r = math.log(ratio[0]), math.log(ratio[1])
    r = torch.exp(lo_r + u[:, 1] * (hi_r - lo_r))
    w = torch.sqrt(area * r).clamp(8.0, float(src))
    h = torch.sqrt(area / r).clamp(8.0, float(src))
    top = u[:, 2] * (src - h)
    left = u[:, 3] * (src - w)
    return torch.stack([top, left, h, w], dim=1), u[:, 4] < 0.5


def resized_crop_flip(frames: torch.Tensor, boxes: torch.Tensor,
                      flips: torch.Tensor, out_size: int = 224
                      ) -> torch.Tensor:
    """uint8 or float ``[B, T, H, W, 3]``, boxes ``[B, 4]`` (top, left, h,
    w) and flips ``[B]`` -> normalized float32 ``[B, T, out, out, 3]``.
    One box per clip, shared by its frames; a flip reverses the output
    columns."""
    x = _to_float(frames)
    H, W = x.shape[2:4]
    boxes = boxes.to(x.device, torch.float32)
    top, left, h, w = boxes.unbind(dim=1)
    wy = _interp_weights(H, out_size, top, h, x.device)    # [B, out, H]
    wx = _interp_weights(W, out_size, left, w, x.device)   # [B, out, W]
    wx = torch.where(flips.to(x.device)[:, None, None], wx.flip(1), wx)
    x = torch.einsum("byh,bthwc->btywc", wy, x)
    x = torch.einsum("bxw,btywc->btyxc", wx, x)
    return _normalize(x)


def _crop(x: torch.Tensor, top: int, left: int, size: int) -> torch.Tensor:
    """The ``size x size`` box at (top, left) of ``[..., H, W, 3]``."""
    return x[..., top:top + size, left:left + size, :]


def center_plus_four_crops(frames: torch.Tensor,
                           crop_size: int) -> torch.Tensor:
    """``[..., H, W, 3]`` -> ``[5, ..., crop, crop, 3]``: the center crop,
    then the top-left, top-right, bottom-left and bottom-right corners."""
    H, W = frames.shape[-3:-1]
    boxes = [((H - crop_size) // 2, (W - crop_size) // 2), (0, 0),
             (0, W - crop_size), (H - crop_size, 0),
             (H - crop_size, W - crop_size)]
    return torch.stack([_crop(frames, t, l, crop_size) for t, l in boxes])


def center_plus_two_horizontal_crops(frames: torch.Tensor,
                                     crop_size: int) -> torch.Tensor:
    """``[..., H, W, 3]`` -> ``[3, ..., crop, crop, 3]``: the center, left
    and right crops, all vertically centered."""
    H, W = frames.shape[-3:-1]
    top = (H - crop_size) // 2
    boxes = [(top, (W - crop_size) // 2), (top, 0), (top, W - crop_size)]
    return torch.stack([_crop(frames, t, l, crop_size) for t, l in boxes])


def two_horizontal_crop(frames: torch.Tensor, crop_size: int,
                        index: int) -> torch.Tensor:
    """The reference's ``TwoHoriCrop``: the vertically centered left
    (``index`` 0) or right (1) ``crop x crop`` box of ``[..., H, W, 3]``."""
    H, W = frames.shape[-3:-1]
    left = 0 if index == 0 else W - crop_size
    return _crop(frames, (H - crop_size) // 2, left, crop_size)
