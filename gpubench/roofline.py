"""The yardstick's arithmetic: an H100's peaks, the least time of each
hand-written kernel's work a launch, and a training step's model FLOPs.

Every count here comes from shapes alone, never from the program.

* ``attention_bound_ms``: K1 (space) and K2 (time) attention, forward and
  backward, on ``[B, f, n, D]`` patch projections plus the ``[B, 1, D]``
  CLS key and value.  Bytes: each input read once and each output written
  once (forward: q, k, v in, out out; backward: q, k, v, do in, dq, dk, dv
  out, and the CLS key and value in and their gradients out).  FLOPs: two
  products of ``[L, hd] x [hd, L + 1]`` size a group forward (logits,
  value sum), five backward (logits again, dv, dp, dq, dk).  The bound is
  the larger of bytes over HBM bandwidth and FLOPs over the dense bf16
  tensor rate.
* ``ln_bound_ms``: K3 LayerNorm over ``rows x D``: the forward reads x and
  writes y, the backward reads x and dy and writes dx (the float32
  parameters and row statistics are under 0.1% of it); against about 8
  (forward) or 15 (backward) float32 operations an element at the float32
  rate.
* ``ln_launches``: the K3 launches of one training step with their rows,
  from the towers' structure (the port's ``video_tower`` / ``text_tower``
  norm placement).
* ``step_flops``: the model FLOPs of one training step, forward plus
  backward (twice the forward, except the patch embedding, whose input
  takes no gradient), recompute not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12


def attention_bound_ms(kernel: str, B: int, f: int, n: int, D: int,
                       itemsize: int = 2) -> float:
    """Least time in ms of one K1 / K2 launch.  ``kernel``: one of
    ``space_fwd``, ``space_bwd``, ``time_fwd``, ``time_bwd``."""
    axis, direction = kernel.split("_")
    grid = B * f * n * D * itemsize
    cls = B * D * itemsize
    keys = n + 1 if axis == "space" else f + 1
    if direction == "fwd":
        nbytes, products = 4 * grid + 2 * cls, 2
    else:
        nbytes, products = 7 * grid + 4 * cls, 5
    flops = 2 * products * B * f * n * keys * D
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS) * 1e3


def ln_bound_ms(direction: str, rows: int, D: int,
                itemsize: int = 2) -> float:
    """Least time in ms of one K3 launch over ``rows x D`` (``direction``:
    ``fwd`` or ``bwd``)."""
    elems = rows * D
    fwd = direction == "fwd"
    t_bytes = (2 if fwd else 3) * elems * itemsize / PEAK_BYTES
    t_ops = (8 if fwd else 15) * elems / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3


def ln_launches(shape: dict) -> list:
    """``[(direction, rows, D)]``: the K3 launches of one training step.

    ``shape``: ``clips``, ``frames``, ``patches``, ``depth``, ``dim``,
    ``remat`` ('none' or 'block') of the video tower; ``texts``,
    ``tokens``, ``text_layers``, ``text_dim`` of the text tower.  A video
    block norms its CLS and patch rows in one launch each way, three times
    (norm3, norm1, norm2); the tower's last norm takes the CLS rows alone.
    The last block's norm2 gets no patch gradient (its patch output reaches
    no loss), so its backward runs over the CLS rows alone.  'block'
    recompute runs each block's three forward norms again.  The text tower
    norms its embeddings and twice a layer, forward and backward."""
    B, rows_p = shape["clips"], shape["clips"] * shape["frames"] * shape["patches"]
    D, depth = shape["dim"], shape["depth"]
    pair = rows_p + B
    fwd = [("fwd", pair, D)] * (3 * depth) + [("fwd", B, D)]
    if shape.get("remat", "none") == "block":
        fwd += [("fwd", pair, D)] * (3 * depth)
    bwd = ([("bwd", pair, D)] * (3 * depth - 1) + [("bwd", B, D)]
           + [("bwd", B, D)])
    text_rows = shape["texts"] * shape["tokens"]
    text = 1 + 2 * shape["text_layers"]
    fwd += [("fwd", text_rows, shape["text_dim"])] * text
    bwd += [("bwd", text_rows, shape["text_dim"])] * text
    return fwd + bwd


def video_forward_flops(frames: int, patches: int, depth: int, dim: int,
                        patch_size: int, mlp_ratio: float = 4.0,
                        proj_dim: int = 256) -> dict:
    """Forward FLOPs of one clip through the video tower and its
    projection: ``{'embed': ..., 'rest': ...}`` (the patch embedding apart,
    since its backward is half of the others')."""
    N = 1 + frames * patches
    hidden = int(dim * mlp_ratio)
    linear = 2 * N * dim * (2 * (3 * dim + dim) + 2 * hidden)
    time = 4 * frames * patches * (frames + 1) * dim + 4 * N * dim
    space = 4 * frames * patches * (patches + 1) * dim + 4 * N * dim
    embed = 2 * frames * patches * 3 * patch_size ** 2 * dim
    return {"embed": embed,
            "rest": depth * (linear + time + space) + 2 * dim * proj_dim}


def text_forward_flops(tokens: int, layers: int, dim: int, hidden: int,
                       proj_dim: int = 256) -> int:
    """Forward FLOPs of one caption through DistilBERT and its
    projection."""
    per_layer = (8 * tokens * dim * dim + 4 * tokens * dim * hidden
                 + 4 * tokens * tokens * dim)
    return layers * per_layer + 2 * dim * proj_dim


def step_flops(shape: dict) -> float:
    """Model FLOPs of one training step (recompute not counted)."""
    v = video_forward_flops(shape["frames"], shape["patches"], shape["depth"],
                            shape["dim"], shape["patch_size"],
                            shape.get("mlp_ratio", 4.0), shape["proj_dim"])
    t = text_forward_flops(shape["tokens"], shape["text_layers"],
                           shape["text_dim"], shape["text_hidden"],
                           shape["proj_dim"])
    return (shape["clips"] * (2 * v["embed"] + 3 * v["rest"])
            + shape["texts"] * 3 * t)
