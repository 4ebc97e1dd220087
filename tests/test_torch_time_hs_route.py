"""K5's choice of body, on CPU tensors.

``cuda_attention.time_hs_body`` picks the 16-byte streaming body where it
takes the inputs (f from 1 to 16, hd a multiple of the 8 bf16 or 4
float32 channels of a 16-byte slice and at most 32 slices, every tensor
on a 16-byte boundary) and the scalar body elsewhere; it reads only
shapes, dtypes and pointers, so it is held here without a card.
``time_hs_bwd_parts`` gives the backward's CLS scratch of each body.
"""

import pytest
import torch

from egovlp_tpu_torch.kernels import cuda_attention as ca

F32, BF16 = torch.float32, torch.bfloat16
STREAM, SCALAR = ca.TIME_HS_STREAM, ca.TIME_HS_SCALAR


def _tensor(shape, dtype, offset=0):
    """A contiguous tensor ``offset`` elements past a 64-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.zeros(n + 64, dtype=dtype)
    base = (-flat.data_ptr() % 64) // flat.element_size()
    return flat[base + offset:base + offset + n].view(shape)


def _inputs(dtype, f, hd, n=3, offsets=None):
    """q, k, v ``[2, f, n, hd]``, cls_k, cls_v ``[2, 1, hd]`` and do, each
    at its element offset in ``offsets``."""
    offsets = offsets or [0] * 6
    shapes = [(2, f, n, hd)] * 3 + [(2, 1, hd)] * 2 + [(2, f, n, hd)]
    return [_tensor(s, dtype, o) for s, o in zip(shapes, offsets)]


@pytest.mark.parametrize("dtype,f,hd,body", [
    (BF16, 16, 64, STREAM), (BF16, 17, 64, SCALAR),  # the most frames held
    (F32, 16, 64, STREAM), (F32, 17, 64, SCALAR),
    (BF16, 1, 64, STREAM), (F32, 1, 4, STREAM),
    (BF16, 4, 36, SCALAR), (F32, 4, 36, STREAM),     # whole 16-byte slices
    (F32, 4, 6, SCALAR), (BF16, 4, 8, STREAM),
    (BF16, 4, 256, STREAM), (BF16, 4, 264, SCALAR),  # 32 vs 33 slices
    (F32, 4, 128, STREAM), (F32, 4, 132, SCALAR)])
def test_time_hs_body_by_shape_and_dtype(dtype, f, hd, body):
    assert ca.time_hs_body(*_inputs(dtype, f, hd)) == body


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("i", range(6))
@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_time_hs_body_by_alignment(dtype, i, offset):
    # tensor i (q, k, v, cls_k, cls_v, do) `offset` elements past a
    # 64-byte boundary: streamed only at a whole 16 bytes
    offsets = [0] * 6
    offsets[i] = offset
    x = _inputs(dtype, 4, 64, offsets=offsets)
    aligned = offset * x[0].element_size() % 16 == 0
    assert x[i].is_contiguous()
    assert ca.time_hs_body(*x) == (STREAM if aligned else SCALAR)
    assert ca.time_hs_body(*x[:5]) == (STREAM if aligned or i == 5 else SCALAR)


@pytest.mark.parametrize("dtype,hd,n,parts", [
    (BF16, 64, 196, (2, 49, 64)),   # 8 lanes a head: 4 columns a warp
    (F32, 64, 196, (2, 98, 64)),    # 16 lanes: 2 columns
    (BF16, 128, 197, (2, 99, 128)),
    (F32, 128, 197, (2, 197, 128)),  # 32 lanes: 1 column
    (BF16, 96, 61, (2, 31, 96)),    # 12 slices in 16 lanes
    (BF16, 32, 1, (2, 1, 32))])     # 4 slices in 8 lanes
def test_time_hs_bwd_parts(dtype, hd, n, parts):
    # the streaming body: a row a warp; the scalar body: a row a column
    q = torch.zeros(2, 4, n, hd, dtype=dtype)
    assert ca.time_hs_bwd_parts(q, STREAM) == parts
    assert ca.time_hs_bwd_parts(q, SCALAR) == (2, n, hd)
