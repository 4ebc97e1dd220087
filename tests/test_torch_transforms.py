"""Port eval transform vs the JAX one on uint8 frames (CPU).

Tolerance 1e-5: the same interpolation matrices in float32.
"""

import numpy as np
import pytest
import torch

from egovlp_tpu.data.transforms import eval_resize as jax_eval_resize
from egovlp_tpu_torch.data.transforms import eval_resize


@pytest.mark.parametrize("pre", [40, 32])
def test_eval_resize_matches_jax(pre):
    frames = np.random.default_rng(pre).integers(
        0, 256, (2, 3, pre, pre, 3)).astype(np.uint8)
    want = np.asarray(jax_eval_resize(frames, out_size=32)).reshape(
        2, 3, 32, 32, 3)
    got = eval_resize(torch.from_numpy(frames), out_size=32)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
