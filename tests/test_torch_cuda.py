"""CUDA kernels vs their plain PyTorch twins, on a CUDA device only.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This file
imports neither jax nor the JAX package; on a machine without jax run it
without the suite's jax-based ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (same math, another summation order); bf16 2e-2
on unit-normal inputs (one bf16 rounding of the output, plus rounding
points that a different summation order can flip).
"""

import numpy as np
import pytest
import torch

from egovlp_tpu_torch.kernels import cuda_attention as ca


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(device, dtype, B, f, n, D, seed=0):
    rng = np.random.default_rng(seed)
    grid = [rng.normal(size=(B, f, n, D)) for _ in range(3)]
    cls = [rng.normal(size=(B, 1, D)) for _ in range(2)]
    return [torch.from_numpy(a).to(device, dtype) for a in grid + cls]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["space_attention_fwd", "time_attention_fwd"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,f,n,D,H", [(2, 4, 196, 768, 12),
                                       (1, 1, 61, 768, 12),
                                       (2, 16, 50, 768, 12),
                                       (3, 2, 7, 32, 2)])
def test_cuda_kernel_matches_plain(cuda_device, name, dtype, tol, B, f, n, D,
                                   H):
    x = _inputs(cuda_device, dtype, B, f, n, D)
    scale = float(D // H) ** -0.5
    ca.reset_launch_counts()
    got = getattr(ca, name)(*x, heads=H, scale=scale)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = getattr(ca, f"{name}_plain")(*x, heads=H, scale=scale)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_shapes_the_kernel_cannot_take(cuda_device):
    # time attention over 64 frames needs more shared memory than a block has
    x = _inputs(cuda_device, torch.float32, 1, 64, 2, 768)
    with pytest.raises(RuntimeError, match="launch failed"):
        ca.time_attention_fwd(*x, heads=12, scale=0.125)
