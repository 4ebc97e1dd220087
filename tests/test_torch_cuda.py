"""CUDA kernels vs their plain PyTorch twins, on a CUDA device only.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This file
imports neither jax nor the JAX package; on a machine without jax run it
without the suite's jax-based ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 1e-4 (same math, another summation order); bf16 2e-2
for the forward kernels and 5e-2 for the backward kernels on unit-normal
inputs (one bf16 rounding of each output, plus rounding points that a
different summation order can flip; the backward rounds ``dl`` before two
more products).
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


def _inputs(device, dtype, B, f, n, D, seed=0, grad=False):
    """q, k, v, cls_k, cls_v (and do when ``grad``)."""
    rng = np.random.default_rng(seed)
    grid = [rng.normal(size=(B, f, n, D)) for _ in range(4 if grad else 3)]
    cls = [rng.normal(size=(B, 1, D)) for _ in range(2)]
    arrs = grid[:3] + cls + grid[3:]
    return [torch.from_numpy(a).to(device, dtype) for a in arrs]


SHAPES = [(2, 4, 196, 768, 12), (1, 1, 61, 768, 12), (2, 16, 50, 768, 12),
          (3, 2, 7, 32, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["space_attention_fwd", "time_attention_fwd"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,f,n,D,H", SHAPES)
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
@pytest.mark.parametrize("name", ["space_attention_bwd", "time_attention_bwd"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,f,n,D,H", SHAPES)
def test_cuda_bwd_kernel_matches_plain(cuda_device, name, dtype, tol, B, f, n,
                                       D, H):
    x = _inputs(cuda_device, dtype, B, f, n, D, seed=1, grad=True)
    scale = float(D // H) ** -0.5
    ca.reset_launch_counts()
    got = getattr(ca, name)(*x, heads=H, scale=scale)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = getattr(ca, f"{name}_plain")(*x, heads=H, scale=scale)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape, i
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["space", "time"])
def test_cuda_function_grads_match_autograd_of_plain(cuda_device, axis):
    x = _inputs(cuda_device, torch.float32, 2, 4, 196, 768, seed=2, grad=True)
    fn = ca.SpaceAttention if axis == "space" else ca.TimeAttention
    plain = getattr(ca, f"{axis}_attention_fwd_plain")

    def grads(run):
        xs = [t.clone().requires_grad_() for t in x[:5]]
        run(*xs).backward(x[5])
        return [t.grad for t in xs]

    ca.reset_launch_counts()
    got = grads(lambda *xs: fn.apply(*xs, 12, 0.125))
    assert ca.launches[f"{axis}_attention_fwd"] == 1
    assert ca.launches[f"{axis}_attention_bwd"] == 1
    want = grads(lambda *xs: plain(*xs, heads=12, scale=0.125))
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g - w).abs().max().item() <= 1e-4, i


@pytest.mark.cuda
@pytest.mark.parametrize("name,f,n", [("time_attention_fwd", 64, 2),
                                      ("time_attention_bwd", 32, 2),
                                      ("space_attention_fwd", 1, 450),
                                      ("space_attention_bwd", 1, 450)])
def test_cuda_wrapper_raises_on_shapes_the_kernel_cannot_take(cuda_device,
                                                              name, f, n):
    # more shared memory than the device lets one block opt in to
    x = _inputs(cuda_device, torch.float32, 1, f, n, 768,
                grad=name.endswith("bwd"))
    with pytest.raises(RuntimeError, match="launch failed"):
        getattr(ca, name)(*x, heads=12, scale=0.125)
