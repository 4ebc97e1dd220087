"""Port divided attention vs the JAX package (float32, CPU).

The plain twins of the two CUDA kernels are held against the JAX Pallas
kernels run in interpret mode, and ``divided_attention_parts`` against the
JAX op on both axes.  Tolerance 1e-5: the same float32 math, summed in
another order.  The CUDA kernels themselves are held against these twins
in ``test_torch_cuda.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.divided_attention import (
    divided_attention_parts as jax_divided_attention_parts,
)
from egovlp_tpu.kernels.pallas_attention import (
    make_space_attention_bsd,
    make_time_attention_bsd,
)
from egovlp_tpu_torch.kernels import cuda_attention as ca
from egovlp_tpu_torch.kernels.divided_attention import divided_attention_parts

TOL = 1e-5


def _grid_inputs(seed, B, f, n, D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, f, n, D)).astype(np.float32)
               for _ in range(3))
    ck, cv = (rng.normal(size=(B, 1, D)).astype(np.float32) for _ in range(2))
    return q, k, v, ck, cv


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("f", [1, 4])
def test_plain_kernels_match_pallas_interpret(axis, f):
    B, n, D, H = 2, 6, 32, 2
    arrs = _grid_inputs(0, B, f, n, D)
    scale = float(D // H) ** -0.5
    make = make_space_attention_bsd if axis == "space" else make_time_attention_bsd
    want = np.asarray(jax.jit(make(H, scale))(*arrs))
    plain = (ca.space_attention_fwd_plain if axis == "space"
             else ca.time_attention_fwd_plain)
    got = plain(*(torch.from_numpy(a) for a in arrs), heads=H, scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("f", [1, 4])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_divided_attention_parts_matches_jax(axis, f, jax_impl):
    B, n, D, H = 2, 4, 32, 2
    rng = np.random.default_rng(1)
    qc, kc, vc = (rng.normal(size=(B, 1, D)).astype(np.float32)
                  for _ in range(3))
    qp, kp, vp = _grid_inputs(2, B, f, n, D)[:3]
    arrs = (qc, kc, vc, qp, kp, vp)
    wc, wp = jax.jit(functools.partial(
        jax_divided_attention_parts, heads=H, frames=f, patches=n, axis=axis,
        impl=jax_impl))(*arrs)
    for impl in ("pallas", "xla"):
        oc, op = divided_attention_parts(*(torch.from_numpy(a) for a in arrs),
                                         heads=H, axis=axis, impl=impl)
        assert op.shape == (B, f, n, D)
        np.testing.assert_allclose(oc.numpy(), np.asarray(wc), rtol=TOL,
                                   atol=TOL, err_msg=f"cls, impl={impl}")
        np.testing.assert_allclose(op.numpy(), np.asarray(wp), rtol=TOL,
                                   atol=TOL, err_msg=f"grid, impl={impl}")


@pytest.mark.parametrize("name", ["space_attention_fwd", "time_attention_fwd"])
def test_wrapper_on_cpu_runs_plain_and_counts_no_launch(name):
    arrs = [torch.from_numpy(a) for a in _grid_inputs(3, 1, 2, 5, 16)]
    ca.reset_launch_counts()
    got = getattr(ca, name)(*arrs, heads=2, scale=0.25)
    want = getattr(ca, f"{name}_plain")(*arrs, heads=2, scale=0.25)
    assert torch.equal(got, want)
    assert ca.launches[name] == 0


def test_wrapper_rejects_bad_inputs():
    q, k, v, ck, cv = (torch.from_numpy(a) for a in _grid_inputs(4, 1, 2, 5, 16))
    with pytest.raises(ValueError, match="shapes differ"):
        ca.space_attention_fwd(q, k[:, :1], v, ck, cv, heads=2, scale=1.0)
    with pytest.raises(ValueError, match="cls_k"):
        ca.time_attention_fwd(q, k, v, ck[:, :, :8], cv, heads=2, scale=1.0)
    with pytest.raises(TypeError, match="dtype"):
        ca.space_attention_fwd(q.double(), k.double(), v.double(),
                               ck.double(), cv.double(), heads=2, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ca.time_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, v, ck, cv, heads=2, scale=1.0)
    with pytest.raises(ValueError, match="divisible"):
        ca.space_attention_fwd(q, k, v, ck, cv, heads=3, scale=1.0)
