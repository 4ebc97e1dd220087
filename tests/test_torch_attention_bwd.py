"""Gradients of the port's divided attention vs the JAX package (CPU).

* The plain backward twins of the two CUDA backward kernels against
  ``jax.vjp`` of ``make_space_attention_bsd`` / ``make_time_attention_bsd``
  (Pallas in interpret mode).  float32 tolerance 1e-5: the same math,
  summed in another order.  bf16 tolerance 6e-2 on unit-normal inputs,
  gradients up to ~5 in size (largest gap seen: 3.1e-2, one bf16 ulp at
  that size).  The space side rounds ``q * scale * log2(e)`` in JAX and
  ``q * scale`` in the port (the forward kernel's rounding point), which
  moves the rounded ``dl`` by an ulp, and JAX casts every frame's share of
  the CLS grads to bf16 before summing them, where the port sums in
  float32 and rounds once.  The time side rounds once per output on both
  sides (the default JAX bodies at f <= 8 and f = 16 sum in float32 and
  cast once per n-block; the port's one n-block is the whole n), so its
  bf16 gap is summation order only.  The JAX small-f body
  ``_time_bwd_small_f``, which adds into bf16 outputs frame by frame, is
  not on the default path.
* The autograd Functions on CPU tensors against autograd through the plain
  forward twins.
* ``divided_attention_parts`` and ``fused_layer_norm`` gradients against
  ``jax.grad`` of the JAX ops.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.divided_attention import (
    divided_attention_parts as jax_divided_attention_parts,
)
from egovlp_tpu.kernels.fused_ln import fused_layer_norm as jax_fused_layer_norm
from egovlp_tpu.kernels.pallas_attention import (
    make_space_attention_bsd,
    make_time_attention_bsd,
)
from egovlp_tpu_torch.kernels import cuda_attention as ca
from egovlp_tpu_torch.kernels.divided_attention import divided_attention_parts
from egovlp_tpu_torch.kernels.fused_ln import fused_layer_norm

B, N, D, H = 2, 5, 32, 2
SCALE = float(D // H) ** -0.5
MAKE = {"space": make_space_attention_bsd, "time": make_time_attention_bsd}
GRAD_NAMES = ("dq", "dk", "dv", "dcls_k", "dcls_v")


def _inputs(seed, f, n=N):
    rng = np.random.default_rng(seed)
    grid = [rng.normal(size=(B, f, n, D)).astype(np.float32) for _ in range(4)]
    cls = [rng.normal(size=(B, 1, D)).astype(np.float32) for _ in range(2)]
    q, k, v, do = grid
    return (q, k, v, *cls), do


@functools.lru_cache(maxsize=None)
def _jax_vjp(axis: str):
    fn = MAKE[axis](H, SCALE)

    @jax.jit
    def vjp(q, k, v, ck, cv, do):
        return jax.vjp(fn, q, k, v, ck, cv)[1](do)

    return vjp


def _jax_grads(axis, arrs, do, dtype):
    xs = [jnp.asarray(a, dtype) for a in (*arrs, do)]
    return [np.asarray(g.astype(jnp.float32)) for g in _jax_vjp(axis)(*xs)]


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("f", [1, 4, 16])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 6e-2)])
def test_plain_bwd_matches_jax_vjp(axis, f, dtype, tol):
    arrs, do = _inputs(f, f)
    want = _jax_grads(axis, arrs, do, dtype)
    tdt = getattr(torch, dtype)
    plain = getattr(ca, f"{axis}_attention_bwd_plain")
    got = plain(*(torch.from_numpy(a).to(tdt) for a in (*arrs, do)),
                heads=H, scale=SCALE)
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.dtype == tdt and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("f", [1, 4])
def test_function_grads_match_autograd_of_plain_forward(axis, f):
    arrs, do = _inputs(10 + f, f)
    fn = ca.SpaceAttention if axis == "space" else ca.TimeAttention
    plain = getattr(ca, f"{axis}_attention_fwd_plain")
    ca.reset_launch_counts()

    def grads(run):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
        out = run(*xs)
        out.backward(torch.from_numpy(do))
        return out.detach(), [x.grad for x in xs]

    out, got = grads(lambda *xs: fn.apply(*xs, H, SCALE))
    want_out, want = grads(lambda *xs: plain(*xs, heads=H, scale=SCALE))
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for name, g, w in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)
    assert all(n == 0 for n in ca.launches.values())  # CPU: plain twins


@pytest.mark.parametrize("name", ["space_attention_bwd", "time_attention_bwd"])
def test_bwd_wrapper_on_cpu_runs_plain_and_rejects_bad_do(name):
    arrs, do = _inputs(20, 2)
    xs = [torch.from_numpy(a) for a in (*arrs, do)]
    ca.reset_launch_counts()
    got = getattr(ca, name)(*xs, heads=H, scale=SCALE)
    want = getattr(ca, f"{name}_plain")(*xs, heads=H, scale=SCALE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ca.launches[name] == 0
    with pytest.raises(ValueError, match="shapes differ"):
        getattr(ca, name)(*xs[:5], xs[5][:, :1].contiguous(), heads=H,
                          scale=SCALE)
    with pytest.raises(TypeError, match="dtype"):
        getattr(ca, name)(*xs[:5], xs[5].double(), heads=H, scale=SCALE)


@functools.lru_cache(maxsize=None)
def _jax_parts_grad(axis, impl, f, n):
    def loss(arrs, w_c, w_p):
        oc, op = jax_divided_attention_parts(*arrs, heads=H, frames=f,
                                             patches=n, axis=axis, impl=impl)
        return jnp.sum(oc * w_c) + jnp.sum(op * w_p)

    return jax.jit(jax.grad(loss))


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("f", [1, 4, 16])
@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_divided_attention_parts_grads_match_jax(axis, f, jax_impl):
    n = 4
    rng = np.random.default_rng(30 + f)
    cls = [rng.normal(size=(B, 1, D)).astype(np.float32) for _ in range(3)]
    grid = [rng.normal(size=(B, f, n, D)).astype(np.float32) for _ in range(3)]
    w_c = rng.normal(size=(B, 1, D)).astype(np.float32)
    w_p = rng.normal(size=(B, f, n, D)).astype(np.float32)
    arrs = (*cls, *grid)
    want = _jax_parts_grad(axis, jax_impl, f, n)(arrs, w_c, w_p)
    for impl in ("pallas", "xla"):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
        oc, op = divided_attention_parts(*xs, heads=H, axis=axis, impl=impl)
        ((oc * torch.from_numpy(w_c)).sum()
         + (op * torch.from_numpy(w_p)).sum()).backward()
        for i, (x, w) in enumerate(zip(xs, want)):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"input {i}, impl={impl}")


@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_fused_layer_norm_grads_match_jax_vjp(eps):
    rng = np.random.default_rng(40)
    x = (rng.normal(size=(3, 5, 24)) * 3 + 1.5).astype(np.float32)
    scale = rng.normal(size=24).astype(np.float32)
    bias = rng.normal(size=24).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    want = jax.jit(lambda *a: jax.vjp(
        lambda x_, s_, b_: jax_fused_layer_norm(x_, s_, b_, eps), *a[:3]
    )[1](a[3]))(x, scale, bias, dy)
    xs = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    fused_layer_norm(*xs, eps).backward(torch.from_numpy(dy))
    for name, t, w in zip(("dx", "dscale", "dbias"), xs, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
