"""The head-split divided-attention op of the port vs the JAX package (CPU).

* K4 and K5 through their autograd Functions (``GroupedAttention``,
  ``TimeAttentionHS``; the plain twins on a CPU tensor) against the JAX
  ``grouped_attention`` and ``time_attention`` custom_vjps (Pallas in
  interpret mode), forward and ``jax.vjp`` gradients.  Tolerances are
  ``atol = rtol``.  float32 1e-5: the same math, summed in another order.
  bf16 1e-2 for the forward and dq, dk, dv on unit-normal inputs (values
  up to ~12): both sides round at the same points, and the largest gap
  seen is 1.5e-8.  The CLS grads at bf16 differ by design on K4: the JAX
  wrapper rounds each group's share to bf16 and sums the G shares in bf16
  (``pallas_attention.py:139-152``), the port sums in float32 and rounds
  once; pinned at 5e-2 (largest gap seen 3.1e-2, two bf16 ulps of a value
  near 13, at 16 groups).  K5 is float32 throughout on both sides, so only
  summation order separates them.
* ``divided_attention`` (both axes, ``impl`` pallas and xla, f in {1, 4})
  and ``divided_attention_bsd`` against the JAX functions of the same
  ``impl``, forward and gradients of ``sum(out * cos(out))``, float32,
  tolerance 1e-5 (2e-5 on the gradients, which sum one more product).
* Each plain backward twin against ``torch.autograd.grad`` of its plain
  forward in float32, 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.divided_attention import (
    divided_attention as jax_divided_attention,
)
from egovlp_tpu.kernels.divided_attention import (
    divided_attention_bsd as jax_divided_attention_bsd,
)
from egovlp_tpu.kernels.pallas_attention import grouped_attention, time_attention
from egovlp_tpu_torch.kernels import cuda_attention as ca
from egovlp_tpu_torch.kernels import divided_attention as port_divided_attention
from egovlp_tpu_torch.kernels.divided_attention import divided_attention_bsd

GRAD_NAMES = ("dq", "dk", "dv", "dcls_k", "dcls_v")
JAX_FN = {"grouped": grouped_attention, "time": time_attention}
FUNCTION = {"grouped": ca.GroupedAttention, "time": ca.TimeAttentionHS}
PLAIN = {"grouped": (ca.grouped_attention_fwd_plain,
                     ca.grouped_attention_bwd_plain),
         "time": (ca.time_attention_hs_fwd_plain,
                  ca.time_attention_hs_bwd_plain)}
# (kernel, BH, G or f, L or n, hd): L 1 and a time-shaped K4 (L = f 4,
# G = n) included; K5 at f 1 and 4
SHAPES = [("grouped", 3, 2, 8, 16), ("grouped", 2, 5, 4, 16),
          ("grouped", 2, 1, 1, 16), ("grouped", 4, 16, 13, 16),
          ("time", 2, 1, 5, 16), ("time", 3, 4, 6, 16)]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 5e-2)}  # (all, K4 CLS)


def _head_split_inputs(seed, BH, G, L, hd):
    """q, k, v [BH, G, L, hd], cls_k, cls_v [BH, 1, hd] and a cotangent."""
    rng = np.random.default_rng(seed)
    grid = [rng.normal(size=(BH, G, L, hd)).astype(np.float32)
            for _ in range(4)]
    cls = [rng.normal(size=(BH, 1, hd)).astype(np.float32) for _ in range(2)]
    return (*grid[:3], *cls), grid[3]


@functools.lru_cache(maxsize=None)
def _jax_fwd_vjp(kernel: str):
    fn = JAX_FN[kernel]

    @jax.jit
    def run(q, k, v, ck, cv, do):
        out, vjp = jax.vjp(fn, q, k, v, ck, cv)
        return out, vjp(do)

    return run


@pytest.mark.parametrize("kernel,BH,G,L,hd", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_matches_jax_custom_vjp(kernel, BH, G, L, hd, dtype):
    arrs, do = _head_split_inputs(BH * 100 + G * 10 + L, BH, G, L, hd)
    want_out, want = _jax_fwd_vjp(kernel)(
        *(jnp.asarray(a, dtype) for a in (*arrs, do)))
    tdt = getattr(torch, dtype)
    xs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs]
    ca.reset_launch_counts()
    out = FUNCTION[kernel].apply(*xs)
    out.backward(torch.from_numpy(do).to(tdt))
    assert all(n == 0 for n in ca.launches.values())  # CPU: plain twins
    tol, cls_tol = TOL[dtype]

    def close(got, w, t, name):
        assert got.dtype == tdt and got.shape == w.shape, name
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=t, atol=t, err_msg=name)

    close(out, want_out, tol, "out")
    for name, x, w in zip(GRAD_NAMES, xs, want):
        t = cls_tol if kernel == "grouped" and name.startswith("dcls") else tol
        close(x.grad, w, t, name)


@pytest.mark.parametrize("kernel,BH,G,L,hd", SHAPES)
def test_plain_bwd_matches_autograd_of_plain_fwd(kernel, BH, G, L, hd):
    arrs, do = _head_split_inputs(7 + L, BH, G, L, hd)
    fwd, bwd = PLAIN[kernel]
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    want = torch.autograd.grad(fwd(*xs), xs, torch.from_numpy(do))
    got = bwd(*(torch.from_numpy(a) for a in (*arrs, do)))
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert g.shape == w.shape, name
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("name", ["grouped_attention_fwd",
                                  "grouped_attention_bwd",
                                  "time_attention_hs_fwd",
                                  "time_attention_hs_bwd"])
def test_wrapper_on_cpu_runs_plain_and_rejects_bad_inputs(name):
    arrs, do = _head_split_inputs(3, 2, 3, 5, 8)
    xs = [torch.from_numpy(a) for a in arrs]
    if name.endswith("bwd"):
        xs.append(torch.from_numpy(do))
    ca.reset_launch_counts()
    got = getattr(ca, name)(*xs)
    want = getattr(ca, f"{name}_plain")(*xs)
    for g, w in zip(*((got, want) if name.endswith("bwd")
                      else ((got,), (want,)))):
        assert torch.equal(g, w)
    assert ca.launches[name] == 0
    with pytest.raises(ValueError, match="cls_k"):
        getattr(ca, name)(xs[0], xs[1], xs[2], xs[3][:1], *xs[4:])
    with pytest.raises(ValueError, match="contiguous"):
        getattr(ca, name)(xs[0].transpose(2, 3).contiguous().transpose(2, 3),
                          *xs[1:])


def _split_inputs(seed, B, H, f, n, hd):
    rng = np.random.default_rng(seed)
    S = 1 + f * n
    return [rng.normal(size=(B, H, S, hd)).astype(np.float32)
            for _ in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_op_and_grad(axis, impl, f, n, heads=None):
    """jitted ``(out, grads of sum(out * cos(out)))`` of the JAX op:
    ``divided_attention`` (``heads=None``) or ``divided_attention_bsd``."""
    if heads is None:
        op = functools.partial(jax_divided_attention, frames=f, patches=n,
                               axis=axis, impl=impl)
    else:
        op = functools.partial(jax_divided_attention_bsd, heads=heads,
                               frames=f, patches=n, axis=axis, impl=impl)

    def loss(q, k, v):
        out = op(q, k, v)
        return jnp.sum(out * jnp.cos(out)), out

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))


def _port_op_and_grad(op, arrs):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = op(*xs)
    (out * torch.cos(out)).sum().backward()
    return out.detach(), [x.grad for x in xs]


def _assert_op_matches(got_out, got_grads, want_grads, want_out):
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5, err_msg="out")
    for name, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("f", [1, 4])
def test_divided_attention_matches_jax(axis, impl, f):
    B, H, n, hd = 2, 2, 5, 16
    arrs = _split_inputs(40 + f, B, H, f, n, hd)
    want_grads, want_out = _jax_op_and_grad(axis, impl, f, n)(*arrs)
    ca.reset_launch_counts()
    out, grads = _port_op_and_grad(functools.partial(
        port_divided_attention, frames=f, patches=n, axis=axis, impl=impl),
        arrs)
    assert out.shape == (B, H, 1 + f * n, hd)
    assert all(c == 0 for c in ca.launches.values())
    _assert_op_matches(out, grads, want_grads, want_out)


@pytest.mark.parametrize("axis", ["space", "time"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("f", [1, 4])
def test_divided_attention_bsd_matches_jax(axis, impl, f):
    B, H, n, hd = 2, 2, 5, 16
    arrs = [a.transpose(0, 2, 1, 3).reshape(B, 1 + f * n, H * hd).copy()
            for a in _split_inputs(50 + f, B, H, f, n, hd)]
    want_grads, want_out = _jax_op_and_grad(axis, impl, f, n, H)(*arrs)
    out, grads = _port_op_and_grad(functools.partial(
        divided_attention_bsd, heads=H, frames=f, patches=n, axis=axis,
        impl=impl), arrs)
    assert out.shape == (B, 1 + f * n, H * hd)
    _assert_op_matches(out, grads, want_grads, want_out)


def test_divided_attention_rejects_bad_arguments():
    q, k, v = (torch.from_numpy(a) for a in _split_inputs(5, 1, 2, 2, 3, 8))
    with pytest.raises(ValueError, match="axis"):
        port_divided_attention(q, k, v, frames=2, patches=3, axis="depth")
    with pytest.raises(ValueError, match="impl"):
        port_divided_attention(q, k, v, frames=2, patches=3, axis="space",
                               impl="xla2")
    with pytest.raises(ValueError, match="1 \\+ frames"):
        port_divided_attention(q, k, v, frames=3, patches=3, axis="space")
