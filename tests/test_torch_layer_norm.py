"""K3, the port's LayerNorm Function (``kernels/fused_ln.py``), against
``jax.vjp`` of the JAX package's ``fused_layer_norm`` custom VJP (CPU; the
Function runs its kernels' plain twins on CPU tensors).

* float32: ``y``, ``dx``, ``dscale`` and ``dbias`` within rtol 1e-5 (the
  same formula; float32 sums in another order);
* bf16 inputs (float32 parameters): ``dscale`` and ``dbias`` are float32
  sums, rtol 1e-5; ``y`` and ``dx`` are rounded once to bf16 from float32
  values that agree to ~1e-6, so they are equal but where that difference
  straddles a rounding boundary: one bf16 ulp there (95% bit-equal);
* the Function saves only ``x``, ``scale`` and the float32 row statistics
  ``mu`` and ``rstd`` (``[..., 1]``): no float32 ``[rows, D]`` tensor;
* the tower's ``FusedLayerNorm`` module gives the same ``y`` and
  parameter gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.fused_ln import fused_layer_norm as jax_fused_layer_norm
from egovlp_tpu_torch.kernels import cuda_attention
from egovlp_tpu_torch.kernels.fused_ln import (
    FusedLayerNorm,
    LayerNorm,
    fused_layer_norm,
)

SHAPES = [(4, 7, 24), (2, 3, 5, 64), (32, 96)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    scale = (1 + 0.3 * rng.normal(size=D)).astype(np.float32)
    bias = rng.normal(size=D).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, scale, bias, dy


def _jax_vjp(x, scale, bias, dy, eps, dtype):
    def f(x, s, b):
        return jax_fused_layer_norm(x, s, b, eps)

    @jax.jit
    def run(x, s, b, dy):
        y, pull = jax.vjp(f, x, s, b)
        return (y, *pull(dy))

    x = jnp.asarray(x, dtype)
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in
            run(x, jnp.asarray(scale), jnp.asarray(bias),
                jnp.asarray(dy, dtype))]


def _port(x, scale, bias, dy, eps, dtype):
    x = torch.from_numpy(x).to(dtype).requires_grad_()
    s = torch.from_numpy(scale).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = fused_layer_norm(x, s, b, eps)
    assert y.dtype == dtype
    grads = torch.autograd.grad(y, (x, s, b), torch.from_numpy(dy).to(dtype))
    assert grads[0].dtype == dtype and grads[1].dtype == torch.float32
    return [t.float().numpy() for t in (y.detach(), *grads)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_layer_norm_vjp_matches_jax_float32(shape, eps):
    args = _inputs(shape, seed=len(shape) + shape[-1])
    want = _jax_vjp(*args, eps, jnp.float32)
    got = _port(*args, eps, torch.float32)
    for name, g, w in zip(("y", "dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_layer_norm_vjp_matches_jax_bf16(shape):
    args = _inputs(shape, seed=7 + shape[-1])
    # bf16 inputs: both sides see the same rounded x and dy
    x, scale, bias, dy = args
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    dy = np.asarray(jnp.asarray(dy, jnp.bfloat16), np.float32)
    want = _jax_vjp(x, scale, bias, dy, 1e-6, jnp.bfloat16)
    got = _port(x, scale, bias, dy, 1e-6, torch.bfloat16)
    for name, g, w in zip(("y", "dx"), got[:2], want[:2]):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w) + 1e-30)) - 7)
        assert (np.abs(g - w) <= ulp).all(), name
        assert (g == w).mean() > 0.95, name
    for name, g, w in zip(("dscale", "dbias"), got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_layer_norm_saves_only_x_scale_and_row_statistics():
    x, scale, bias, _ = _inputs((3, 5, 24), 0)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fused_layer_norm(xt, torch.from_numpy(scale).requires_grad_(),
                         torch.from_numpy(bias).requires_grad_())
    assert saved == [((3, 5, 24), torch.bfloat16), ((24,), torch.float32),
                     ((3, 5, 1), torch.float32), ((3, 5, 1), torch.float32)]


def test_fused_layer_norm_module_and_cpu_launch_counts():
    x, scale, bias, dy = _inputs((6, 24), 3)
    ln = FusedLayerNorm(24)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    before = dict(cuda_attention.launches)
    y = ln(torch.from_numpy(x))
    y.backward(torch.from_numpy(dy))
    want = _jax_vjp(x, scale, bias, dy, 1e-6, jnp.float32)
    np.testing.assert_allclose(y.detach().numpy(), want[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ln.weight.grad.numpy(), want[2], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ln.bias.grad.numpy(), want[3], rtol=1e-5,
                               atol=1e-5)
    assert isinstance(y.grad_fn, LayerNorm._backward_cls)
    # CPU tensors run the plain twins: no kernel launch is counted
    assert cuda_attention.launches == before
