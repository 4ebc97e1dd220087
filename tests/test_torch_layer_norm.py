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
  parameter gradients;
* the pair ``LayerNormPair`` (a CLS part and a patch part, one set of
  parameters) against two ``jax.vjp`` calls with their ``dscale`` and
  ``dbias`` added, at the same limits; a ``None`` gradient on one part's
  output against JAX's VJP with a zero cotangent there, the backward then
  running over the other part alone; it saves only the two parts, the
  scale and their ``[mu; rstd]``;
* a ``SpaceTimeBlock`` launches K3 once a norm (three pairs) each way,
  and the last block's dead patch ``norm2`` leaves its backward to the
  CLS rows (counted by the CPU twins the Functions and ops call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.kernels.fused_ln import fused_layer_norm as jax_fused_layer_norm
from egovlp_tpu_torch.kernels import cuda_attention
from torch.utils._python_dispatch import TorchDispatchMode

from egovlp_tpu_torch.kernels import fused_ln
from egovlp_tpu_torch.kernels.fused_ln import (
    FusedLayerNorm,
    LayerNorm,
    LayerNormPair,
    fused_layer_norm,
    fused_layer_norm_pair,
)
from egovlp_tpu_torch.models.video_tower import (
    SpaceTimeBlock,
    VideoTowerConfig,
)
from tests.test_torch_models import VIDEO

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


# --------------------------------------------------------------------------
# the CLS + patch pair
# --------------------------------------------------------------------------

# (CLS part, patch part): [B, 1, D] and [B, T, n, D] as the video tower
# has them, and a patch part of other rank
PAIRS = [((3, 1, 24), (3, 2, 5, 24)), ((2, 1, 64), (2, 4, 7, 64)),
         ((4, 96), (33, 96))]


def _pair_inputs(pair, seed):
    """xc, xp, scale, bias, dyc, dyp (numpy float32)."""
    xc, scale, bias, dyc = _inputs(pair[0], seed)
    xp, _, _, dyp = _inputs(pair[1], seed + 1)
    return xc, xp, scale, bias, dyc, dyp


def _jax_pair_vjp(xc, xp, scale, bias, dyc, dyp, eps, dtype):
    """JAX's two calls, one VJP each, their parameter grads added:
    ``[yc, yp, dxc, dxp, dscale, dbias]``."""
    yc, dxc, dsc, dbc = _jax_vjp(xc, scale, bias, dyc, eps, dtype)
    yp, dxp, dsp, dbp = _jax_vjp(xp, scale, bias, dyp, eps, dtype)
    return [yc, yp, dxc, dxp, dsc + dsp, dbc + dbp]


def _port_pair(xc, xp, scale, bias, dyc, dyp, eps, dtype):
    """``LayerNormPair`` forward and backward; ``dyc`` or ``dyp`` None
    leaves that output out of the backward (its input grad None)."""
    leaves = [torch.from_numpy(xc).to(dtype).requires_grad_(),
              torch.from_numpy(xp).to(dtype).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    yc, yp = fused_layer_norm_pair(*leaves, eps)
    assert yc.dtype == yp.dtype == dtype
    assert isinstance(yc.grad_fn, LayerNormPair._backward_cls)
    outs = [(y, torch.from_numpy(d).to(dtype))
            for y, d in ((yc, dyc), (yp, dyp)) if d is not None]
    grads = torch.autograd.grad([o for o, _ in outs], leaves,
                                [d for _, d in outs], allow_unused=True)
    return [yc.detach().float().numpy(), yp.detach().float().numpy(),
            *(None if g is None else g.float().numpy() for g in grads)]


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _assert_one_ulp(got, want, name):
    """bf16 outputs: each within one bf16 ulp of JAX's, 95% bit-equal (the
    module notes say why)."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert (np.abs(got - want) <= ulp).all(), name
    assert (got == want).mean() > 0.95, name


NAMES = ("yc", "yp", "dxc", "dxp", "dscale", "dbias")


@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("eps", [1e-6, 1e-12])
def test_layer_norm_pair_vjp_matches_jax_float32(pair, eps):
    args = _pair_inputs(pair, seed=pair[1][-1] + len(pair[1]))
    want = _jax_pair_vjp(*args, eps, jnp.float32)
    got = _port_pair(*args, eps, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("pair", PAIRS)
def test_layer_norm_pair_vjp_matches_jax_bf16(pair):
    xc, xp, scale, bias, dyc, dyp = _pair_inputs(pair, seed=11 + pair[1][-1])
    # bf16 inputs: both sides see the same rounded x and dy
    args = (_bf16(xc), _bf16(xp), scale, bias, _bf16(dyc), _bf16(dyp))
    want = _jax_pair_vjp(*args, 1e-6, jnp.bfloat16)
    got = _port_pair(*args, 1e-6, torch.bfloat16)
    for name, g, w in zip(NAMES[:4], got[:4], want[:4]):
        _assert_one_ulp(g, w, name)
    for name, g, w in zip(NAMES[4:], got[4:], want[4:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


class _BackwardCalls:
    """Counts the backward twins the Functions call (a CPU tensor's
    stand-in for K3-bwd's launches): single-segment and pair."""

    def __init__(self, monkeypatch):
        self.calls = {"single": 0, "pair": 0}
        for key, name in (("single", "_bwd_cpu"), ("pair", "_pair_bwd_cpu")):
            fn = getattr(fused_ln, name)

            def counted(*a, _fn=fn, _key=key):
                self.calls[_key] += 1
                return _fn(*a)

            monkeypatch.setattr(fused_ln, name, counted)


@pytest.mark.parametrize("dead", ["patch", "cls"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_pair_none_gradient_is_a_zero_cotangent(dead, dtype,
                                                           monkeypatch):
    """The part whose output reaches no loss: JAX's VJP with a zero
    cotangent there; the port's input grad for it is None and its backward
    launches once, over the other part's rows."""
    xc, xp, scale, bias, dyc, dyp = _pair_inputs(PAIRS[1], seed=5)
    if dtype == "bfloat16":
        xc, xp, dyc, dyp = map(_bf16, (xc, xp, dyc, dyp))
    zero = {"patch": (dyc, np.zeros_like(dyp)),
            "cls": (np.zeros_like(dyc), dyp)}[dead]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _jax_pair_vjp(xc, xp, scale, bias, *zero, 1e-6, jdt)
    calls = _BackwardCalls(monkeypatch)
    got = _port_pair(xc, xp, scale, bias, None if dead == "cls" else dyc,
                     None if dead == "patch" else dyp, 1e-6, tdt)
    assert calls.calls == {"single": 1, "pair": 0}
    live, gone = (2, 3) if dead == "patch" else (3, 2)
    assert got[gone] is None
    np.testing.assert_array_equal(want[gone], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5,
                                   atol=1e-5)
    else:
        _assert_one_ulp(got[live], want[live], NAMES[live])
    for i in (4, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-5,
                                   err_msg=NAMES[i])


def test_layer_norm_pair_saves_no_float32_rows():
    xc, xp, scale, bias, _, _ = _pair_inputs(PAIRS[0], 0)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    leaves = [torch.from_numpy(xc).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(xp).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fused_layer_norm_pair(*leaves)
    assert saved == [((3, 1, 24), torch.bfloat16),
                     ((3, 2, 5, 24), torch.bfloat16), ((24,), torch.float32),
                     ((2, 3, 1, 1), torch.float32),
                     ((2, 3, 2, 5, 1), torch.float32)]


def test_layer_norm_pair_op_is_the_function_forward():
    """Grad mode off takes the pair's op: the same outputs as the
    Function's forward."""
    xc, xp, scale, bias, _, _ = _pair_inputs(PAIRS[1], 2)
    args = [torch.from_numpy(a) for a in (xc, xp, scale, bias)]
    with torch.no_grad():
        off = fused_layer_norm_pair(*args)
    on = LayerNormPair.apply(*args, 1e-6)
    for a, b in zip(off, on):
        assert torch.equal(a, b.detach())


class _OpCalls(TorchDispatchMode):
    """Counts the K3 ops dispatched (the route with grad mode off)."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("egovlp_torch.layer_norm"):
            self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


class _ForwardCalls:
    """Counts the forward twins the Functions call: single and pair."""

    def __init__(self, monkeypatch):
        self.calls = {"single": 0, "pair": 0}
        for key, name in (("single", "_fwd_cpu"), ("pair", "_pair_fwd_cpu")):
            fn = getattr(fused_ln, name)

            def counted(*a, _fn=fn, _key=key):
                self.calls[_key] += 1
                return _fn(*a)

            monkeypatch.setattr(fused_ln, name, counted)


@pytest.mark.parametrize("remat", [False, "block", "attn_out"])
@pytest.mark.parametrize("patch_dead", [False, True])
def test_space_time_block_cpu_launch_counts(remat, patch_dead, monkeypatch):
    """One block: three pairs forward (six under 'block' recompute, which
    runs the body again in the backward) and three pairs backward; with
    the patch output dead (the tower's last block) the patch ``norm2``
    leaves its pair's backward to the CLS rows alone.  CPU tensors run
    the twins: no kernel launch is counted."""
    torch.manual_seed(0)
    blk = SpaceTimeBlock(VideoTowerConfig(**VIDEO, remat=remat)).train()
    xc = torch.randn(2, 1, 24, requires_grad=True)
    xp = torch.randn(2, 4, 4, 24, requires_grad=True)
    fwd, bwd = _ForwardCalls(monkeypatch), _BackwardCalls(monkeypatch)
    before = dict(cuda_attention.launches)
    oc, op = blk(xc, xp)
    assert fwd.calls == {"single": 0, "pair": 3}
    loss = oc.sum() if patch_dead else oc.sum() + (op * op).sum()
    loss.backward()
    assert fwd.calls == {"single": 0, "pair": 6 if remat == "block" else 3}
    assert bwd.calls == ({"single": 1, "pair": 2} if patch_dead
                         else {"single": 0, "pair": 3})
    assert all(p.grad is not None for p in blk.parameters())
    assert cuda_attention.launches == before
    # grad mode off: the pair's op, one a norm
    with torch.no_grad(), _OpCalls() as ops_seen:
        blk.eval()(xc, xp)
    assert ops_seen.calls == {"egovlp_torch.layer_norm_pair_fwd.default": 3}
