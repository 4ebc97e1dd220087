"""The MLP's bias add + exact GELU (K7, ``kernels/bias_gelu.py``).

CPU cases (the plain twins and the autograd Function over them):

* the forward twin equals ``precision.gelu(precision.linear(...))`` bit
  for bit in bf16 and float32, with and without a bias;
* the backward twin's ``dy``, against float64 autograd of the exact-erf
  GELU at the same rounded ``h``, is no worse than the bf16 autograd chain
  of the PyTorch ops it replaces (it rounds once where the chain rounds at
  every op: 1.9e-3 against 2.4e-3 relative L2), its bias gradient within
  two bf16 roundings as the chain's is, and in float32 both equal the
  chain's within float32 rounding;
* the bias gradient is the rows' float32 sum of the rounded ``dy``,
  rounded to the dtype and back to float32;
* ``Mlp`` and ``FFN``: the same output as the PyTorch ops' chain (bit for
  bit) and the same gradients (float32: within rounding; bf16: within the
  chain's own rounding), and the video tower under remat ``'none'``,
  ``'mlp'`` and ``'block'`` gives the loss and gradients of the chain, the
  recompute modes bit-equal to ``'none'``;
* the Function saves one hidden-sized tensor where the chain saves three.

CUDA cases (marker ``cuda``; skip without a card; this file imports
neither jax nor the JAX package, so on the card run it as
``python -m pytest --noconftest -m cuda tests/test_torch_bias_gelu.py``):
the kernel forward equals the PyTorch ops bit for bit at widths 3072 and
4096 with row counts that are not a multiple of a chunk's, and on every
one of the 65,536 bf16 values; the backward matches the twin run on the
card (dy within one bf16 rounding, the bias gradient within one more);
the backward's chunks of rows balance its grid; each call launches once; the wrapper raises on a non-contiguous input and
on a width that is not a multiple of 8.
"""

import math

import numpy as np
import pytest
import torch

from egovlp_tpu_torch.core import precision
from egovlp_tpu_torch.kernels import bias_gelu as bg
from egovlp_tpu_torch.kernels import cuda_attention as ca
from egovlp_tpu_torch.models import video_tower
from egovlp_tpu_torch.models.text_tower import FFN, TextTowerConfig
from egovlp_tpu_torch.models.video_tower import (
    SpaceTimeTransformer,
    VideoTowerConfig,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dtype, rows=37, width=40, seed=0, device="cpu"):
    """x [rows, 24], w [width, 24] (float32), b [width], dg [rows, width]."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, 24, generator=g).to(dtype)
    w = torch.randn(width, 24, generator=g) * 0.5
    b = torch.randn(width, generator=g)
    dg = torch.randn(rows, width, generator=g).to(dtype)
    return tuple(t.to(device) for t in (x, w, b, dg))


def _chain(y, b):
    """The PyTorch ops K7 replaces: ``Linear``'s bias add and ``gelu``."""
    return precision.gelu(y if b is None else y + b.to(y.dtype))


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


# --------------------------------------------------------------------------
# the plain twins
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_twin_is_the_chain(dtype, bias):
    x, w, b, _ = _inputs(DTYPES[dtype])
    want = precision.gelu(precision.linear(x, w, b if bias else None))
    y = torch.nn.functional.linear(x, w.to(x.dtype))
    got = bg.bias_gelu_fwd_plain(y, b if bias else None)
    assert got.dtype == want.dtype and torch.equal(got, want)


def _grads(fn, y, b, dg):
    y = y.detach().requires_grad_()
    b = None if b is None else b.detach().requires_grad_()
    fn(y, b).backward(dg)
    return y.grad, None if b is None else b.grad


def _exact_grads(y, b, dg):
    """float64 autograd of the exact-erf GELU at the rounded h."""
    h = (y if b is None else y + b.to(y.dtype)).double().requires_grad_()
    (0.5 * h * torch.special.erfc(-h * math.sqrt(0.5))).backward(dg.double())
    rows = tuple(range(h.dim() - 1))
    return h.grad, h.grad.sum(dim=rows)


@pytest.mark.parametrize("bias", [True, False])
def test_backward_twin_no_worse_than_the_chain(bias):
    # 4096 values a column: the bias gradient's rounding averages out
    x, w, b, dg = _inputs(torch.bfloat16, rows=4096, width=64, seed=1)
    y = torch.nn.functional.linear(x, w.to(x.dtype))
    b = b if bias else None
    dy_ref, db_ref = _exact_grads(y, b, dg)
    dy_chain, db_chain = _grads(_chain, y, b, dg)
    dy, db = bg.bias_gelu_bwd_plain(dg, y, b)
    assert dy.dtype == torch.bfloat16
    err, err_chain = _rel(dy, dy_ref), _rel(dy_chain, dy_ref)
    # one rounding of each value: about 2^-9 relative; the chain's many
    # roundings read more
    assert err <= err_chain and err < 2.5e-3, (err, err_chain)
    if bias:
        # both end in one bf16 rounding of the sum, which the rows' dy
        # roundings join: 2.4e-3 to 3.7e-3 read on both sides
        assert db.dtype == torch.float32
        assert _rel(db, db_ref) < 2 ** -7 and _rel(db_chain, db_ref) < 2 ** -7


@pytest.mark.parametrize("bias", [True, False])
def test_backward_twin_float32_is_the_chain(bias):
    x, w, b, dg = _inputs(torch.float32, seed=2)
    y = torch.nn.functional.linear(x, w)
    b = b if bias else None
    dy_chain, db_chain = _grads(_chain, y, b, dg)
    dy, db = bg.bias_gelu_bwd_plain(dg, y, b)
    torch.testing.assert_close(dy, dy_chain, rtol=1e-6, atol=1e-6)
    if bias:
        torch.testing.assert_close(db, db_chain, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_gradient_rounding(dtype):
    x, w, b, dg = _inputs(DTYPES[dtype], rows=3 * 5, seed=3)
    y = torch.nn.functional.linear(x, w.to(x.dtype)).reshape(3, 5, -1)
    dy, db = bg.bias_gelu_bwd_plain(dg.reshape(3, 5, -1), y, b)
    want = dy.float().sum(dim=(0, 1)).to(DTYPES[dtype]).float()
    assert db.dtype == torch.float32 and torch.equal(db, want)
    # and the Function returns it as the bias's gradient
    assert torch.equal(_grads(bg.bias_gelu, y, b, dg.reshape(3, 5, -1))[1],
                       db)


def test_function_saves_one_hidden_tensor():
    x, w, b, dg = _inputs(torch.bfloat16, rows=16, width=40)
    y = torch.nn.functional.linear(x, w.to(x.dtype)).requires_grad_()
    bb = b.clone().requires_grad_()

    def hidden_saved(fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(y, bb)
        return sizes.count(y.numel())

    assert hidden_saved(bg.bias_gelu) == 1  # y
    assert hidden_saved(_chain) == 3  # c, a and e


def test_grad_off_calls_the_op():
    _, _, b, dg = _inputs(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(bg.bias_gelu(dg, b), bg.bias_gelu_fwd(dg, b))
    assert ca.launches["bias_gelu_fwd"] == 0  # CPU: the twin


# --------------------------------------------------------------------------
# the MLP, the FFN and the video tower
# --------------------------------------------------------------------------

def _old_mlp(self, x):
    return self.fc2(precision.gelu(self.fc1(x)))


def _old_ffn(self, x):
    return self.lin2(precision.gelu(self.lin1(x)))


def _module_grads(module, x, w):
    module.zero_grad()
    x = x.detach().requires_grad_()
    out = module(x)
    (out.float() * w).sum().backward()
    grads = {k: p.grad.clone() for k, p in module.named_parameters()}
    return out.detach(), x.grad, grads


# (float32: the same math rounded otherwise; bf16: the chain rounds dy at
# each of its ops, K7 once, so the input gradient moves by ~2^-8 relative)
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["mlp", "ffn"])
def test_mlp_and_ffn_match_the_chain(kind, dtype, monkeypatch):
    torch.manual_seed(4)
    dt = DTYPES[dtype]
    if kind == "mlp":
        module, old = video_tower.Mlp(24, 96), (video_tower.Mlp, _old_mlp)
    else:
        module, old = FFN(TextTowerConfig(dim=24, hidden_dim=96)), (FFN,
                                                                     _old_ffn)
    x = torch.randn(2, 5, 24).to(dt)
    w = torch.randn(2, 5, 24)
    out, dx, grads = _module_grads(module, x, w)
    with monkeypatch.context() as m:
        m.setattr(old[0], "forward", old[1])
        out_old, dx_old, grads_old = _module_grads(module, x, w)
    assert torch.equal(out, out_old)
    assert _rel(dx, dx_old) < GRAD_TOL[dtype]
    for k in grads:
        assert _rel(grads[k], grads_old[k]) < GRAD_TOL[dtype], k


def _tower(remat, dtype):
    torch.manual_seed(5)
    cfg = VideoTowerConfig(img_size=32, patch_size=16, embed_dim=24, depth=2,
                           num_heads=2, num_frames=2, time_init="random",
                           remat=remat)
    return SpaceTimeTransformer(cfg, dtype=dtype).train()


def _tower_grads(model):
    video = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, 2, 32, 32, 3)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 24)).astype(np.float32))
    loss = (model(video).float() * w).sum()
    loss.backward()
    return loss.detach(), {k: p.grad.clone()
                           for k, p in model.named_parameters()
                           if p.grad is not None}


@pytest.mark.parametrize("dtype", DTYPES)
def test_tower_remat_modes_match_the_chain(dtype, monkeypatch):
    dt = DTYPES[dtype]
    with monkeypatch.context() as m:
        m.setattr(video_tower.Mlp, "forward", _old_mlp)
        loss_old, grads_old = _tower_grads(_tower("none", dt))
    loss, grads = _tower_grads(_tower("none", dt))
    assert torch.equal(loss, loss_old)
    for k in grads_old:
        assert _rel(grads[k], grads_old[k]) < GRAD_TOL[dtype], k
    for remat in ("mlp", "block"):
        loss_r, grads_r = _tower_grads(_tower(remat, dt))
        assert torch.equal(loss_r, loss), remat
        assert all(torch.equal(grads_r[k], grads[k]) for k in grads), remat


# --------------------------------------------------------------------------
# the kernels, on the card
# --------------------------------------------------------------------------

SHAPES = [(2883, 3072), (1001, 4096)]  # rows not a multiple of a chunk's


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", SHAPES)
def test_kernel_forward_is_the_ops(cuda_device, rows, width, dtype, bias):
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(rows)
    y = torch.randn(rows, width, device=cuda_device, generator=g).to(dt) * 2
    b = torch.randn(width, device=cuda_device, generator=g) if bias else None
    ca.reset_launch_counts()
    got = bg.bias_gelu_fwd(y, b)
    torch.cuda.synchronize()
    assert ca.launches["bias_gelu_fwd"] == 1
    assert torch.equal(got, _chain(y, b))


@pytest.mark.cuda
def test_kernel_forward_on_every_bf16_value(cuda_device):
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    y = bits.view(torch.bfloat16).reshape(-1, 64).to(cuda_device)
    for b in (None, torch.zeros(64, device=cuda_device)):
        got, want = bg.bias_gelu_fwd(y, b), _chain(y, b)
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan], want[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,width", SHAPES)
def test_kernel_backward_matches_the_twin(cuda_device, rows, width, dtype,
                                          bias):
    dt = DTYPES[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(rows + 1)
    y = torch.randn(rows, width, device=cuda_device, generator=g).to(dt) * 2
    dg = torch.randn(rows, width, device=cuda_device, generator=g).to(dt)
    b = torch.randn(width, device=cuda_device, generator=g) if bias else None
    ca.reset_launch_counts()
    dy, db = bg.bias_gelu_bwd(dg, y, b)
    torch.cuda.synchronize()
    assert ca.launches["bias_gelu_bwd"] == 1
    dy_twin, db_twin = bg.bias_gelu_bwd_plain(dg, y, b)
    # the same float32 slope; exp on the card's two routes may differ in
    # its last bit, which moves a rounded dy by one bf16 step at most
    ulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
    assert ((dy.float() - dy_twin.float()).abs()
            <= ulp * dy_twin.float().abs() + 1e-30).all()
    if bias:
        # another float32 summation order, then one more rounding
        torch.testing.assert_close(db, db_twin, rtol=2 * ulp, atol=1e-3)
    else:
        assert db is None


@pytest.mark.cuda
def test_backward_chunks_balance_the_grid(cuda_device):
    """K7-bwd's chunks (its own choice, asked through
    ``egovlp_bias_gelu_bwd_chunks``): at the cells' shapes its work items
    (slabs of 32 16-byte vectors x chunks) are a multiple of its persistent
    grid of 2 blocks an SM, so every block walks as many; a few rows take
    one chunk."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    index = cuda_device.index or 0
    for rows, width in ((75264, 4096), (75264, 3072), (50176, 3072),
                        (2880, 3072), (50176, 2048)):
        chunks = bg._bwd_chunks(rows, width, torch.bfloat16, index)
        slabs = -(-width // (8 * 32))
        assert (slabs * chunks) % (2 * sms) == 0, (rows, width, chunks)
    assert bg._bwd_chunks(40, 4096, torch.bfloat16, index) == 1
    with pytest.raises(RuntimeError, match="chunks"):
        bg._bwd_chunks(64, 60, torch.bfloat16, index)


@pytest.mark.cuda
def test_function_launches_once_each_way(cuda_device):
    y = torch.randn(64, 3072, device=cuda_device).bfloat16().requires_grad_()
    b = torch.randn(3072, device=cuda_device).requires_grad_()
    ca.reset_launch_counts()
    g = bg.bias_gelu(y, b)
    assert ca.launches["bias_gelu_fwd"] == 1
    g.float().sum().backward()
    assert ca.launches["bias_gelu_bwd"] == 1
    assert y.grad.dtype == torch.bfloat16 and b.grad.dtype == torch.float32


@pytest.mark.cuda
def test_wrapper_refuses(cuda_device):
    y = torch.randn(16, 64, device=cuda_device).bfloat16()
    b = torch.randn(64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        bg.bias_gelu_fwd(y.t(), torch.randn(16, device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 8"):
        bg.bias_gelu_fwd(y[:, :60].contiguous(), b[:60])
    with pytest.raises(ValueError, match="multiple of 8"):
        bg.bias_gelu_bwd(y[:, :60].contiguous(), y[:, :60].contiguous(),
                         None)
