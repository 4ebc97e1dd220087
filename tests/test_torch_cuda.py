"""CUDA kernels vs their plain PyTorch twins, on a CUDA device only.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false.  This file
imports neither jax nor the JAX package; on a machine without jax run it
without the suite's jax-based ``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

At bf16 K1 and K4, forward and backward, run on the tensor cores
(``csrc/attention_fwd_mma.cuh``, ``csrc/attention_bwd_mma.cuh``); their
float32 launches keep the scalar bodies.  K2, forward and backward, is a
16-byte streaming body at both dtypes (``csrc/time_attention_stream.cuh``)
that computes in float32 and casts once, as its twin does: its bf16
outputs too stay within relative L2 1e-3 of the twin.  K5 runs the same
streaming body where it takes the shape and its scalar body elsewhere
(``cuda_attention.time_hs_body``); both compute in float32 and cast once,
and are held to relative L2 1e-3 at bf16 too.

Tolerances: float32 1e-4 (same math, another summation order); bf16 2e-2
for the forward kernels and 5e-2 for the backward kernels on unit-normal
inputs (one bf16 rounding of each output, plus rounding points that a
different summation order can flip; the backward rounds ``dl`` before two
more products).  The bf16 tensor-core kernels (K1-fwd, K1-bwd, K4-fwd,
K4-bwd) also keep every output within relative L2 1e-3 of the twin: they
round where the twin rounds and read ~1e-4, while a kernel that rounds at
another point reads 2e-3 to 4e-3: K1 rounding ``q * scale`` and taking
``exp``, as it once did, or K4-bwd taking dV from ``round(p)`` instead of
the float32 p.  The head-split backward kernels (K4, K5) take q already
scaled and do not multiply dq by the scale, so their gradients run ~8x
larger (up to ~30, where one bf16 ulp is 0.125): bf16 max abs 2.5e-1 for
them.
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


HEAD_SPLIT = ("grouped_attention", "time_attention_hs")
TENSOR_CORE_BWD = ("space_attention_bwd", "grouped_attention_bwd")


def _inputs(device, dtype, B, f, n, D, seed=0, grad=False, heads=None):
    """q, k, v, cls_k, cls_v (and do when ``grad``): ``[B, f, n, D]`` and
    ``[B, 1, D]``, or with ``heads`` the head-split ``[B * heads, f, n,
    hd]`` and ``[B * heads, 1, hd]`` with q scaled by ``hd ** -0.5``."""
    rng = np.random.default_rng(seed)
    if heads is not None:
        B, D = B * heads, D // heads
    grid = [rng.normal(size=(B, f, n, D)) for _ in range(4 if grad else 3)]
    cls = [rng.normal(size=(B, 1, D)) for _ in range(2)]
    if heads is not None:
        grid[0] = grid[0] * D ** -0.5
    arrs = grid[:3] + cls + grid[3:]
    return [torch.from_numpy(a).to(device, dtype) for a in arrs]


def _kernel_inputs(name, device, dtype, B, f, n, D, H, seed=0):
    """The inputs of kernel ``name`` at (B, f, n, D, H)."""
    return _inputs(device, dtype, B, f, n, D, seed=seed,
                   grad=name.endswith("bwd"),
                   heads=H if name.startswith(HEAD_SPLIT) else None)


def _call(fn, name, x, H):
    """K1/K2 take ``heads`` and ``scale``; K4/K5 take q already scaled."""
    if name.startswith(HEAD_SPLIT):
        return fn(*x)
    return fn(*x, heads=H, scale=float(x[0].shape[-1] // H) ** -0.5)


SHAPES = [(2, 4, 196, 768, 12), (1, 1, 61, 768, 12), (2, 16, 50, 768, 12),
          (3, 2, 7, 32, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["space_attention_fwd", "time_attention_fwd",
                                  "grouped_attention_fwd",
                                  "time_attention_hs_fwd"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,f,n,D,H", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, name, dtype, tol, B, f, n, D,
                                   H):
    x = _kernel_inputs(name, cuda_device, dtype, B, f, n, D, H)
    ca.reset_launch_counts()
    got = _call(getattr(ca, name), name, x, H)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = _call(getattr(ca, f"{name}_plain"), name, x, H)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["space_attention_fwd", "grouped_attention_fwd"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("L", [1, 4, 7, 50, 61, 196, 255])
def test_cuda_bf16_tensor_core_fwd_matches_plain(cuda_device, name, hd, L):
    # every key-tile count the kernel instantiates (L + 1 from 2 to 256
    # keys: 1 to 16 tiles of 16, ragged and full), two heads a row for K1
    B, G, H = 2, 3, 2
    x = _kernel_inputs(name, cuda_device, torch.bfloat16, B, G, L, H * hd, H,
                       seed=L + hd)
    ca.reset_launch_counts()
    got = _call(getattr(ca, name), name, x, H)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = _call(getattr(ca, f"{name}_plain"), name, x, H)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    g, w = got.double(), want.double()
    assert bool(torch.isfinite(g).all())
    err = (g - w).abs().max().item()
    rel = ((g - w).norm() / w.norm()).item()
    assert err <= 2e-2 and rel <= 1e-3, (err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["space_attention_bwd", "time_attention_bwd",
                                  "grouped_attention_bwd",
                                  "time_attention_hs_bwd"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,f,n,D,H", SHAPES)
def test_cuda_bwd_kernel_matches_plain(cuda_device, name, dtype, tol, B, f, n,
                                       D, H):
    x = _kernel_inputs(name, cuda_device, dtype, B, f, n, D, H, seed=1)
    if name.startswith(HEAD_SPLIT) and dtype == torch.bfloat16:
        tol = 2.5e-1
    ca.reset_launch_counts()
    got = _call(getattr(ca, name), name, x, H)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = _call(getattr(ca, f"{name}_plain"), name, x, H)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape, i
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (i, err)
        if name in TENSOR_CORE_BWD and dtype == torch.bfloat16:
            g, w = g.double(), w.double()
            rel = ((g - w).norm() / w.norm()).item()
            assert rel <= 1e-3, (i, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TENSOR_CORE_BWD)
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("L", [1, 4, 7, 50, 61, 196, 255])
def test_cuda_bf16_tensor_core_bwd_matches_plain(cuda_device, name, hd, L):
    # query and key tiles from 1 to 16, ragged and full, two heads a row
    # for K1; dq, dk, dv and both CLS grads
    B, G, H = 2, 3, 2
    x = _kernel_inputs(name, cuda_device, torch.bfloat16, B, G, L, H * hd, H,
                       seed=L + hd)
    ca.reset_launch_counts()
    got = _call(getattr(ca, name), name, x, H)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = _call(getattr(ca, f"{name}_plain"), name, x, H)
    tol = 2.5e-1 if name.startswith(HEAD_SPLIT) else 5e-2
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, i
        g, w = g.double(), w.double()
        assert bool(torch.isfinite(g).all()), i
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        assert err <= tol and rel <= 1e-3, (i, err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TENSOR_CORE_BWD)
@pytest.mark.parametrize("hd,L", [(96, 255), (128, 207)])
def test_cuda_bf16_tensor_core_bwd_wide_heads_match_plain(cuda_device, name,
                                                          hd, L):
    # past hd 64 phase 2 re-reads the K and V fragments from shared memory;
    # L 207 is the most keys whose tiles fit shared memory at hd 128
    x = _kernel_inputs(name, cuda_device, torch.bfloat16, 1, 2, L, 2 * hd, 2,
                       seed=L + hd)
    got = _call(getattr(ca, name), name, x, 2)
    want = _call(getattr(ca, f"{name}_plain"), name, x, 2)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double(), w.double()
        rel = ((g - w).norm() / w.norm()).item()
        assert bool(torch.isfinite(g).all()) and rel <= 1e-3, (i, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TENSOR_CORE_BWD)
def test_cuda_bf16_tensor_core_bwd_is_deterministic(cuda_device, name):
    # each dq row and each dK / dV row is summed by one warp in a fixed
    # order, with no atomics: two launches give the same bits
    x = _kernel_inputs(name, cuda_device, torch.bfloat16, 2, 4, 196, 768, 12,
                       seed=5)
    first = _call(getattr(ca, name), name, x, 12)
    second = _call(getattr(ca, name), name, x, 12)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


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


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,f,n,D", [
    ("time_attention_fwd", F32, 64, 2, 768),
    ("time_attention_bwd", F32, 32, 2, 768),
    ("space_attention_fwd", F32, 1, 450, 768),
    ("space_attention_bwd", F32, 1, 450, 768),
    ("grouped_attention_fwd", F32, 1, 450, 768),
    ("grouped_attention_bwd", F32, 1, 450, 768),
    ("time_attention_hs_fwd", F32, 170, 2, 768),
    ("time_attention_hs_bwd", F32, 170, 2, 768),
    ("space_attention_fwd", BF16, 1, 256, 768),
    ("grouped_attention_fwd", BF16, 1, 256, 768),
    ("space_attention_bwd", BF16, 1, 256, 768),
    ("grouped_attention_bwd", BF16, 1, 256, 768),
    ("space_attention_fwd", BF16, 2, 196, 12 * 24),
    ("grouped_attention_fwd", BF16, 2, 196, 12 * 24),
    ("space_attention_bwd", BF16, 2, 196, 12 * 24),
    ("grouped_attention_bwd", BF16, 2, 196, 12 * 24),
    ("space_attention_bwd", BF16, 1, 208, 12 * 128),
    ("grouped_attention_bwd", BF16, 1, 208, 12 * 128)])
def test_cuda_wrapper_raises_on_shapes_the_kernel_cannot_take(cuda_device,
                                                              name, dtype, f,
                                                              n, D):
    # float32: more shared memory than the device lets one block opt in to
    # (and, K4-bwd, more than its 256 keys; K2: more than its 16 frames);
    # bf16 tensor-core forward and
    # backward: more than 256 keys (L + 1 = 257), or hd 24, not a multiple
    # of 16; the backward at hd 128: L 208, whose staged tiles pass the
    # opt-in shared memory
    x = _kernel_inputs(name, cuda_device, dtype, 1, f, n, D, 12)
    with pytest.raises(RuntimeError, match="launch failed"):
        _call(getattr(ca, name), name, x, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["grouped_attention", "time_attention_hs"])
@pytest.mark.parametrize("f,n", [(4, 196), (16, 7), (1, 1)])
def test_cuda_head_split_function_grads_match_autograd_of_plain(
        cuda_device, kernel, f, n):
    x = _inputs(cuda_device, torch.float32, 2, f, n, 768, seed=3, grad=True,
                heads=12)
    fn = {"grouped_attention": ca.GroupedAttention,
          "time_attention_hs": ca.TimeAttentionHS}[kernel]
    plain = getattr(ca, f"{kernel}_fwd_plain")

    def grads(run):
        xs = [t.clone().requires_grad_() for t in x[:5]]
        run(*xs).backward(x[5])
        return [t.grad for t in xs]

    ca.reset_launch_counts()
    got = grads(fn.apply)
    assert ca.launches[f"{kernel}_fwd"] == 1
    assert ca.launches[f"{kernel}_bwd"] == 1
    want = grads(plain)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g - w).abs().max().item() <= 1e-4, i


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["space", "time"])
def test_cuda_divided_attention_routes_agree(cuda_device, axis):
    """The head-split op through K4/K5 vs its plain torch route and vs the
    K1/K2 route of ``divided_attention_bsd``, float32, forward and grads."""
    from egovlp_tpu_torch.kernels.divided_attention import (
        divided_attention,
        divided_attention_bsd,
    )

    B, H, f, n, hd = 2, 12, 4, 49, 64
    S, D, scale = 1 + f * n, H * hd, hd ** -0.5
    rng = np.random.default_rng(4)
    bsd = [torch.from_numpy(rng.normal(size=(B, S, D))).to(cuda_device,
                                                            torch.float32)
           for _ in range(3)]

    def split(t):
        return t.reshape(B, S, H, hd).transpose(1, 2).contiguous()

    def run(op, xs):
        xs = [t.clone().requires_grad_() for t in xs]
        out = op(*xs)
        (out * torch.cos(out)).sum().backward()
        return [out.detach()] + [t.grad for t in xs]

    hs = [split(bsd[0]) * scale, split(bsd[1]), split(bsd[2])]
    ca.reset_launch_counts()
    got = run(lambda *xs: divided_attention(
        *xs, frames=f, patches=n, axis=axis, impl="pallas"), hs)
    name = "grouped_attention" if axis == "space" else "time_attention_hs"
    assert ca.launches[f"{name}_fwd"] == 1 and ca.launches[f"{name}_bwd"] == 1
    want = run(lambda *xs: divided_attention(
        *xs, frames=f, patches=n, axis=axis, impl="xla"), hs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g - w).abs().max().item() <= 1e-4, i
    k12 = run(lambda *xs: divided_attention_bsd(
        *xs, heads=H, frames=f, patches=n, axis=axis, impl="pallas"), bsd)
    merge = [split(k12[0]), split(k12[1]) / scale, split(k12[2]),
             split(k12[3])]
    for i, (g, w) in enumerate(zip(got, merge)):
        assert (g - w).abs().max().item() <= 1e-4, i


K2 = ("time_attention_fwd", "time_attention_bwd")


def _assert_close_to_twin(got, want, dtype, tol):
    """Each output within ``tol`` max abs of the twin's and, at bf16,
    within relative L2 1e-3 (float32: 1e-5)."""
    rel_tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape, i
        g, w = g.double(), w.double()
        assert bool(torch.isfinite(g).all()), i
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        assert err <= tol and rel <= rel_tol, (i, err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("name", K2)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("f", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [1, 7, 61, 196])
def test_cuda_time_streaming_matches_plain(cuda_device, name, dtype, hd, f, n):
    # every instantiation (4, 8 and 16 frames held) at F below and at its
    # capacity, ragged N (a run of 4 columns cut short), 3 heads: the
    # warps' head slices end in a group with no head
    B, H = 2, 3
    x = _kernel_inputs(name, cuda_device, dtype, B, f, n, H * hd, H,
                       seed=f * 1000 + n + hd)
    ca.reset_launch_counts()
    got = _call(getattr(ca, name), name, x, H)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = _call(getattr(ca, f"{name}_plain"), name, x, H)
    if name.endswith("fwd"):
        got, want = (got,), (want,)
    tol = 1e-4 if dtype == torch.float32 else (
        2e-2 if name.endswith("fwd") else 5e-2)
    _assert_close_to_twin(got, want, dtype, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_time_bwd_is_deterministic(cuda_device, dtype):
    # each output element has one writer, and each warp sums its run of
    # columns' CLS grads in a fixed order: two launches give the same bits
    x = _kernel_inputs("time_attention_bwd", cuda_device, dtype, 2, 4, 196,
                       768, 12, seed=6)
    first = _call(ca.time_attention_bwd, "time_attention_bwd", x, 12)
    second = _call(ca.time_attention_bwd, "time_attention_bwd", x, 12)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


@pytest.mark.cuda
@pytest.mark.parametrize("name", K2)
@pytest.mark.parametrize("dtype,f,hd", [
    (F32, 17, 64), (BF16, 17, 64),   # past the 16 frames it holds
    (BF16, 12, 4), (F32, 2, 6),      # hd not whole 16-byte slices
    (BF16, 4, 264), (F32, 4, 132)])  # more than 32 slices a head
def test_cuda_time_streaming_refuses_shapes(cuda_device, name, dtype, f, hd):
    H = 2
    x = _kernel_inputs(name, cuda_device, dtype, 1, f, 3, H * hd, H)
    with pytest.raises(RuntimeError, match="launch failed"):
        _call(getattr(ca, name), name, x, H)


@pytest.mark.cuda
@pytest.mark.parametrize("name", K2)
def test_cuda_time_streaming_refuses_unaligned_tensors(cuda_device, name):
    # contiguous, but 2 bytes past a 16-byte boundary
    x = _kernel_inputs(name, cuda_device, BF16, 1, 4, 5, 128, 2)
    flat = torch.empty(x[0].numel() + 8, device=cuda_device, dtype=BF16)
    x[0] = flat[1:1 + x[0].numel()].view(x[0].shape).copy_(x[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        _call(getattr(ca, name), name, x, 2)


K5 = ("time_attention_hs_fwd", "time_attention_hs_bwd")


def _k5_tol(name, dtype):
    """Max abs limits of K5: float32 1e-4 / 2e-4; bf16 4e-2 forward (2 to
    17 keys, outputs up to ~5, where one ulp is 3.1e-2) and 2.5e-1
    backward (dq not multiplied by the scale)."""
    if dtype == torch.float32:
        return 1e-4 if name.endswith("fwd") else 2e-4
    return 4e-2 if name.endswith("fwd") else 2.5e-1


def _misalign(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, device=t.device, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", K5)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 96, 128])
@pytest.mark.parametrize("f", [1, 4, 8, 16, 20])
@pytest.mark.parametrize("n", [1, 61, 196, 197])
def test_cuda_time_hs_bodies_match_plain(cuda_device, name, dtype, hd, f, n):
    # f up to 16 on the streaming body (each instantiation below and at its
    # capacity; n not a multiple of the 32 / P columns a warp takes leaves
    # a ragged last block), f 20 on the scalar body; hd 96 leaves lanes of
    # a head without channels
    x = _inputs(cuda_device, dtype, 3, f, n, hd, seed=f * 1000 + n + hd,
                grad=name.endswith("bwd"), heads=1)
    body = ca.TIME_HS_STREAM if f <= 16 else ca.TIME_HS_SCALAR
    assert ca.time_hs_body(*x) == body
    ca.reset_launch_counts()
    got = getattr(ca, name)(*x)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = getattr(ca, f"{name}_plain")(*x)
    if name.endswith("fwd"):
        got, want = (got,), (want,)
    _assert_close_to_twin(got, want, dtype, _k5_tol(name, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", K5)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("i", [0, 3, 5])
def test_cuda_time_hs_unaligned_inputs_take_the_scalar_body(cuda_device, name,
                                                           dtype, i):
    # q, cls_k or do contiguous but one element past a 16-byte boundary
    x = _inputs(cuda_device, dtype, 2, 4, 61, 64, seed=7, grad=True, heads=1)
    x[i] = _misalign(x[i])
    if name.endswith("fwd"):
        x = x[:5]
    assert ca.time_hs_body(*x) == (ca.TIME_HS_SCALAR if i < len(x)
                                   else ca.TIME_HS_STREAM)
    ca.reset_launch_counts()
    got = getattr(ca, name)(*x)
    torch.cuda.synchronize()
    assert ca.launches[name] == 1
    want = getattr(ca, f"{name}_plain")(*x)
    if name.endswith("fwd"):
        got, want = (got,), (want,)
    _assert_close_to_twin(got, want, dtype, _k5_tol(name, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", K5)
@pytest.mark.parametrize("dtype,f,hd,unaligned", [
    (BF16, 17, 64, False), (F32, 17, 64, False),  # past 16 frames
    (BF16, 4, 36, False), (F32, 2, 6, False),     # hd not whole slices
    (BF16, 4, 264, False), (F32, 4, 132, False),  # more than 32 slices
    (BF16, 4, 64, True)])                         # q off 16 bytes
def test_cuda_time_hs_stream_launcher_refuses_shapes(cuda_device, name, dtype,
                                                     f, hd, unaligned):
    # asked for the streaming body on a shape it does not take, the launcher
    # refuses: it never runs the scalar body in its place
    x = _inputs(cuda_device, dtype, 2, f, 3, hd, seed=8,
                grad=name.endswith("bwd"), heads=1)
    if unaligned:
        x[0] = _misalign(x[0])
    q = x[0]
    outs = [torch.empty_like(q)]
    if name.endswith("bwd"):  # scratch of the scalar body's shape: ample
        outs += [torch.empty_like(q), torch.empty_like(q)]
        outs += torch.empty((2, *ca.time_hs_bwd_parts(q, ca.TIME_HS_SCALAR)),
                            device=q.device).unbind(0)
    ca.reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        ca._launch(name, x, outs, (*q.shape, ca.TIME_HS_STREAM))
    assert ca.launches[name] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("f", [4, 16, 20])
def test_cuda_time_hs_bwd_is_deterministic(cuda_device, dtype, f):
    # each output element has one writer and each sum a fixed order (the
    # streaming body's CLS grads over its run, then over its column groups
    # by xor shuffles): two launches give the same bits, on both bodies
    x = _inputs(cuda_device, dtype, 2, f, 196, 768, seed=9, grad=True,
                heads=12)
    first = ca.time_attention_hs_bwd(*x)
    second = ca.time_attention_hs_bwd(*x)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(first, second)):
        assert torch.equal(a, b), i


# --------------------------------------------------------------------------
# K3: LayerNorm forward and backward (kernels/fused_ln.py)
# --------------------------------------------------------------------------

def _ln_inputs(device, dtype, rows, D, seed=0):
    """x, scale, bias, dy: x and dy ``[rows, D]`` in ``dtype`` (x off
    zero mean), the parameters float32 ``[D]``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, D)) * 2 + 0.5
    dy = rng.normal(size=(rows, D))
    scale, bias = 1 + 0.3 * rng.normal(size=D), rng.normal(size=D)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(scale).to(device, torch.float32),
            torch.from_numpy(bias).to(device, torch.float32),
            torch.from_numpy(dy).to(device, dtype))


def _rel(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("rows,D", [(100, 768), (33, 1024), (7, 64),
                                    (1, 24), (300, 1024)])
def test_cuda_layer_norm_matches_plain(cuda_device, dtype, rel, rows, D):
    """float32: the same formula, sums in another order (1e-5); bf16: one
    rounding of each output from float32 values that agree to ~1e-6
    (2e-3); dscale / dbias are float32 sums (1e-5 at both)."""
    from egovlp_tpu_torch.kernels import fused_ln

    x, scale, bias, dy = _ln_inputs(cuda_device, dtype, rows, D, seed=rows)
    ca.reset_launch_counts()
    y, mu, rstd = fused_ln.layer_norm_fwd(x, scale, bias, 1e-6)
    grads = fused_ln.layer_norm_bwd(x, scale, mu, rstd, dy)
    torch.cuda.synchronize()
    assert ca.launches["layer_norm_fwd"] == ca.launches["layer_norm_bwd"] == 1
    want_y, want_mu, want_rstd = fused_ln.layer_norm_fwd_plain(x, scale, bias,
                                                               1e-6)
    want = fused_ln.layer_norm_bwd_plain(x, scale, want_mu, want_rstd, dy)
    assert y.dtype == dtype and mu.shape == (rows, 1)
    assert _rel(mu, want_mu) <= 1e-5 and _rel(rstd, want_rstd) <= 1e-5
    assert _rel(y, want_y) <= rel
    assert _rel(grads[0], want[0]) <= rel
    assert _rel(grads[1], want[1]) <= 1e-5 and _rel(grads[2], want[2]) <= 1e-5


@pytest.mark.cuda
def test_cuda_layer_norm_bwd_is_deterministic(cuda_device):
    from egovlp_tpu_torch.kernels import fused_ln

    x, scale, bias, dy = _ln_inputs(cuda_device, torch.bfloat16, 5000, 1024)
    _, mu, rstd = fused_ln.layer_norm_fwd(x, scale, bias, 1e-6)
    first = fused_ln.layer_norm_bwd(x, scale, mu, rstd, dy)
    second = fused_ln.layer_norm_bwd(x, scale, mu, rstd, dy)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_layer_norm_function_matches_autograd_of_plain(cuda_device):
    from egovlp_tpu_torch.kernels import fused_ln

    x, scale, bias, dy = _ln_inputs(cuda_device, torch.float32, 64, 768)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    got = torch.autograd.grad(fused_ln.fused_layer_norm(*leaves), leaves, dy)
    plain = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want = torch.autograd.grad(
        fused_ln.layer_norm_fwd_plain(*plain, 1e-6)[0], plain, dy)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,bwd", [
    (torch.bfloat16, 20, False), (torch.float32, 22, False),  # partial slices
    (torch.bfloat16, 1032, True), (torch.float32, 2048, True)])  # too wide
def test_cuda_layer_norm_refuses_shapes(cuda_device, dtype, D, bwd):
    from egovlp_tpu_torch.kernels import fused_ln

    x, scale, bias, dy = _ln_inputs(cuda_device, dtype, 4, D)
    with pytest.raises(ValueError, match="multiple"):
        if bwd:
            stats = torch.zeros(2, 4, 1, device=cuda_device)
            fused_ln.layer_norm_bwd(x, scale, stats[0], stats[1], dy)
        else:
            fused_ln.layer_norm_fwd(x, scale, bias, 1e-6)


# the CLS + patch pair: one K3-fwd and one K3-bwd launch over both parts,
# at the shapes of phase 3c and ragged small ones; (patch rows, CLS rows)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("rows,cls,D", [(25088, 32, 1024), (25088, 32, 768),
                                        (196, 4, 768), (5, 3, 64),
                                        (0, 32, 1024)])
def test_cuda_layer_norm_pair_matches_plain(cuda_device, dtype, rel, rows,
                                            cls, D):
    """Each part as the single twin, and dscale / dbias the two parts'
    sums added (1e-5: float32 sums in another order)."""
    from egovlp_tpu_torch.kernels import fused_ln

    xp, scale, bias, dyp = _ln_inputs(cuda_device, dtype, rows, D, seed=rows)
    xc, _, _, dyc = _ln_inputs(cuda_device, dtype, cls, D, seed=cls + 1)
    xc, dyc = xc.reshape(cls, 1, D), dyc.reshape(cls, 1, D)
    ca.reset_launch_counts()
    yc, yp, mu_c, rstd_c, mu_p, rstd_p = fused_ln.layer_norm_pair_fwd(
        xc, xp, scale, bias, 1e-6)
    grads = fused_ln.layer_norm_pair_bwd(xc, xp, scale, mu_c, rstd_c, mu_p,
                                         rstd_p, dyc, dyp)
    torch.cuda.synchronize()
    assert ca.launches["layer_norm_fwd"] == ca.launches["layer_norm_bwd"] == 1
    want = fused_ln.layer_norm_pair_fwd_plain(xc, xp, scale, bias, 1e-6)
    want_grads = fused_ln.layer_norm_pair_bwd_plain(xc, xp, scale, *want[2:],
                                                    dyc, dyp)
    for got, w, lim in zip((yc, yp, mu_c, rstd_c, mu_p, rstd_p, *grads),
                           (*want, *want_grads),
                           (rel, rel, 1e-5, 1e-5, 1e-5, 1e-5, rel, rel, 1e-5,
                            1e-5)):
        assert got.shape == w.shape and got.dtype == w.dtype
        if w.numel():
            assert _rel(got, w) <= lim


@pytest.mark.cuda
@pytest.mark.parametrize("dead", ["patch", "cls", None])
def test_cuda_layer_norm_pair_function_launches_once(cuda_device, dead):
    """The Function launches K3-fwd once and K3-bwd once; an output with
    no gradient leaves its rows out (its input grad None) and the grads
    equal autograd of the plain twin with a zero cotangent there."""
    from egovlp_tpu_torch.kernels import fused_ln

    xp, scale, bias, dyp = _ln_inputs(cuda_device, torch.float32, 300, 768)
    xc, _, _, dyc = _ln_inputs(cuda_device, torch.float32, 4, 768, seed=1)
    leaves = [t.clone().requires_grad_() for t in (xc, xp, scale, bias)]
    ca.reset_launch_counts()
    yc, yp = fused_ln.fused_layer_norm_pair(*leaves)
    outs = [(y, d) for y, d, part in ((yc, dyc, "cls"), (yp, dyp, "patch"))
            if part != dead]
    got = torch.autograd.grad([o for o, _ in outs], leaves,
                              [d for _, d in outs], allow_unused=True)
    torch.cuda.synchronize()
    assert ca.launches["layer_norm_fwd"] == ca.launches["layer_norm_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (xc, xp, scale, bias)]
    pc = fused_ln.layer_norm_fwd_plain(plain[0], *plain[2:], 1e-6)[0]
    pp = fused_ln.layer_norm_fwd_plain(plain[1], *plain[2:], 1e-6)[0]
    zc = torch.zeros_like(dyc) if dead == "cls" else dyc
    zp = torch.zeros_like(dyp) if dead == "patch" else dyp
    want = torch.autograd.grad([pc, pp], plain, [zc, zp])
    for i, (g, w) in enumerate(zip(got, want)):
        if (dead, i) in (("cls", 0), ("patch", 1)):
            assert g is None
        else:
            assert _rel(g, w) <= 1e-5


@pytest.mark.cuda
def test_cuda_layer_norm_bwd_grid_fills_the_card(cuda_device):
    """K3-bwd's grid: one block of 8 warps (one row each) for every 8 rows,
    up to one an SM."""
    import ctypes

    from egovlp_tpu_torch.kernels._build import load_library

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lib = load_library()
    for rows, D, want in ((32, 1024, 4), (960, 768, 120),
                          (25120, 1024, sms), (25120, 768, sms)):
        grid = ctypes.c_int()
        assert lib.egovlp_layer_norm_bwd_grid(rows, D, 1, cuda_device.index or 0,
                                              ctypes.byref(grid)) == 0
        assert grid.value == min(want, -(-rows // 8)), (rows, D)


@pytest.mark.cuda
def test_cuda_layer_norm_pair_refuses_mismatched_parts(cuda_device):
    from egovlp_tpu_torch.kernels import fused_ln

    xp, scale, bias, _ = _ln_inputs(cuda_device, torch.bfloat16, 8, 64)
    xc, _, _, _ = _ln_inputs(cuda_device, torch.float32, 2, 64)
    with pytest.raises(ValueError, match="segments"):
        fused_ln.layer_norm_pair_fwd(xc, xp, scale, bias, 1e-6)
