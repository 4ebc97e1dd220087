"""Divided-attention kernels: CUDA wrappers, their plain PyTorch twins,
and the autograd Functions over them.

Counterpart of ``egovlp_tpu/kernels/pallas_attention.py``:

* ``space_attention_fwd`` (K1-fwd) / ``space_attention_bwd`` (K1-bwd) and
  the Function ``SpaceAttention`` <- ``make_space_attention_bsd`` (:821);
* ``time_attention_fwd`` (K2-fwd) / ``time_attention_bwd`` (K2-bwd) and
  the Function ``TimeAttention`` <- ``make_time_attention_bsd`` (:1568);
* ``grouped_attention_fwd`` (K4-fwd) / ``grouped_attention_bwd`` (K4-bwd)
  and the Function ``GroupedAttention`` <- ``grouped_attention`` (:157);
* ``time_attention_hs_fwd`` (K5-fwd) / ``time_attention_hs_bwd`` (K5-bwd)
  and the Function ``TimeAttentionHS`` <- ``time_attention`` (:299).

K1 and K2 work on the grid layout ``q, k, v: [B, f, n, D]`` with the CLS
key and value ``[B, 1, D]`` spliced in front of every group; heads are
sliced from D inside the kernels, which scale q.  K4 and K5 take heads
already split and q already scaled: K4 ``[BH, G, L, hd]`` groups, K5 the
natural ``[BH, f, n, hd]`` layout (group = one patch column's f frames),
CLS ``[BH, 1, hd]``.  Each wrapper calls its op,
``torch.ops.egovlp_torch.<name>`` (``kernels/ops.py``): given CUDA tensors
the op launches its kernel (``kernels/csrc``) or raises; given CPU tensors
it computes the plain version beside it.  The autograd Functions launch
through ``direct`` instead, without the dispatcher's host cost; callers
take the ops where grad mode is off (``forward_only``), so that
``torch.export`` captures them.  ``launches`` counts kernel launches per
wrapper; ``_fwd_cuda`` / ``_bwd_cuda`` are the launchers.  As
the JAX ``custom_vjp`` does, a Function saves only its inputs and the
backward kernel recomputes the probabilities.

At bf16, K1 and K4 run on the tensor cores, forward and backward (one
body each way, ``csrc/attention_fwd_mma.cuh`` and
``csrc/attention_bwd_mma.cuh``), which take at most 256 keys (L + 1) and
hd a multiple of 16 up to 128 (the backward: within the device's shared
memory, so L <= 224 at hd 112 and L <= 207 at hd 128): any other bf16
shape raises.  Their float32 launches run scalar CUDA-core bodies.  K2,
forward and backward, at both dtypes, is one 16-byte streaming body
(``csrc/time_attention_stream.cuh``: a lane owns a 16-byte slice of every
row, a warp a patch column and a slice of heads), which takes F from 1 to
16 frames, any N, and hd a multiple of 8 (bf16) or 4 (float32) up to 32
slices, with 16-byte aligned tensors; any other shape raises.  There is no
other K2 body.  K5 runs the same streaming body on its own layout (a warp
takes 32 / P adjacent patch columns of one head) wherever it takes the
shape, and its scalar shared-memory body elsewhere: ``time_hs_body``
picks one before the launch.
"""

from __future__ import annotations

import torch

from egovlp_tpu_torch.kernels import ops
from egovlp_tpu_torch.kernels._build import load_library

# K1's softmax runs in base 2: log2(e) is folded into the q scaling before
# q is rounded, and ln(2) restores dK's scale (pallas_attention.py :339-340)
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

launches = {"space_attention_fwd": 0, "time_attention_fwd": 0,
            "space_attention_bwd": 0, "time_attention_bwd": 0,
            "grouped_attention_fwd": 0, "grouped_attention_bwd": 0,
            "time_attention_hs_fwd": 0, "time_attention_hs_bwd": 0,
            # K3, the LayerNorm kernels of ``kernels/fused_ln.py``
            "layer_norm_fwd": 0, "layer_norm_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check(q, k, v, cls_k, cls_v, heads: int, do=None) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be 4-D, got {tuple(q.shape)}")
    B, _, _, D = q.shape
    grid = (k, v) if do is None else (k, v, do)
    if any(t.shape != q.shape for t in grid):
        raise ValueError(f"q/k/v/do shapes differ: {tuple(q.shape)}, "
                         f"{[tuple(t.shape) for t in grid]}")
    if cls_k.shape != (B, 1, D) or cls_v.shape != (B, 1, D):
        raise ValueError(f"cls_k/cls_v must be {(B, 1, D)}, got "
                         f"{tuple(cls_k.shape)}, {tuple(cls_v.shape)}")
    if D % heads:
        raise ValueError(f"D={D} is not divisible by heads={heads}")
    ts = (q, cls_k, cls_v) + grid
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise TypeError("q, k, v, cls_k, cls_v (and do) must share one dtype, "
                        f"float32 or bfloat16; got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError("q, k, v, cls_k, cls_v (and do) must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k, v, cls_k, cls_v (and do) must be contiguous")


def _launch(name: str, inputs, outputs, args) -> None:
    """Launch kernel ``name`` on the inputs' device and current stream over
    preallocated ``outputs``, with the scalar ``args`` (the shape, then the
    kernel's own scalars, in the C signature's order), or raise."""
    q = inputs[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    lib = load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, f"egovlp_{name}")(
        *(t.data_ptr() for t in (*inputs, *outputs)), *args,
        _DTYPE_CODES[q.dtype], q.device.index, stream)
    if err != 0:
        msg = lib.egovlp_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed at shape {tuple(q.shape)} "
                           f"{q.dtype}: {msg} (cudaError {err})")
    launches[name] += 1


def _fwd_cuda(name: str, q, k, v, cls_k, cls_v, *scalars) -> torch.Tensor:
    """The forward launcher of kernel ``name``: ``scalars`` are the
    kernel's after the shape (``heads``, ``scale`` for K1/K2; none for
    K4/K5); K5 also takes its body (``time_hs_body``)."""
    x = (q, k, v, cls_k, cls_v)
    _check(*x, scalars[0] if scalars else 1)
    extra = (time_hs_body(*x),) if name == "time_attention_hs_fwd" else ()
    out = torch.empty_like(q)
    _launch(name, x, (out,), (*q.shape, *scalars, *extra))
    return out


def _bwd_cuda(name: str, q, k, v, cls_k, cls_v, do, *scalars):
    """The backward launcher of kernel ``name``: ``(dqkv [3, *q.shape],
    dcls [2, B, 1, D])``.  The kernel writes each group's float32 share of
    the CLS grads to ``_part_shape`` scratch, summed here over the groups
    and cast once.  ``scalars`` as for ``_fwd_cuda``."""
    x = (q, k, v, cls_k, cls_v, do)
    _check(*x[:5], scalars[0] if scalars else 1, do)
    body = time_hs_body(*x) if name == "time_attention_hs_bwd" else None
    extra = () if body is None else (body,)
    # one allocation for the three grads and one for both scratches, one
    # sum and one cast for both CLS grads: fewer host calls a launch
    dqkv = torch.empty((3, *q.shape), device=q.device, dtype=q.dtype)
    parts = torch.empty((2, *_part_shape(name, q, body)), device=q.device,
                        dtype=torch.float32)
    _launch(name, x, (dqkv[0], dqkv[1], dqkv[2], parts[0], parts[1]),
            (*q.shape, *scalars, *extra))
    return dqkv, parts.sum(dim=2, keepdim=True).to(q.dtype)


def _unbind(grads) -> tuple:
    """A backward op's ``(dqkv, dcls)`` -> ``(dq, dk, dv, dcls_k,
    dcls_v)``."""
    return (*grads[0].unbind(0), *grads[1].unbind(0))


def _part_shape(name: str, q, body) -> tuple:
    """The shape of one of a backward kernel's two CLS-grad scratches."""
    B, G, N, D = q.shape
    if name == "time_attention_bwd":
        return B, -(-N // TIME_BWD_RUN), D
    if name == "time_attention_hs_bwd":
        return time_hs_bwd_parts(q, body)
    return B, G, D


# kernel name -> its implementation on CPU tensors (the plain twin) and on
# CUDA tensors (the launcher), each with the op's arguments and outputs
_IMPLS = {}


def _define(name: str, plain, scalars: bool) -> "torch._ops.OpOverload":
    """The op of kernel ``name`` (``ops.define``): its launcher on CUDA, its
    plain twin ``plain`` on the CPU (with ``heads`` and ``scale`` where
    ``scalars``), and the launcher's checks and output shapes on fake
    tensors.  The CPU and CUDA implementations also go to ``_IMPLS``."""
    fwd = name.endswith("fwd")
    n = 5 if fwd else 6
    args = "Tensor q, Tensor k, Tensor v, Tensor cls_k, Tensor cls_v"
    args += "" if fwd else ", Tensor do"
    args += ", int heads, float scale" if scalars else ""
    outs = "Tensor" if fwd else "(Tensor, Tensor)"

    def cpu(*a):
        kw = dict(zip(("heads", "scale"), a[n:]))
        _check(*a[:5], kw.get("heads", 1), *a[5:n])
        if fwd:
            return plain(*a[:n], **kw)
        dq, dk, dv, dck, dcv = plain(*a[:n], **kw)
        return torch.stack([dq, dk, dv]), torch.stack([dck, dcv])

    def fake(*a):
        q = a[0]
        _check(*a[:5], a[n] if scalars else 1, *a[5:n])
        if fwd:
            return torch.empty_like(q)
        return (q.new_empty((3, *q.shape)),
                q.new_empty((2, q.shape[0], 1, q.shape[-1])))

    def cuda(*a):
        return (_fwd_cuda if fwd else _bwd_cuda)(name, *a)

    _IMPLS[name] = {"cpu": cpu, "cuda": cuda}
    return ops.define(name, f"({args}) -> {outs}", cpu, cuda, fake)


def direct(name: str, *args):
    """Kernel ``name`` on the op's arguments without the dispatcher: the
    launcher for CUDA tensors, the plain twin for CPU tensors, outputs as
    its wrapper returns them.  The autograd Functions, which only training
    calls, take this route: the op cost the host 7-14 us a call more
    beside an NVIDIA H100 80GB HBM3 at 700 W (``PERF.md``, section 6)."""
    impl = _IMPLS[name]["cpu" if args[0].device.type == "cpu" else "cuda"]
    out = impl(*args)
    return out if name.endswith("fwd") else _unbind(out)


# --------------------------------------------------------------------------
# K1: space attention (group = one frame's n patches)
# --------------------------------------------------------------------------

def space_attention_fwd_plain(q, k, v, cls_k, cls_v, *, heads: int,
                              scale: float) -> torch.Tensor:
    """Plain PyTorch K1 with the rounding points of the Pallas bodies
    (``_mk_space_fwd_bsd_v2`` :473-480, ``_v3`` :590-602): ``qs =
    round(q * scale * log2(e))``, float32 logits in log2 units, ``e =
    exp2(logits - rowmax)`` rounded before the P.V sum, which is multiplied
    by ``1 / rowsum(e)`` before the one cast."""
    B, G, L, D = q.shape
    hd = D // heads
    dt = q.dtype

    def split(t):  # [B, G, L, D] -> [B, G, H, L, hd]
        return t.reshape(B, G, L, heads, hd).permute(0, 1, 3, 2, 4)

    def with_cls(c, t):  # CLS row first: [B, G, H, L + 1, hd] in float32
        c = c.reshape(B, 1, heads, 1, hd).expand(B, G, heads, 1, hd)
        return torch.cat([c, split(t)], dim=3).float()

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    qs = (split(q).float() * (scale * LOG2E)).to(dt).float()
    logits = qs @ kc.transpose(-1, -2)
    e = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    inv = 1.0 / e.sum(dim=-1, keepdim=True)
    out = (e.to(dt).float() @ vc) * inv
    return out.permute(0, 1, 3, 2, 4).reshape(B, G, L, D).to(dt)


def space_attention_fwd(q, k, v, cls_k, cls_v, *, heads: int,
                        scale: float) -> torch.Tensor:
    """K1-fwd: each frame's patch queries attend over [CLS; that frame]."""
    return _SPACE_FWD(q, k, v, cls_k, cls_v, heads, scale)


_SPACE_FWD = _define("space_attention_fwd", space_attention_fwd_plain, True)


def space_attention_bwd_plain(q, k, v, cls_k, cls_v, do, *, heads: int,
                              scale: float):
    """Plain PyTorch K1-bwd with the rounding points of the Pallas bodies
    (``_mk_space_bwd_bsd_v2`` :509-530, ``_v3`` :625-666): ``qs =
    round(q * scale * log2(e))``, ``p = exp2(logits - rowmax) / rowsum``,
    ``dl`` and ``p`` rounded to the input dtype before their products,
    ``dq = (dl K) * scale``, ``dK = (dl^T qs) * ln(2)``; the CLS grads are
    summed over frames in float32 (the Pallas wrapper rounds each frame's
    share first, :838)."""
    B, G, L, D = q.shape
    hd = D // heads
    dt = q.dtype

    def split(t):  # [B, G, L, D] -> [B, G, H, L, hd] in float32
        return t.reshape(B, G, L, heads, hd).permute(0, 1, 3, 2, 4).float()

    def with_cls(c, t):
        c = c.reshape(B, 1, heads, 1, hd).expand(B, G, heads, 1, hd).float()
        return torch.cat([c, split(t)], dim=3)

    def merge(t):  # [B, G, H, rows, hd] -> [B, G, rows, D]
        return t.permute(0, 1, 3, 2, 4).reshape(B, G, -1, D)

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    qs = (split(q) * (scale * LOG2E)).to(dt).float()
    gr = split(do)
    logits = qs @ kc.transpose(-1, -2)
    e = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    dp = gr @ vc.transpose(-1, -2)
    dl = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = merge((dl @ kc) * scale)
    dkc = merge((dl.transpose(-1, -2) @ qs) * LN2)
    dvc = merge(p.to(dt).float().transpose(-1, -2) @ gr)
    return (dq.to(dt), dkc[:, :, 1:].to(dt), dvc[:, :, 1:].to(dt),
            dkc[:, :, :1].sum(dim=1).to(dt), dvc[:, :, :1].sum(dim=1).to(dt))


def space_attention_bwd(q, k, v, cls_k, cls_v, do, *, heads: int,
                        scale: float):
    """K1-bwd: ``(dq, dk, dv, dcls_k [B, 1, D], dcls_v [B, 1, D])``."""
    return _unbind(_SPACE_BWD(q, k, v, cls_k, cls_v, do, heads, scale))


_SPACE_BWD = _define("space_attention_bwd", space_attention_bwd_plain, True)


# --------------------------------------------------------------------------
# K2: time attention (group = one patch column's f frames)
# --------------------------------------------------------------------------

def time_attention_fwd_plain(q, k, v, cls_k, cls_v, *, heads: int,
                             scale: float) -> torch.Tensor:
    """Plain PyTorch K2: float32 throughout, one cast at the end."""
    B, F, N, D = q.shape
    hd = D // heads

    def split(t):  # [B, F, N, D] -> [B, N, H, F, hd] in float32
        return t.float().reshape(B, F, N, heads, hd).permute(0, 2, 3, 1, 4)

    def with_cls(c, t):
        c = c.float().reshape(B, 1, heads, 1, hd).expand(B, N, heads, 1, hd)
        return torch.cat([c, split(t)], dim=3)

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    logits = (split(q) * scale) @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (e @ vc) / e.sum(dim=-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(B, F, N, D).to(q.dtype)


def time_attention_fwd(q, k, v, cls_k, cls_v, *, heads: int,
                       scale: float) -> torch.Tensor:
    """K2-fwd: each patch column's frame queries attend over [CLS; column]."""
    return _TIME_FWD(q, k, v, cls_k, cls_v, heads, scale)


_TIME_FWD = _define("time_attention_fwd", time_attention_fwd_plain, True)


def time_attention_bwd_plain(q, k, v, cls_k, cls_v, do, *, heads: int,
                             scale: float):
    """Plain PyTorch K2-bwd: float32 throughout, one cast per output; the
    CLS grads are summed over the patch columns in float32."""
    B, F, N, D = q.shape
    hd = D // heads
    dt = q.dtype

    def split(t):  # [B, F, N, D] -> [B, N, H, F, hd] in float32
        return t.float().reshape(B, F, N, heads, hd).permute(0, 2, 3, 1, 4)

    def with_cls(c, t):
        c = c.float().reshape(B, 1, heads, 1, hd).expand(B, N, heads, 1, hd)
        return torch.cat([c, split(t)], dim=3)

    def merge(t):  # [B, N, H, rows, hd] -> [B, rows, N, D]
        return t.permute(0, 3, 1, 2, 4).reshape(B, -1, N, D)

    kc, vc = with_cls(cls_k, k), with_cls(cls_v, v)
    qa = split(q) * scale
    gr = split(do)
    logits = qa @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = gr @ vc.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = merge((dl @ kc) * scale)
    dkc = merge(dl.transpose(-1, -2) @ qa)
    dvc = merge(p.transpose(-1, -2) @ gr)
    return (dq.to(dt), dkc[:, 1:].to(dt), dvc[:, 1:].to(dt),
            dkc[:, :1].sum(dim=2).to(dt), dvc[:, :1].sum(dim=2).to(dt))


# patch columns one warp of K2-bwd walks, summing their CLS grads; its
# scratch has one row a run (``kRun`` in ``csrc/time_attention_stream.cuh``)
TIME_BWD_RUN = 4


def time_attention_bwd(q, k, v, cls_k, cls_v, do, *, heads: int,
                       scale: float):
    """K2-bwd: ``(dq, dk, dv, dcls_k [B, 1, D], dcls_v [B, 1, D])``; the
    kernel writes each run of ``TIME_BWD_RUN`` patch columns' share of the
    CLS grads."""
    return _unbind(_TIME_BWD(q, k, v, cls_k, cls_v, do, heads, scale))


_TIME_BWD = _define("time_attention_bwd", time_attention_bwd_plain, True)


# --------------------------------------------------------------------------
# K4: head-split grouped attention ([BH, G, L, hd], q already scaled)
# --------------------------------------------------------------------------

def _with_cls_groups(c, t):
    """``[cls; t]`` per group in float32: ``[BH, G, L + 1, hd]``."""
    BH, G, _, hd = t.shape
    c = c.reshape(BH, 1, 1, hd).expand(BH, G, 1, hd)
    return torch.cat([c, t], dim=2).float()


def grouped_attention_fwd_plain(q, k, v, cls_k, cls_v) -> torch.Tensor:
    """Plain PyTorch K4: float32 logits and softmax; the probabilities are
    normalised, then rounded to the input dtype (``_fwd_kernel`` :47),
    before a float32 P.V sum and one cast."""
    dt = q.dtype
    kc, vc = _with_cls_groups(cls_k, k), _with_cls_groups(cls_v, v)
    logits = q.float() @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt).float()
    return (p @ vc).to(dt)


def grouped_attention_fwd(q, k, v, cls_k, cls_v) -> torch.Tensor:
    """K4-fwd: each group's L queries attend over [CLS; that group]."""
    return _GROUPED_FWD(q, k, v, cls_k, cls_v)


_GROUPED_FWD = _define("grouped_attention_fwd", grouped_attention_fwd_plain,
                       False)


def grouped_attention_bwd_plain(q, k, v, cls_k, cls_v, do):
    """Plain PyTorch K4-bwd, with the rounding points of ``_bwd_kernel``:
    ``dl`` is rounded to the input dtype before dq, dK and the CLS dK
    (:84-93); ``do`` is widened to float32 (:61), so dV and the CLS dV
    take the unrounded probabilities (:90, :94).  The CLS grads are summed
    over the groups in float32 and cast once (the JAX wrapper casts each
    group's share first, :139-152)."""
    dt = q.dtype
    kc, vc = _with_cls_groups(cls_k, k), _with_cls_groups(cls_v, v)
    qf, gr = q.float(), do.float()
    logits = qf @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = gr @ vc.transpose(-1, -2)
    dl = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = dl @ kc
    dkc = dl.transpose(-1, -2) @ qf
    dvc = p.transpose(-1, -2) @ gr
    return (dq.to(dt), dkc[:, :, 1:].to(dt), dvc[:, :, 1:].to(dt),
            dkc[:, :, :1].sum(dim=1).to(dt), dvc[:, :, :1].sum(dim=1).to(dt))


def grouped_attention_bwd(q, k, v, cls_k, cls_v, do):
    """K4-bwd: ``(dq, dk, dv, dcls_k [BH, 1, hd], dcls_v [BH, 1, hd])``."""
    return _unbind(_GROUPED_BWD(q, k, v, cls_k, cls_v, do))


_GROUPED_BWD = _define("grouped_attention_bwd", grouped_attention_bwd_plain,
                       False)


# --------------------------------------------------------------------------
# K5: head-split time attention on the natural [BH, f, n, hd] layout
# --------------------------------------------------------------------------

def _columns(t):
    """``[BH, f, n, hd]`` -> ``[BH, n, f, hd]`` in float32."""
    return t.float().permute(0, 2, 1, 3)


def _with_cls_columns(c, t):
    """``[cls; column]`` per patch column in float32: ``[BH, n, f + 1, hd]``."""
    BH, _, N, hd = t.shape
    c = c.float().reshape(BH, 1, 1, hd).expand(BH, N, 1, hd)
    return torch.cat([c, _columns(t)], dim=2)


def _frames(t, dt):
    """``[BH, n, rows, hd]`` -> contiguous ``[BH, rows, n, hd]`` in ``dt``."""
    return t.permute(0, 2, 1, 3).contiguous().to(dt)


def time_attention_hs_fwd_plain(q, k, v, cls_k, cls_v) -> torch.Tensor:
    """Plain PyTorch K5: float32 throughout (``_time_fwd_kernel`` :191),
    normalised probabilities, one cast at the end."""
    kc, vc = _with_cls_columns(cls_k, k), _with_cls_columns(cls_v, v)
    logits = _columns(q) @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return _frames((e / e.sum(dim=-1, keepdim=True)) @ vc, q.dtype)


# K5's bodies, the ``body`` argument of its C entry points (``kStreamBody``,
# ``kScalarBody`` in ``csrc/common.cuh``)
TIME_HS_STREAM, TIME_HS_SCALAR = 0, 1
# the most frames the streaming body holds (``kFrameCap``)
STREAM_FRAMES = 16


def time_hs_body(*tensors) -> int:
    """The body K5 runs on ``tensors`` (its inputs, q ``[BH, f, n, hd]``
    first): ``TIME_HS_STREAM`` where the 16-byte streaming body takes them
    (f from 1 to 16, hd a multiple of a 16-byte slice's channels, 8 at
    bf16 and 4 at float32, and at most 32 slices, every tensor on a 16-byte
    boundary), else ``TIME_HS_SCALAR``.  Their outputs, allocated by the
    wrappers, are then aligned too; the streaming launcher refuses a shape
    it does not take rather than switch bodies."""
    q = tensors[0]
    f, hd = q.shape[1], q.shape[-1]
    kn = 16 // q.element_size()
    if (1 <= f <= STREAM_FRAMES and hd % kn == 0 and hd // kn <= 32
            and all(t.data_ptr() % 16 == 0 for t in tensors)):
        return TIME_HS_STREAM
    return TIME_HS_SCALAR


def time_attention_hs_fwd(q, k, v, cls_k, cls_v) -> torch.Tensor:
    """K5-fwd: each patch column's f frame queries attend over
    [CLS; column], per (batch * head)."""
    return _TIME_HS_FWD(q, k, v, cls_k, cls_v)


_TIME_HS_FWD = _define("time_attention_hs_fwd", time_attention_hs_fwd_plain,
                       False)


def time_attention_hs_bwd_plain(q, k, v, cls_k, cls_v, do):
    """Plain PyTorch K5-bwd: float32 throughout, one cast per output
    (``_time_bwd_kernel`` :212); the CLS grads are summed over all f x n
    queries in float32."""
    dt = q.dtype
    kc, vc = _with_cls_columns(cls_k, k), _with_cls_columns(cls_v, v)
    qa, gr = _columns(q), _columns(do)
    logits = qa @ kc.transpose(-1, -2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = gr @ vc.transpose(-1, -2)
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dkc = dl.transpose(-1, -2) @ qa
    dvc = p.transpose(-1, -2) @ gr
    return (_frames(dl @ kc, dt), _frames(dkc[:, :, 1:], dt),
            _frames(dvc[:, :, 1:], dt), dkc[:, :, :1].sum(dim=1).to(dt),
            dvc[:, :, :1].sum(dim=1).to(dt))


def time_hs_bwd_parts(q, body: int) -> tuple:
    """The shape of K5-bwd's CLS scratch for ``body``: one row a warp of
    the streaming body, which takes a block of 32 / P patch columns (P
    lanes of 16 bytes a head: a power of two from 8 to 32), on a shape it
    takes; one row a patch column for the scalar body."""
    BH, _, N, hd = q.shape
    if body == TIME_HS_SCALAR:
        return BH, N, hd
    kn, lanes = 16 // q.element_size(), 8
    while lanes * kn < hd:
        lanes *= 2
    return BH, -(-N // (32 // lanes)), hd


def time_attention_hs_bwd(q, k, v, cls_k, cls_v, do):
    """K5-bwd: ``(dq, dk, dv, dcls_k [BH, 1, hd], dcls_v [BH, 1, hd])``;
    the kernel writes float32 shares of the CLS grads
    (``time_hs_bwd_parts``)."""
    return _unbind(_TIME_HS_BWD(q, k, v, cls_k, cls_v, do))


_TIME_HS_BWD = _define("time_attention_hs_bwd", time_attention_hs_bwd_plain,
                       False)


# --------------------------------------------------------------------------
# autograd: forward kernel, backward kernel, inputs saved (no probabilities);
# both launched by ``direct``.  A forward without autograd (serving,
# evaluation, ``torch.export``) calls the op instead: ``forward_only``
# --------------------------------------------------------------------------

def forward_only() -> bool:
    """True where the attention and LayerNorm callers take the registered
    ops rather than the autograd Functions: grad mode off.  The ops are
    what ``torch.export`` can capture; the Functions launch directly."""
    return not torch.is_grad_enabled()


class SpaceAttention(torch.autograd.Function):
    """K1: ``apply(q, k, v, cls_k, cls_v, heads, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v, heads, scale):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        ctx.heads, ctx.scale = heads, scale
        return direct("space_attention_fwd", q, k, v, cls_k, cls_v, heads,
                      scale)

    @staticmethod
    def backward(ctx, do):
        return (*direct("space_attention_bwd", *ctx.saved_tensors,
                        do.contiguous(), ctx.heads, ctx.scale), None, None)


class TimeAttention(torch.autograd.Function):
    """K2: ``apply(q, k, v, cls_k, cls_v, heads, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v, heads, scale):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        ctx.heads, ctx.scale = heads, scale
        return direct("time_attention_fwd", q, k, v, cls_k, cls_v, heads,
                      scale)

    @staticmethod
    def backward(ctx, do):
        return (*direct("time_attention_bwd", *ctx.saved_tensors,
                        do.contiguous(), ctx.heads, ctx.scale), None, None)


class GroupedAttention(torch.autograd.Function):
    """K4: ``apply(q, k, v, cls_k, cls_v)`` on ``[BH, G, L, hd]``, q
    already scaled; counterpart of the ``grouped_attention`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        return direct("grouped_attention_fwd", q, k, v, cls_k, cls_v)

    @staticmethod
    def backward(ctx, do):
        return direct("grouped_attention_bwd", *ctx.saved_tensors,
                      do.contiguous())


class TimeAttentionHS(torch.autograd.Function):
    """K5: ``apply(q, k, v, cls_k, cls_v)`` on ``[BH, f, n, hd]``, q
    already scaled; counterpart of the ``time_attention`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, cls_k, cls_v):
        ctx.save_for_backward(q, k, v, cls_k, cls_v)
        return direct("time_attention_hs_fwd", q, k, v, cls_k, cls_v)

    @staticmethod
    def backward(ctx, do):
        return direct("time_attention_hs_bwd", *ctx.saved_tensors,
                      do.contiguous())
