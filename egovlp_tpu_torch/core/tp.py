"""Tensor parallelism over the mesh's model group (Megatron's column / row
split).

Counterpart of ``egovlp_tpu/core/tp.py``, with its name rules (:39-60):
a Linear whose name is in ``_COLUMN`` is column-parallel (its output
features split), one in ``_ROW`` row-parallel (its input features split;
the bias stays whole and is added once, after the reduction), and a dim
the model size does not divide stays whole.  ``nn.Linear.weight`` is
``[out, in]``, so JAX's column ``P(None, model)`` on a ``[in, out]``
kernel is torch dim 0 here and its row ``P(model, None)`` torch dim 1.

  text tower   q_lin / k_lin / v_lin  column, out_lin row;
               ffn lin1 / lin2        column / row
  video tower  attn / timeattn qkv    column, proj row; mlp fc1 / fc2

JAX lets GSPMD insert the collectives; here they are Megatron's two
operators over the model group, each an autograd Function:

* ``copy_to_model`` before a column-parallel layer: the identity forward,
  an all-reduce of the gradient backward (every rank's partial input
  gradient summed);
* a row-parallel layer's product (``_RowLinear``, its
  ``precision.Linear.reduce``): an all-reduce of the partial products
  forward, the local Linear's backward.

So every replicated tensor carries its full gradient on every rank, and a
replicated parameter's gradient is the same on all of them.  Both sums
run in float32 and round once (``_RowLinear``; ``enter_columns`` and
``_ColumnLinear`` for the input gradient): one GEMM over all features
rounds its float32 accumulator once, and bf16 partial sums added in bf16
moved a ViT-L step's gradient by more than a change of attention
rounding does (``chip_smoke.py`` phase 13).

The fused ``qkv`` splits **head-aligned**: a rank keeps the q, k and v
rows of its ``H / m`` heads from the timm ``[q|k|v]`` layout, so its
attention runs at ``D / m`` with ``H / m`` heads of the same width.  JAX
splits the kernel contiguously, mid-q/k/v, and GSPMD re-partitions at its
q/k/v slices (:17-24); the math is the same.  The text tower's q / k / v
rows are one head after another, so its contiguous split is head-aligned
already.  A split that would cut a head raises.

``shard_state_tp`` slices the model's parameters and the AdamW moments
(which mirror them) in place and sets up the modules' collectives;
``gather_tp`` is the inverse of a slice, for checkpoints.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from egovlp_tpu_torch.core.collectives import all_gather_dim, all_reduce
from egovlp_tpu_torch.core.mesh import Mesh, param_shard, set_param_shard

_COLUMN = ("fc1", "ffn_lin1", "q_lin", "k_lin", "v_lin", "qkv")
_ROW = ("fc2", "ffn_lin2", "out_lin", "proj")
# the port's names of JAX's ffn_lin1 / ffn_lin2 (HuggingFace's ffn.lin1)
_ALIASES = {("ffn", "lin1"): "ffn_lin1", ("ffn", "lin2"): "ffn_lin2"}


def _layer_name(names) -> str:
    parent = names[-2] if len(names) > 1 else ""
    grand = names[-3] if len(names) > 2 else ""
    return _ALIASES.get((grand, parent), parent)


def split_dim(name: str, shape, n_model: int) -> Optional[int]:
    """The torch dim tensor parallelism splits the parameter ``name`` of
    ``shape`` on, or None (JAX's ``_spec_for``, transposed)."""
    if n_model <= 1 or not shape:
        return None
    names = name.split(".")
    leaf, layer = names[-1], _layer_name(names)
    if layer in _COLUMN:
        if leaf == "weight" and len(shape) == 2 and shape[0] % n_model == 0:
            return 0
        if leaf == "bias" and len(shape) == 1 and shape[0] % n_model == 0:
            return 0
    if layer in _ROW and leaf == "weight" and len(shape) == 2 \
            and shape[1] % n_model == 0:
        return 1
    return None


# An output that reaches no loss (the last block's patch path) passes None
# back through these, on every rank alike: no exchange, and the attention
# backward before it is skipped, as in one process.

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.set_materialize_grads(False)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (None if grad is None else all_reduce(grad, ctx.group)), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel region (see the module notes)."""
    return _CopyToModel.apply(x, group)


def mm_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``a`` ``[..., K]``, ``b`` ``[K, N]``, one dtype) with
    float32 sums: bf16 products are exact in float32, so this is the
    tensor-core GEMM's accumulator before its rounding (on CUDA the GEMM
    itself, ``out_dtype=float32``)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(*a.shape[:-1], -1)
    return a.float() @ b.float()


class _ColumnLinear(torch.autograd.Function):
    """A column-parallel Linear on the float32 copy of its input: the
    forward casts it back and runs ``precision.linear``; the backward
    returns the input gradient with float32 sums, so that the model
    group's all-reduce of the partial input gradients (``copy_to_model``
    on the float32 input) rounds once, where one GEMM over all output
    features would."""

    @staticmethod
    def forward(ctx, x32, weight, bias, dtype):
        x, w = x32.to(dtype), weight.to(dtype)
        ctx.save_for_backward(x, w)
        ctx.bias = bias is not None
        ctx.set_materialize_grads(False)
        y = F.linear(x, w)
        return y if bias is None else y + bias.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None, None
        x, w = ctx.saved_tensors
        rows = dy.reshape(-1, dy.shape[-1])
        dw = (rows.t() @ x.reshape(-1, x.shape[-1])).float()
        db = rows.sum(0).float() if ctx.bias else None
        return mm_float32(dy, w), dw, db, None


class _RowLinear(torch.autograd.Function):
    """A row-parallel Linear's product (no bias): the partial products
    with float32 sums, all-reduced in float32 and rounded once, as one
    GEMM over all input features rounds; the backward is the local
    Linear's (the input gradient needs no reduction)."""

    @staticmethod
    def forward(ctx, x, weight, group):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.set_materialize_grads(False)
        return all_reduce(mm_float32(x, w.t()), group).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return None, None, None
        x, w = ctx.saved_tensors
        rows = dy.reshape(-1, dy.shape[-1])
        dw = (rows.t() @ x.reshape(-1, x.shape[-1])).float()
        return dy @ w, dw, None


def column_linear(x32: torch.Tensor, layer, dtype) -> torch.Tensor:
    """``layer`` (a column-parallel ``Linear``) on ``copy_to_model``'s
    float32 input, in ``dtype``."""
    return _ColumnLinear.apply(x32, layer.weight, layer.bias, dtype)


def enter_columns(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 input of a column-parallel region."""
    return copy_to_model(x.float(), group)


def shard_slice(t: torch.Tensor, dim: int, qkv: bool, rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank``'s part of the full ``t`` split ``size`` ways on
    ``dim`` (``qkv``: the head-aligned q, k and v rows)."""
    if qkv:
        return t.unflatten(0, (3, size, -1))[:, rank].flatten(0, 1)
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def gather_tp(t: torch.Tensor, dim: int, qkv: bool, group) -> torch.Tensor:
    """The full tensor from every model rank's ``shard_slice``."""
    if not qkv:
        return all_gather_dim(t, dim, group)
    parts = all_gather_dim(t[None], 0, group)  # [m, 3 D / m, ...]
    return parts.unflatten(1, (3, -1)).transpose(0, 1).flatten(0, 2)


def _slice_(p: torch.nn.Parameter, optimizer, dim: int, qkv: bool,
            rank: int, size: int) -> None:
    """``p`` and its AdamW moments replaced by this rank's slices."""
    with torch.no_grad():
        p.data = shard_slice(p.data, dim, qkv, rank, size).clone()
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for k, v in list(state.items()):
            if torch.is_tensor(v) and v.shape == param_shard(p).full_shape:
                state[k] = shard_slice(v, dim, qkv, rank, size).clone()


def shard_state_tp(model: torch.nn.Module, optimizer, mesh: Mesh,
                   skip: tuple = ()) -> int:
    """Split ``model`` (and ``optimizer``'s moments) over ``mesh``'s model
    group in place, except the submodules named in ``skip`` (the video
    tower under sequence parallelism); returns the number of parameters
    split.  Every attention, MLP and FFN whose weights the rules split
    gets the collectives and its local head count; a layer pair split on
    one side only, or a split that cuts a head, raises."""
    from egovlp_tpu_torch.models.text_tower import FFN, SelfAttention
    from egovlp_tpu_torch.models.video_tower import Mlp, VarAttention

    m, rank, group = mesh.model.size, mesh.model.rank, mesh.model.group
    if m <= 1:
        return 0
    pairs = {VarAttention: ("qkv", "proj", "num_heads"),
             SelfAttention: (("q_lin", "k_lin", "v_lin"), "out_lin",
                             "n_heads"),
             Mlp: ("fc1", "fc2", None), FFN: ("lin1", "lin2", None)}
    n = 0
    for prefix, mod in model.named_modules():
        kind = pairs.get(type(mod))
        if kind is None or any(prefix == s or prefix.startswith(s + ".")
                               for s in skip):
            continue
        cols, row, heads_attr = kind
        cols = (cols,) if isinstance(cols, str) else cols
        layers = [getattr(mod, c) for c in cols] + [getattr(mod, row)]
        split = {}
        for layer, lname in zip(layers, cols + (row,)):
            for pname, p in layer.named_parameters():
                split[p] = split_dim(f"{prefix}.{lname}.{pname}",
                                     tuple(p.shape), m)
        weights = [split[l.weight] for l in layers]
        if all(d is None for d in weights):
            continue
        if weights != [0] * len(cols) + [1]:
            raise ValueError(f"{prefix}: tensor parallelism over {m} "
                             f"ranks splits only part of its layers "
                             f"({dict(zip(cols + (row,), weights))})")
        if heads_attr is not None:
            heads = getattr(mod, heads_attr)
            if heads % m:
                raise ValueError(f"{prefix}: {heads} heads do not split "
                                 f"over {m} model ranks")
            setattr(mod, heads_attr, heads // m)
        for p, d in split.items():
            if d is None:
                continue
            qkv = type(mod) is VarAttention and d == 0
            set_param_shard(p, tp_dim=d, qkv=qkv)
            _slice_(p, optimizer, d, qkv, rank, m)
            n += 1
        mod.tp_group = group
        getattr(mod, row).reduce = _row_reduce(group)
    return n


def _row_reduce(group):
    def reduce(x, weight):
        return _RowLinear.apply(x, weight, group)
    return reduce
