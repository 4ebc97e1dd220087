"""The hand-written kernels as operators the PyTorch dispatcher knows.

Every kernel wrapper of ``cuda_attention.py`` (K1, K2, K4, K5, forward
and backward) and ``fused_ln.py`` (K3, forward and backward) is defined
as an op ``torch.ops.egovlp_torch.<name>`` with three implementations:

* ``CUDA``: the wrapper's launcher, which launches the kernel on the
  inputs' device (counted in ``cuda_attention.launches``) or raises;
* ``CPU``: the kernel's plain PyTorch twin, chosen by the dispatcher
  because the tensors lie on the CPU, never after a failed launch;
* fake: the outputs' shapes and dtypes after the launcher's own checks,
  so that ``torch.export`` captures one node per kernel call and fails
  where a launch would.

An op's outputs share no storage with each other or with its inputs:
outputs that a launcher allocates together are returned as one stacked
tensor and unbound by the wrapper outside the op.

The ops are defined with ``torch.library.Library`` (``define`` / ``impl``
/ ``register_fake``) rather than ``torch.library.custom_op``: both go
through the dispatcher, but ``custom_op`` adds a Python wrapper and an
autograd registration to every call (``PERF.md``, section 6, holds the
cost of each on the card).  Importing ``cuda_attention`` or ``fused_ln``
defines their ops; a saved ``torch.export`` program that calls them needs
that import before ``torch.export.load``.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "egovlp_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cpu: Callable, cuda: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define ``egovlp_torch::{name}{schema}`` with its CPU, CUDA and fake
    implementations; returns the op's default overload."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
