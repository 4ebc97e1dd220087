"""Processes of a multi-process run under ``torch.distributed``.

Counterpart of ``jax.distributed.initialize()`` and
``jax.process_index()`` / ``jax.process_count()`` in the JAX package: one
process per GPU, started by ``torchrun`` (or any launcher that sets its
environment), all in one process group.

* ``init_distributed`` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), makes
  ``cuda:{LOCAL_RANK}`` the current device before the group is made and
  binds the group to it, and gives the group a timeout, so that a rank
  that dies fails its peers' collectives within that time instead of
  leaving them blocked.  The backend follows the device: NCCL for
  ``cuda``, gloo for ``cpu``.  A caller may name the backend (two ranks on
  one GPU need gloo: NCCL refuses two ranks on one device); a backend that
  fails to start raises, and nothing falls back to another.
* ``in_process_group``, ``process_shard`` (rank, world size),
  ``is_main_process``, ``barrier``
  and ``broadcast_object`` work with and without a group: without one
  (or at world 1) they are the one-process answers and no-ops.
* ``unwrap``: the module inside a ``DistributedDataParallel`` wrapper,
  which validation and checkpoints use.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

# a collective that waits longer fails: seconds, not the 30 minutes of
# torch's default, yet room for rank 0 to write a full checkpoint while
# the others wait at the barrier after it
TIMEOUT_S = 60.0


def init_distributed(device: str = "cuda", backend: Optional[str] = None
                     ) -> Tuple[int, int]:
    """Join the process group torchrun's environment describes; returns
    ``(rank, world size)``.  ``device`` is ``'cuda'`` or ``'cpu'``;
    ``backend`` defaults to NCCL on ``cuda`` and gloo on ``cpu``."""
    if in_process_group():
        raise RuntimeError("init_distributed: the process group is already "
                           "initialized")
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                          "MASTER_PORT")}
    missing = sorted(k for k, v in env.items() if v is None)
    if missing:
        raise RuntimeError(
            f"init_distributed: {', '.join(missing)} not set; start the "
            "processes with torchrun (or set RANK, WORLD_SIZE, LOCAL_RANK, "
            "MASTER_ADDR and MASTER_PORT)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed: device {device!r}: expected "
                         "'cuda' or 'cpu'")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    bound = None
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device is available (pass "
                "device='cpu' for gloo on the CPU)")
        bound = torch.device("cuda", local_rank())
        torch.cuda.set_device(bound)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), device_id=bound)
    return rank, world


def local_rank() -> int:
    """This process's GPU on its host (torchrun's ``LOCAL_RANK``; 0)."""
    return int(os.environ.get("LOCAL_RANK", 0))


def in_process_group() -> bool:
    """Whether this process has joined a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def process_shard() -> Tuple[int, int]:
    """(rank, world size) of ``torch.distributed``; (0, 1) without it."""
    if in_process_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    return process_shard()[0] == 0


def barrier() -> None:
    """Wait for every rank; a no-op in one process."""
    if process_shard()[1] > 1:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (pickled); ``obj`` itself in
    one process."""
    if process_shard()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module a ``DistributedDataParallel`` wraps; ``model`` itself
    otherwise."""
    if isinstance(model, DistributedDataParallel):
        return model.module
    return model
