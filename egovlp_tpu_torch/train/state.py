"""Optimizer and learning-rate schedule.

Counterpart of ``egovlp_tpu/train/state.py``.  The JAX ``TrainState`` has
no counterpart: the model and the optimizer are the state.

* ``make_step_lr``: step-LR decay at epoch milestones; the optimizer reads
  it with the step count BEFORE the increment (:71, :120), so epoch e
  trains at ``base * gamma^{#milestones <= e - 1}``.
* ``AdamW``: one optimizer with the JAX package's two update rules, eps
  1e-6 always (:166-174):

  - ``rule='optax'`` (``optax.adamw``; also the JAX ``'fused'`` variant,
    :97-142, the same math): eps on ``sqrt(nu_hat)``, decoupled decay
    folded into the update, ``p -= lr * (mu_hat / (sqrt(nu_hat) + eps)
    + wd * p)``;
  - ``rule='reference'`` (``adamw_reference`` :39-94, transformers.AdamW):
    eps on ``sqrt(nu)`` before bias correction, decay applied to the
    updated parameter.

  ``mu_dtype='bfloat16'`` stores the first moment in bf16 (the fine-tune
  configs); the update runs in float32, except that the optax rule, as
  optax does, scales the stored moment by b1 rounded to the moment's
  dtype.  ``torch.optim.AdamW`` is
  not used: its eps placement is the optax one only.

  ``max_grad_norm`` (:149, :178-179) clips the gradients by their global
  norm before the update, as ``optax.clip_by_global_norm`` chained in
  front: with ``n = ||g||`` over every parameter, each gradient becomes
  ``(g / n) * max_grad_norm`` when ``n >= max_grad_norm`` and stays as it
  is otherwise (no host sync: the choice is a ``torch.where``).  As in
  the JAX package, ``run_task`` reads no config key for it.

  Under a mesh (``core/zero.apply_mesh``) ``mesh_update`` is set: the step
  first reduces the gradients over the mesh, updates this rank's ZeRO
  slices and then gathers or releases them; the clip's norm is the
  global one.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

RULES = {"optax": "optax", "fused": "optax", "reference": "reference"}
B1, B2, EPS = 0.9, 0.999, 1e-6


def make_step_lr(base_lr: float, milestones: Sequence[int],
                 steps_per_epoch: int, gamma: float = 0.1
                 ) -> Callable[[int], float]:
    """``schedule(count) = base_lr * gamma^{#milestones <= count // spe}``."""
    ms = list(milestones)

    def schedule(count: int) -> float:
        completed_epochs = count // max(steps_per_epoch, 1)  # = e - 1
        return base_lr * gamma ** sum(completed_epochs >= m for m in ms)

    return schedule


def _f32(x) -> float:
    """``x`` rounded to float32, as the JAX package's scalars are."""
    return float(np.float32(x))


class AdamW(torch.optim.Optimizer):
    """AdamW with the JAX package's update rules (see the module notes).

    The step count lives in ``param_groups[0]['count']`` (a Python int),
    so ``state_dict()`` carries it and the learning rate is resolved on the
    host with no device sync."""

    def __init__(self, params, schedule: Callable[[int], float],
                 rule: str = "optax", weight_decay: float = 0.0,
                 mu_dtype: Optional[str] = None,
                 max_grad_norm: Optional[float] = None):
        if rule not in ("optax", "reference"):
            raise ValueError(f"AdamW rule {rule!r}: expected 'optax' or "
                             "'reference'")
        if mu_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(f"mu_dtype {mu_dtype!r}: expected None, "
                             "'float32' or 'bfloat16'")
        super().__init__(params, dict(rule=rule, weight_decay=weight_decay,
                                      mu_dtype=mu_dtype, count=0))
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.mesh_update = None  # core.zero.MeshUpdate

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        params = [[p for p in group["params"] if p.grad is not None]
                  for group in self.param_groups]
        mesh = self.mesh_update
        if mesh is None:
            grads = [[p.grad.float() for p in ps] for ps in params]
            targets = params
        else:
            grads, targets = mesh.gradients(params)
        if self.max_grad_norm:
            grads = clip_by_global_norm(
                grads, self.max_grad_norm,
                None if mesh is None else functools.partial(
                    mesh.norm_sq, params=[p for ps in params for p in ps]))
        for group, ps, ts, gs in zip(self.param_groups, params, targets,
                                     grads):
            if ps:
                self._update(group, ts, gs, keys=ps)
            group["count"] += 1
        if mesh is not None:
            mesh.finish()

    def _update(self, group, params, grads, keys=None):
        """One step over ``params`` with their float32 ``grads``, in
        multi-tensor (``_foreach``) ops: a few launches per step instead of
        a dozen per parameter.  ``keys``: the parameters whose state the
        moments are (``params`` may be views of their ZeRO slices)."""
        count = group["count"]
        lr = _f32(self.schedule(count))
        b1, b2, eps = B1, B2, EPS
        wd = group["weight_decay"]
        t = np.float32(count + 1)
        bc1 = _f32(np.float32(1) - np.float32(b1) ** t)
        bc2 = _f32(np.float32(1) - np.float32(b2) ** t)
        mu_dtype = getattr(torch, group["mu_dtype"] or "float32")
        keys = params if keys is None else keys
        for k, p in zip(keys, params):
            st = self.state[k]
            if not st:
                st["mu"] = torch.zeros_like(p, dtype=mu_dtype)
                st["nu"] = torch.zeros_like(p, dtype=torch.float32)
        mus = [self.state[k]["mu"] for k in keys]
        nus = [self.state[k]["nu"] for k in keys]
        m = [mu.float() for mu in mus]
        if group["rule"] == "optax":
            # optax's update_moment multiplies the moment by a weakly typed
            # b1, which takes the moment's dtype: with a bf16 moment b1 is
            # 0.8984375 (the product itself is float32 in the JAX
            # package's CPU runs)
            m = torch._foreach_mul(m, float(torch.tensor(b1, dtype=mu_dtype)))
            m = torch._foreach_add(torch._foreach_mul(grads, 1.0 - b1), m)
        else:
            m = torch._foreach_add(torch._foreach_mul(m, b1),
                                   torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
        if group["rule"] == "optax":
            # p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)
            den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(torch._foreach_div(m, bc1), den)
            if wd:
                u = torch._foreach_add(u, torch._foreach_mul(params, wd))
            torch._foreach_add_(params, u, alpha=-lr)
        else:
            # delta = -step_size * mu / (sqrt(nu) + eps), decay on p + delta
            step_size = _f32(np.float32(lr) * np.sqrt(np.float32(bc2))
                             / np.float32(bc1))
            den = torch._foreach_sqrt(nus)
            torch._foreach_add_(den, eps)
            delta = torch._foreach_div(torch._foreach_mul(m, -step_size), den)
            if wd:
                decay = torch._foreach_mul(torch._foreach_add(params, delta),
                                           lr * wd)
                delta = torch._foreach_sub(delta, decay)
            torch._foreach_add_(params, delta)
        torch._foreach_copy_(mus, m)


def clip_by_global_norm(grads, max_norm: float, norm_sq=None):
    """``optax.clip_by_global_norm`` on lists of float32 gradients: all
    scaled by ``max_norm / n`` (as ``(g / n) * max_norm``) when their
    global norm ``n`` is at least ``max_norm``, else unchanged.
    ``norm_sq``: each tensor's squared norm -> the global squared norm
    (a mesh's shards; default: their sum)."""
    flat = [g for gs in grads for g in gs]
    if not flat:
        return grads
    norms = torch.stack(torch._foreach_norm(flat))
    norm = norms.norm() if norm_sq is None else norm_sq(norms ** 2).sqrt()
    keep = norm < max_norm
    return [[torch.where(keep, g, (g / norm) * max_norm) for g in gs]
            for gs in grads]


def make_optimizer(model: torch.nn.Module, base_lr: float = 3e-5,
                   milestones: Sequence[int] = (60, 80),
                   steps_per_epoch: int = 1, weight_decay: float = 0.0,
                   max_grad_norm: Optional[float] = None,
                   gamma: float = 0.1, mu_dtype: Optional[str] = None,
                   variant: str = "optax"
                   ) -> Tuple[AdamW, Callable[[int], float]]:
    """AdamW over the model's parameters and its step-LR schedule.
    ``variant``: 'optax', 'fused' (both the optax rule) or 'reference';
    ``max_grad_norm``: the global-norm clip before the update."""
    if variant not in RULES:
        raise ValueError(f"optimizer variant {variant!r}: expected 'optax', "
                         "'reference', or 'fused'")
    schedule = make_step_lr(base_lr, milestones, steps_per_epoch, gamma)
    opt = AdamW(model.parameters(), schedule, rule=RULES[variant],
                weight_decay=weight_decay, mu_dtype=mu_dtype,
                max_grad_norm=max_grad_norm)
    return opt, schedule
