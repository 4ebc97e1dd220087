"""The port's ring similarity (``objectives/ring.py``) on the CPU.

* Without a process group ``global_sim='ring'`` is the gather step (JAX
  falls back the same way without a data mesh).
* At worlds 2 and 4 over gloo (``tests/torch_ddp_worker.py ring``, one
  process a rank), EgoNCE and InfoNCE: every rank's loss is the one-process
  loss of the gathered global batch (``objectives.contrastive`` on
  ``sim_matrix``), with scene negatives (a rank holds ``[pos_r; neg_r]``,
  not one contiguous block of ``[pos_all; neg_all]``) and verb / noun
  classes repeated across ranks, as JAX ``tests/test_multichip.py:406-455``
  builds them; and each rank's gradient of its ``t`` and ``v`` rows is N
  times the one-process gradient of the global loss at those rows (what
  ``all_gather_rows`` gives, so that DDP's mean is d L / d theta).
  float32, rtol 1e-5: the same sums in another order.
* The EgoClip step through ``DistributedDataParallel`` at world 2 with
  ``global_sim='ring'`` against the one-process step on the global batch:
  loss and every gradient.
"""

import json

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.models.dual_encoder import sim_matrix
from egovlp_tpu_torch.objectives.contrastive import egonce, info_nce
from egovlp_tpu_torch.train import steps as port_steps
from tests.test_torch_ddp import (
    one_process_step,
    port_inputs,
    start_workers,
    wait_all,
)
from tests.test_torch_models import RES, TEXT, VIDEO, random_params
from tests.test_torch_train import SCHED, egoclip_batch, jax_boxes


class NoUpdate:
    def __init__(self, m):
        self.m = m

    def zero_grad(self, set_to_none=True):
        self.m.zero_grad(set_to_none=set_to_none)

    def step(self):
        pass


def test_ring_without_a_group_is_the_gather_step():
    from tests.test_torch_models import port_model

    params = random_params(4)
    batch = port_inputs(egoclip_batch(6, b=3))
    out = {}
    for sim in ("gather", "ring"):
        model = port_model(params)
        loss = port_steps.make_egoclip_train_step(
            input_res=RES, global_sim=sim)(
                model, NoUpdate(model), batch, torch.Generator().manual_seed(0))
        out[sim] = loss, {k: p.grad for k, p in model.named_parameters()}
    assert torch.equal(out["ring"][0], out["gather"][0])
    for k, g in out["gather"][1].items():
        assert torch.equal(out["ring"][1][k], g), k


def _global_batch(n, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    # classes repeated across ranks
    noun = torch.eye(12)[torch.arange(n) % 5]
    verb = torch.eye(6)[torch.arange(n) % 3]
    return t, v, noun, verb


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("loss_type", ["EgoNCE", "InfoNCE"])
def test_ring_loss_across_processes_is_the_gathered_loss(world, loss_type,
                                                         tmp_path):
    b = 3  # positives a rank; with its negatives, 6 rows a rank
    n = 2 * world * b
    t, v, noun, verb = _global_batch(n, world)
    torch.save({"t": t, "v": v, "noun_vec": noun, "verb_vec": verb,
                "loss_type": loss_type}, tmp_path / "ring.pt")
    procs = start_workers("ring", world, tmp_path)

    tg, vg = t.clone().requires_grad_(), v.clone().requires_grad_()
    sim = sim_matrix(tg, vg)
    if loss_type == "EgoNCE":
        want = egonce(sim, sim_matrix(verb, verb), sim_matrix(noun, noun))
    else:
        want = info_nce(sim)
    want.backward()
    wait_all(procs)
    for r in range(world):
        got = torch.load(tmp_path / f"rank{r}.pt")
        mine = port_steps._global_rows(b, r, world, True)
        np.testing.assert_allclose(got["loss"].item(), want.item(),
                                   rtol=1e-5)
        for name, g in (("dt", tg.grad), ("dv", vg.grad)):
            np.testing.assert_allclose(got[name].numpy(),
                                       world * g[mine].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} rank {r}")


def test_ring_step_at_world_2_is_the_global_batch_step(tmp_path,
                                                       monkeypatch):
    world, b = 2, 2
    params = random_params(8)
    batch = egoclip_batch(12, b=world * b)
    key = jax.random.split(jax.random.PRNGKey(3))[0]
    boxes = jax_boxes(key, 2 * world * b, batch["frames"].shape[2])
    (tmp_path / "model.json").write_text(json.dumps({
        "video": {**VIDEO, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES, "global_sim": "ring"}))
    torch.save(params_from_jax(params), tmp_path / "weights.pt")
    torch.save({"batch": port_inputs(batch), "boxes": boxes[0],
                "flips": boxes[1]}, tmp_path / "batch.pt")
    procs = start_workers("step", world, tmp_path)
    loss, grads, _ = one_process_step(params, batch, boxes, monkeypatch)
    wait_all(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert ranks[0]["loss"].item() == ranks[1]["loss"].item()
    np.testing.assert_allclose(ranks[0]["loss"].item(), loss.item(),
                               rtol=1e-5)
    # float32, sums in another order; the key biases' gradients are
    # float32 noise (zero in exact arithmetic): an absolute floor of 1e-6
    # of the largest gradient, as the gather test at world 2 states
    g_max = max(g.abs().max().item() for g in grads.values())
    for k, want in grads.items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(),
                                   want.numpy(), rtol=1e-5,
                                   atol=1e-6 * g_max, err_msg=k)
