"""The port's EPIC MIR, OSCC and PNR steps in a world of 2 on the CPU
(gloo ranks as subprocesses of ``tests/torch_ddp_worker.py``, as
``tests/test_torch_ddp.py`` starts them).

The adaptive max-margin step, float32: each rank's half of one global
batch, wrapped in ``DistributedDataParallel``, against the one-process
port step on the whole batch: the loss within rtol 1e-5, every parameter's
DDP-averaged gradient within rtol 1e-5 (a floor of 1e-6 of the largest
for the float32 noise of gradients that are zero in exact arithmetic),
their norm ratio within 1e-5 of 1 (the ranking loss's mean runs over the
global n: a 1/N slip reads 0.5) and their cosine; and the one-process
loss against the JAX package's ``make_epic_train_step`` on that batch.
All take JAX's crop boxes for the global batch; ``relation`` is
all-gathered with the embeddings.

The video-only OSCC and PNR steps, float32 at 16 frames, go through the
``DistributedDataParallel`` wrapper that searches for unused parameters
(the text tower).  Against one process on the concatenated batch: the
loss and every video-side gradient within rtol 1e-5 (the same floor),
equal on both ranks, so all-reduced (a step that called the unwrapped
model's ``encode_video`` would keep each rank's own gradient); no text
parameter gets a gradient on either rank.  PNR's second rank has a
state-change flag of 0, so its rows' mean differs from the global
``sum(nll * mask) / sum(mask)``.  Rank 0's checkpoint, written through
DDP, loads strictly into a one-process ``cli.eval``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.state import make_optimizer as jax_make_optimizer
from egovlp_tpu.train.steps import make_epic_train_step as jax_make_epic_step
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.train import steps as port_steps
from egovlp_tpu_torch.train.state import make_optimizer
from egovlp_tpu_torch.cli import eval as cli_eval
from tests.test_torch_ddp import start_workers, wait_all
from tests.test_torch_finetune import PRE, ft_batch, ft_vocab  # noqa: F401
from tests.test_torch_oscc_pnr import (  # noqa: F401
    HEADS,
    VIDEO16,
    ego4d_root,
    sc_batch,
    sc_config,
    text_keys,
)
from tests.test_torch_oscc_pnr import port_model as sc_port_model
from tests.test_torch_oscc_pnr import random_params as sc_random_params
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)
from tests.test_torch_train import SCHED, jax_boxes


def test_epic_step_at_world_2_is_the_global_batch_step(tmp_path,
                                                       monkeypatch):
    world, b = 2, 2
    loss_type, margin = "AdaptiveMaxMarginRankingLoss", 0.4
    params = random_params(14)
    batch = ft_batch(30, b=world * b)  # the global batch
    key = jax.random.split(jax.random.PRNGKey(4))[0]  # JAX's transform key
    boxes = jax_boxes(key, world * b, PRE)
    inputs = {k: torch.from_numpy(v) for k, v in
              port_steps.numeric_batch(batch).items()}
    (tmp_path / "model.json").write_text(json.dumps({
        "video": {**VIDEO, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES, "step": "epic", "loss_type": loss_type,
        "margin": margin}))
    torch.save(params_from_jax(params), tmp_path / "weights.pt")
    torch.save({"batch": inputs, "boxes": boxes[0], "flips": boxes[1]},
               tmp_path / "batch.pt")
    procs = start_workers("step", world, tmp_path)

    # meanwhile: one process on the whole batch, and the JAX step
    model = port_model(params)
    opt, _ = make_optimizer(model, **SCHED)
    grads, update = {}, opt.step

    def recorded_step():
        grads.update({k: p.grad.clone() for k, p in model.named_parameters()})
        update()

    opt.step = recorded_step
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, n, src: boxes)
    loss = port_steps.make_epic_train_step(
        loss_type=loss_type, input_res=RES, margin=margin)(
            model, opt, inputs, torch.Generator())
    state = create_train_state(JaxDualEncoder(jax_config("xla")), params,
                               jax_make_optimizer(**SCHED))
    _, jax_loss = jax_make_epic_step(loss_type=loss_type, input_res=RES,
                                     margin=margin)(
        state, batch, jax.random.PRNGKey(4))
    # float32 through both towers and the ranking loss
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-5)

    wait_all(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert ranks[0]["loss"].item() == ranks[1]["loss"].item()
    np.testing.assert_allclose(ranks[0]["loss"].item(), loss.item(),
                               rtol=1e-5)
    missing = [k for k, g in ranks[0]["grads"].items() if g is None]
    assert not missing, f"parameters without a gradient: {missing}"
    g_max = max(g.abs().max().item() for g in grads.values())
    for k, want in grads.items():
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        # float32: DDP adds the two halves' gradients, one backward sums
        # the whole batch in another order; a floor of 1e-6 of the largest
        # gradient for the key biases' float32 noise (zero in exact
        # arithmetic)
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(),
                                   want.numpy(), rtol=1e-5,
                                   atol=1e-6 * g_max, err_msg=k)
    g = torch.cat([ranks[0]["grads"][k].flatten() for k in grads]).double()
    w = torch.cat([grads[k].flatten() for k in grads]).double()
    # the mean runs over the global n: a 1/N slip reads a ratio of 0.5
    assert abs((g.norm() / w.norm()).item() - 1) < 1e-5
    assert (g @ w / (g.norm() * w.norm())).item() > 1 - 1e-9


@pytest.mark.parametrize("task", ["oscc", "pnr"])
def test_video_only_step_at_world_2_is_the_global_batch_step(
        task, tmp_path, monkeypatch, ego4d_root, ft_vocab):  # noqa: F811
    world, b, proj = 2, 2, HEADS[task]
    params = sc_random_params(80 + proj, proj)
    batch = sc_batch(81 + proj, b=world * b, states=(1, 1, 1, 0))
    boxes = jax_boxes(jax.random.PRNGKey(6), world * b, PRE)
    inputs = {k: torch.from_numpy(v) for k, v in
              port_steps.numeric_batch(batch).items()}
    (tmp_path / "model.json").write_text(json.dumps({
        "video": {**VIDEO16, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES, "step": task, "proj": proj}))
    torch.save(params_from_jax(params), tmp_path / "weights.pt")
    torch.save({"batch": inputs, "boxes": boxes[0], "flips": boxes[1]},
               tmp_path / "batch.pt")
    procs = start_workers("step", world, tmp_path)

    # meanwhile: one process on the whole batch
    model = sc_port_model(params, proj)
    opt, _ = make_optimizer(model, **SCHED)
    grads, update = {}, opt.step

    def recorded_step():
        grads.update({k: None if p.grad is None else p.grad.clone()
                      for k, p in model.named_parameters()})
        update()

    opt.step = recorded_step
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, n, src: boxes)
    make = (port_steps.make_oscc_train_step if task == "oscc"
            else port_steps.make_pnr_train_step)
    loss = make(input_res=RES)(model, opt, inputs, torch.Generator())

    wait_all(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert ranks[0]["loss"].item() == ranks[1]["loss"].item()
    np.testing.assert_allclose(ranks[0]["loss"].item(), loss.item(),
                               rtol=1e-5)
    text = set(text_keys(model))
    g_max = max(g.abs().max().item() for g in grads.values()
                if g is not None)
    for k, want in grads.items():
        if k in text:  # no gradient, so none to all-reduce
            assert want is None, k
            assert all(r["grads"][k] is None for r in ranks), k
            continue
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(),
                                   want.numpy(), rtol=1e-5,
                                   atol=1e-6 * g_max, err_msg=k)
    # the step trained the video side only, the same on both ranks
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
        assert torch.equal(v, model.state_dict()[k]) or k not in text, k

    # rank 0's checkpoint, written through DDP, in a one-process cli.eval
    (ckpt,) = (tmp_path / "ckpt").iterdir()
    cfg = sc_config(task, ego4d_root, ft_vocab, "", str(tmp_path / "eval"))
    (tmp_path / "eval.json").write_text(json.dumps(cfg))
    metrics = cli_eval.main(["--config", str(tmp_path / "eval.json"),
                             "--checkpoint", str(ckpt), "--device", "cpu"])
    key = "accuracy" if task == "oscc" else "keyframe_distance"
    assert set(metrics) == {key} and metrics[key] >= 0.0
