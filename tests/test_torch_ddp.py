"""The port's data parallelism on the CPU: gloo ranks as subprocesses.

Each test starts one ``tests/torch_ddp_worker.py`` process a rank, with
torchrun's environment, and waits for each with a timeout.

* ``core.dist`` without a group (the one-process answers) and its
  refusals; the device and config checks of a world of 2 (a drop-path
  rate is taken);
* ``all_gather_rows`` at worlds 1, 2 and 4: the identity at world 1;
  forward, every rank's rows in rank order; backward, the sum over the
  ranks of the incoming gradient, this rank's rows (a reduce-scatter, so
  that DDP's mean gives the gradient of the global loss);
* the EgoClip step at world 2, float32, the two halves of one global
  batch against the one-process port step on the whole batch: the loss,
  every parameter's gradient before the optimizer and every parameter
  after one AdamW step, within rtol 1e-5 (float32 sums in another order:
  DDP adds the two halves' gradients; the floors for gradients at the
  float32 noise level are stated in the test); and its loss against the JAX
  package's ``make_egoclip_train_step`` on that batch from the same
  weights, within rtol 1e-5.  All three take JAX's crop boxes for the
  global batch.  A gradient N times too small would fail the first
  comparison, which holds the gradients themselves, not AdamW's update;
* ``gather_eval`` / ``gather_arrays`` / ``gather_objects`` at world 2 on
  10 items split unevenly (7 rows and 4, one a pad duplicate): both ranks
  get the one-process rows in JAX ``gather_eval``'s order, and the
  one-process EgoMCQ accuracies.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu.core.dist_eval import gather_eval as jax_gather_eval
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.state import make_optimizer as jax_make_optimizer
from egovlp_tpu.train.steps import (
    make_egoclip_train_step as jax_make_egoclip_train_step,
)
from egovlp_tpu_torch.core import dist
from egovlp_tpu_torch.core.collectives import all_gather_rows
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.metrics.egomcq import egomcq_accuracy_metrics
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.train import recipes
from egovlp_tpu_torch.train import steps as port_steps
from egovlp_tpu_torch.train.state import make_optimizer
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)
from tests.test_torch_train import SCHED, egoclip_batch, jax_boxes

WORKER = Path(__file__).with_name("torch_ddp_worker.py")
ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def process_env() -> dict:
    """A subprocess's environment: the repository importable, one thread
    (tiny models; the test workers share the machine)."""
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


def rank_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank on this host."""
    return {**process_env(), "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def wait_all(procs, timeout: float = 120.0):
    """Each process's output; every process must exit 0 within
    ``timeout`` (the others are killed when one does not)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out}"
    return outs


def start_workers(mode: str, world: int, out: Path):
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(out)],
        env=rank_env(r, world, port), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def test_one_process_answers_without_a_group():
    x = torch.randn(3, 4, requires_grad=True)
    assert all_gather_rows(x) is x
    assert not dist.in_process_group()
    assert dist.process_shard() == (0, 1) and dist.is_main_process()
    dist.barrier()
    assert dist.broadcast_object({"a": 1}) == {"a": 1}
    model = torch.nn.Linear(2, 2)
    assert dist.unwrap(model) is model
    assert recipes.data_parallel(model, torch.device("cpu")) is model


def test_init_distributed_needs_torchruns_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, "
                                           "RANK, WORLD_SIZE not set"):
        dist.init_distributed("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    # NCCL on the card is the default, and nothing falls back to the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.init_distributed()
    assert not torch.distributed.is_initialized()


def test_world_2_device_and_config_checks(monkeypatch):
    """In a world of 2: 'cuda' is this rank's GPU (the one DDP binds to),
    the data-parallel size must be 2, and a drop-path rate is taken (its
    masks are the global batch's: ``tests/test_torch_tp_sp.py``)."""
    monkeypatch.setattr(recipes, "process_shard", lambda: (1, 2))
    monkeypatch.setattr(recipes, "in_process_group", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert recipes.resolve_device("cuda") == torch.device("cuda", 3)
    assert recipes.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert recipes.resolve_device("cpu") == torch.device("cpu")
    cfg = Config({"task": "egoclip", "n_devices": 2, "mesh": {"data": 2}})
    recipes.check_ported(cfg)
    for key, value in (("n_devices", 4), ("mesh.data", 1)):
        bad = cfg.clone().override(key, value)
        with pytest.raises(ValueError, match=f"{key}={value} but the world "
                                             "size is 2"):
            recipes.check_ported(bad)
    cfg.override("arch.args.video_params.drop_path_rate", 0.1)
    recipes.check_ported(cfg)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_all_gather_rows_across_processes(world, tmp_path):
    outs = wait_all(start_workers("gather", world, tmp_path))
    for rank, out in enumerate(outs):
        assert f"GATHER_OK rank {rank} of {world}" in out, out


# --------------------------------------------------------------------------
# the EgoClip step at world 2
# --------------------------------------------------------------------------

def port_inputs(batch):
    return {k: torch.from_numpy(v) for k, v in
            port_steps.numeric_batch(batch).items()}


def one_process_step(params, batch, boxes, monkeypatch):
    """The port's one-process step on the whole batch: (loss, gradients
    before the optimizer, parameters after it)."""
    model = port_model(params)
    opt, _ = make_optimizer(model, **SCHED)
    grads, update = {}, opt.step

    def recorded_step():
        grads.update({k: p.grad.clone()
                      for k, p in model.named_parameters()})
        update()

    opt.step = recorded_step
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, n, src: boxes)
    loss = port_steps.make_egoclip_train_step(input_res=RES)(
        model, opt, port_inputs(batch), torch.Generator())
    return loss, grads, model.state_dict()


def test_egoclip_step_at_world_2_is_the_global_batch_step(tmp_path,
                                                          monkeypatch):
    world, b = 2, 2
    params = random_params(5)
    batch = egoclip_batch(11, b=world * b)  # the global batch, 8 rows
    key = jax.random.split(jax.random.PRNGKey(3))[0]  # JAX's transform key
    boxes = jax_boxes(key, 2 * world * b, batch["frames"].shape[2])
    (tmp_path / "model.json").write_text(json.dumps({
        "video": {**VIDEO, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES}))
    torch.save(params_from_jax(params), tmp_path / "weights.pt")
    torch.save({"batch": port_inputs(batch), "boxes": boxes[0],
                "flips": boxes[1]}, tmp_path / "batch.pt")
    procs = start_workers("step", world, tmp_path)

    # meanwhile: the one-process port step and the JAX step on the batch
    loss, grads, after = one_process_step(params, batch, boxes, monkeypatch)
    state = create_train_state(JaxDualEncoder(jax_config("xla")), params,
                               jax_make_optimizer(**SCHED))
    _, jax_loss = jax_make_egoclip_train_step(input_res=RES)(
        state, batch, jax.random.PRNGKey(3))
    # float32 through both towers and EgoNCE, summed in another order
    np.testing.assert_allclose(loss.item(), float(jax_loss), rtol=1e-5)

    wait_all(procs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert ranks[0]["loss"].item() == ranks[1]["loss"].item()
    np.testing.assert_allclose(ranks[0]["loss"].item(), loss.item(),
                               rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["loss"].item(), float(jax_loss),
                               rtol=1e-5)
    assert set(ranks[0]["grads"]) == set(grads)
    missing = [k for k, g in ranks[0]["grads"].items() if g is None]
    assert not missing, f"parameters without a gradient: {missing}"
    # float32: the all-reduce adds the two halves' gradients, one
    # backward sums the whole batch in another order.  The key biases'
    # gradients are zero in exact arithmetic (a softmax does not see a
    # constant added to its logits), so theirs are float32 noise, ~1e-7:
    # hence an absolute floor of 1e-6 of the model's largest gradient
    g_max = max(g.abs().max().item() for g in grads.values())
    noise, moved = 0, 0
    for k, want in grads.items():
        # DDP averaged the same gradient on both ranks
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k]), k
        np.testing.assert_allclose(ranks[0]["grads"][k].numpy(),
                                   want.numpy(), rtol=1e-5,
                                   atol=1e-6 * g_max, err_msg=k)
        # AdamW's first step moves a parameter by lr * g / (|g| + eps),
        # eps 1e-6: a gradient difference d moves it by lr * eps * d /
        # (|g| + eps)^2, over rtol 1e-5 of a parameter (~0.2) for d ~1e-6
        # where |g| < 3e-5 (noise / eps for the key biases).  Those
        # elements are held to the step's bound, lr, the rest to rtol 1e-5
        got, ref = ranks[0]["params"][k], after[k]
        assert torch.equal(got, ranks[1]["params"][k]), k
        sharp = want.abs() >= 3e-5
        np.testing.assert_allclose(got[sharp].numpy(), ref[sharp].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert ((got - ref)[~sharp].abs() <= SCHED["base_lr"]).all(), k
        # (unused embedding rows have exactly zero gradients: unmoved)
        noise += int((~sharp & (want != 0)).sum())
        moved += int((want != 0).sum())
    assert noise < 0.01 * moved, (noise, moved)


# --------------------------------------------------------------------------
# the eval gather at world 2
# --------------------------------------------------------------------------

def test_gather_eval_at_world_2_gives_every_rank_the_dataset(tmp_path):
    rng = np.random.default_rng(0)
    n = 10
    arrays = {"preds": rng.normal(size=(n, 5)).astype(np.float32),
              "gts": rng.integers(0, 5, n), "types": 1 + np.arange(n) % 2}
    paths = [f"clip{i}.mp4" for i in range(n)]
    # uneven shards, the first with a pad duplicate of item 0
    rows = [np.array([0, 2, 4, 6, 8, 9, 0]), np.array([1, 3, 5, 7])]
    with open(tmp_path / "eval.pkl", "wb") as f:
        pickle.dump({"rows": rows, "arrays": arrays, "paths": paths}, f)
    wait_all(start_workers("eval", 2, tmp_path))

    # one process: every rank's rows in rank order through JAX gather_eval
    cat = np.concatenate(rows)
    want, want_obj = jax_gather_eval({k: v[cat] for k, v in arrays.items()},
                                     cat, {"paths": [paths[i] for i in cat]})
    metrics = egomcq_accuracy_metrics(arrays["preds"], arrays["gts"],
                                      arrays["types"])
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["eval"].keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got["eval"][k], want[k])
            np.testing.assert_array_equal(got["eval"][k], arrays[k])
            np.testing.assert_array_equal(got["arrays"][k],
                                          arrays[k][cat])
        assert got["objects"] == want_obj == {"paths": paths}
        assert got["paths"] == [paths[i] for i in cat]
        assert got["metrics"] == metrics
