"""Tensor and sequence parallelism of the port on the CPU: gloo ranks as
subprocesses (``tests/torch_ddp_worker.py mesh``), float32, tiny widths.

* EgoClip steps on a (data, model) mesh against the one-process port step
  and JAX's step on the same bridged weights and global batch (JAX's crop
  boxes patched in): world 2 at model 2 with sequence parallelism and
  without it (tensor parallelism of both towers), world 4 at data 2 x
  model 2 with sequence parallelism, each with the ``global_sim`` gather
  and the ring.  The loss within 1e-5 relative; every parameter's
  gradient (reduced over the mesh, gathered whole), ``cls_token``, the
  norms and ``vid_proj`` included, within 1e-4 relative L2.  The key
  biases' gradients are zero in exact arithmetic (a softmax does not see a
  constant added to its logits), float32 noise in both runs, so each
  parameter's L2 error is taken relative to the larger of its gradient's
  norm and 1e-3 of the largest parameter gradient norm;
* the ranks' local shapes (the head-aligned qkv rows, the row-parallel
  input dims, whole video weights under sequence parallelism);
* rank 0's checkpoint of the world-2 run holds the full state dict and
  loads strictly into one process;
* the sequence-parallel divisibility error, and the head-aligned split
  and its inverse.
"""

import json

import jax
import numpy as np
import pytest
import torch

from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.state import make_optimizer as jax_make_optimizer
from egovlp_tpu.train.steps import (
    make_egoclip_train_step as jax_make_egoclip_train_step,
)
from egovlp_tpu_torch.core.sp import SPGroup
from egovlp_tpu_torch.core.precision import Linear
from egovlp_tpu_torch.core.tp import (
    column_linear,
    enter_columns,
    mm_float32,
    shard_slice,
)
from egovlp_tpu_torch.io.checkpoints import CheckpointManager
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.train import steps as port_steps
from egovlp_tpu_torch.train.state import make_optimizer
from tests.test_torch_ddp import port_inputs, start_workers, wait_all
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)
from tests.test_torch_train import SCHED, egoclip_batch, jax_boxes

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
SIMS = ("gather", "ring")


def write_inputs(out, runs, params, batch, boxes):
    (out / "mesh.json").write_text(json.dumps({
        "video": {**VIDEO, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES, "runs": runs}))
    torch.save(params_from_jax(params), out / "weights.pt")
    torch.save({"batch": port_inputs(batch), "boxes": boxes[0],
                "flips": boxes[1]}, out / "batch.pt")


def one_process(params, batch, boxes, n_steps=1):
    """The port's one-process steps on the global batch: (losses, the
    first step's gradients, the state after the last)."""
    model = port_model(params)
    opt, _ = make_optimizer(model, **SCHED)
    grads, update = {}, opt.step

    def recorded_step():
        if not grads:
            grads.update({k: p.grad.clone()
                          for k, p in model.named_parameters()})
        update()

    opt.step = recorded_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "sample_crop_boxes", lambda gen, n, src: boxes)
        step = port_steps.make_egoclip_train_step(input_res=RES)
        losses = [step(model, opt, port_inputs(batch),
                       torch.Generator()).item() for _ in range(n_steps)]
    return losses, grads, model.state_dict(), opt


def jax_loss(params, batch):
    state = create_train_state(JaxDualEncoder(jax_config("xla")), params,
                               jax_make_optimizer(**SCHED))
    _, loss = jax_make_egoclip_train_step(input_res=RES)(
        state, batch, jax.random.PRNGKey(3))
    return float(loss)


def check_grads(got: dict, want: dict, label: str) -> None:
    assert set(got) == set(want), label
    scale = max(g.norm().item() for g in want.values())
    for k, w in want.items():
        err = (got[k] - w).norm().item()
        ref = max(w.norm().item(), 1e-3 * scale)
        assert err <= GRAD_RTOL * ref, (label, k, err, ref)


def setup(b_global):
    params = random_params(5)
    batch = egoclip_batch(11, b=b_global)
    key = jax.random.split(jax.random.PRNGKey(3))[0]  # JAX's transform key
    boxes = jax_boxes(key, 2 * b_global, batch["frames"].shape[2])
    return params, batch, boxes


CASES = {"model2-sp": (2, {"model": 2}, True),
         "model2-tp": (2, {"model": 2}, False),
         "data2-model2-sp": (4, {"data": 2, "model": 2}, True)}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every case's ranks started at once; meanwhile the one-process port
    step and JAX's on the global batch."""
    params, batch, boxes = setup(4)
    procs = {}
    for name, (world, mesh, sp) in CASES.items():
        out = tmp_path_factory.mktemp(name)
        runs = [{"name": sim, "mesh": mesh, "sp": sp, "global_sim": sim,
                 **({"save": "ckpt"} if sim == "gather" else {})}
                for sim in SIMS]
        write_inputs(out, runs, params, batch, boxes)
        procs[name] = (out, start_workers("mesh", world, out))
    try:
        losses, grads, _, _ = one_process(params, batch, boxes)
        want_loss = jax_loss(params, batch)
    except BaseException:
        for _, ps in procs.values():
            for p in ps:
                p.kill()
        raise
    np.testing.assert_allclose(losses[0], want_loss, rtol=LOSS_RTOL)
    yield params, procs, losses, grads, want_loss
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


@pytest.mark.parametrize("case", list(CASES))
def test_egoclip_step_on_a_mesh_is_the_global_batch_step(case, launched):
    params, procs, losses, grads, want_loss = launched
    world, _, sp = CASES[case]
    out, ps = procs[case]
    wait_all(ps)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(world)]
    for sim in SIMS:
        for r, res in enumerate(ranks):
            got = res[sim]
            label = f"{sim} rank {r}"
            np.testing.assert_allclose(got["losses"][0], losses[0],
                                       rtol=LOSS_RTOL, err_msg=label)
            np.testing.assert_allclose(got["losses"][0], want_loss,
                                       rtol=LOSS_RTOL, err_msg=label)
            check_grads(got["grads"], grads, label)
            # the data replicas and model ranks agree on the whole state
            for k, v in got["params"].items():
                torch.testing.assert_close(v, ranks[0][sim]["params"][k],
                                           rtol=0, atol=0)

    # local shapes: head-aligned qkv rows, row-parallel input dims
    D, hidden = VIDEO["embed_dim"], int(VIDEO["embed_dim"] * 4)
    local = ranks[0]["gather"]["local"]
    video = {"video_model.blocks.0.attn.qkv.weight": (3 * D // 2, D),
             "video_model.blocks.0.attn.qkv.bias": (3 * D // 2,),
             "video_model.blocks.0.attn.proj.weight": (D, D // 2),
             "video_model.blocks.0.attn.proj.bias": (D,),
             "video_model.blocks.1.mlp.fc1.weight": (hidden // 2, D),
             "video_model.blocks.1.mlp.fc2.weight": (D, hidden // 2),
             "video_model.blocks.1.norm1.weight": (D,)}
    for k, shape in video.items():
        whole = tuple(ranks[0]["gather"]["params"][k].shape)
        assert local[k] == (whole if sp else shape), (k, local[k])
    Dt = TEXT["dim"]
    text = {"text_model.transformer.layer.0.attention.q_lin.weight":
            (Dt // 2, Dt),
            "text_model.transformer.layer.0.attention.out_lin.weight":
            (Dt, Dt // 2),
            "text_model.transformer.layer.1.ffn.lin1.weight":
            (TEXT["hidden_dim"] // 2, Dt),
            "text_model.transformer.layer.1.ffn.lin2.bias": (Dt,),
            "vid_proj.0.weight": (8, D), "txt_proj.1.weight": (8, Dt)}
    for k, shape in text.items():
        assert local[k] == shape, (k, local[k])

    # rank 0's checkpoint: the full state dict, strictly into one process
    fresh = port_model(params)
    opt, _ = make_optimizer(fresh, **SCHED)
    payload = CheckpointManager(str(out / "ckpt")).restore(fresh, opt)
    assert payload["step"] == 1
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, ranks[0]["gather"]["params"][k],
                                   rtol=0, atol=0)
    assert len(opt.state) == len(list(fresh.parameters()))


def test_sequence_parallel_needs_frames_and_patches_it_divides():
    SPGroup(None, 0, 2).check(4, 4)
    with pytest.raises(ValueError, match=r"frames \(3\) and patches \(4\) "
                                         r"divisible by 2"):
        SPGroup(None, 0, 2).check(3, 4)
    with pytest.raises(ValueError, match=r"patches \(196\) divisible by 3"):
        SPGroup(None, 1, 3).check(6, 196)


def test_head_aligned_qkv_split_keeps_each_ranks_heads():
    D, H, m = 8, 4, 2  # heads of 2 rows
    w = torch.arange(3 * D * 3, dtype=torch.float32).reshape(3 * D, 3)
    for r in range(m):
        part = shard_slice(w, 0, True, r, m)
        q, k, v = w.chunk(3)
        rows = slice(r * D // m, (r + 1) * D // m)
        torch.testing.assert_close(part, torch.cat([q[rows], k[rows],
                                                    v[rows]]))
    # the inverse of the gather: [m, 3 D / m] parts back to [q | k | v]
    parts = torch.stack([shard_slice(w, 0, True, r, m) for r in range(m)])
    back = parts.unflatten(1, (3, -1)).transpose(0, 1).flatten(0, 2)
    torch.testing.assert_close(back, w)


def test_tp_linears_sum_in_float32_and_round_once():
    """The tensor-parallel Linears in one process (no group): the row
    product is the float32 sum rounded once (``precision.linear``'s GEMM),
    the column layer's forward is ``precision.linear``, and its input
    gradient comes back in float32, the bf16 GEMM's accumulator."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 40, generator=g).to(torch.bfloat16)
    layer = Linear(40, 24)
    torch.nn.init.normal_(layer.weight, generator=g)
    torch.nn.init.normal_(layer.bias, generator=g)
    w = layer.weight.to(torch.bfloat16)
    exact = x.double() @ w.double().t()
    torch.testing.assert_close(mm_float32(x, w.t()).double(), exact,
                               rtol=1e-6, atol=1e-5)
    layer.reduce = lambda xx, ww: mm_float32(
        xx, ww.to(xx.dtype).t()).to(xx.dtype)
    torch.testing.assert_close(layer(x), (exact.to(torch.bfloat16)
                                          + layer.bias.to(torch.bfloat16)),
                               rtol=0, atol=0)
    layer.reduce = None
    x32 = enter_columns(x, None).requires_grad_()
    y = column_linear(x32, layer, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, layer(x), rtol=0, atol=0)
    dy = torch.randn(y.shape, generator=g).to(torch.bfloat16)
    y.backward(dy)
    assert x32.grad.dtype == torch.float32
    torch.testing.assert_close(x32.grad.double(),
                               dy.double() @ w.double(), rtol=1e-6,
                               atol=1e-5)
