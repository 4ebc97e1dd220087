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
* the ranks' local shapes of the parameters and their AdamW moments
  between steps (the qkv rows, the row-parallel input dims), the
  sequence-parallel video tower's as tensor parallelism's: it is stored
  split over the model group and gathered whole at use;
* rank 0's checkpoint of the world-2 run holds the full state dict and
  loads strictly into one process; the sequence-parallel mesh resumes
  from it (its moments cut to the slices) and trains the one-process
  second step;
* at data 2 x model 2 with sequence parallelism and a ``max_grad_norm``
  that clips, the global norm the clip takes is one process's and the
  two steps are its steps;
* drop-path at rate 0.5 (the masks of the global batch, drawn on every
  rank and sliced): the EgoClip step at data 2 and with sequence
  parallelism at model 2 (the model ranks apply the same masks; also
  with 'block' recompute and with GradCache), the GradCache step
  (``n_micro`` 2) at data 2 and the CharadesEgo step at data 2, each
  against the one-process step on the concatenated batch (the GradCache
  ones with ``n_micro`` 2 too): the loss within 1e-5 relative, the
  gradients as above, the masks the one process's rows; the one-process
  masks drop some samples and keep others; the tower stored split is
  gathered once a step under recompute and GradCache;
* the sequence-parallel divisibility error, and the head-aligned split
  and its inverse.
"""

import json
import types

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
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models import video_tower
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
DROP = {"drop_path_rate": 0.5}
# below the tiny model's first-step gradient norm (~102 at these seeds):
# the clip scales every step's gradient
MAX_GRAD_NORM = 10.0


def write_inputs(out, runs, params, batch, boxes):
    (out / "mesh.json").write_text(json.dumps({
        "video": {**VIDEO, "attention_impl": "auto"}, "text": TEXT,
        "sched": {**SCHED, "milestones": list(SCHED["milestones"])},
        "res": RES, "runs": runs}))
    torch.save(params_from_jax(params), out / "weights.pt")
    torch.save({"batch": port_inputs(batch), "boxes": boxes[0],
                "flips": boxes[1]}, out / "batch.pt")


def one_process(params, batch, boxes, n_steps=1, video=None, n_micro=1,
                max_grad_norm=None, charades=False, masks=None):
    """The port's one-process steps on the global batch: (losses, the
    first step's gradients, the state after the last, the AdamW moments
    after it by parameter name).  ``video``
    overrides the tower's config; ``n_micro``: GradCache micro-batches;
    ``charades``: the CharadesEgo step on the positives; ``masks``: a list
    that takes the drop-path masks applied."""
    if video:
        model = DualEncoder(DualEncoderConfig(
            video=VideoTowerConfig(**VIDEO, attention_impl="auto", **video),
            text=TextTowerConfig(**TEXT), projection_dim=8))
        model.load_state_dict(params_from_jax(params), strict=True)
    else:
        model = port_model(params)
    opt, _ = make_optimizer(model, **SCHED, max_grad_norm=max_grad_norm)
    grads, update = {}, opt.step

    def recorded_step():
        if not grads:
            grads.update({k: p.grad.clone()
                          for k, p in model.named_parameters()})
        update()

    opt.step = recorded_step
    inputs = port_inputs(batch)
    drop_path = video_tower.drop_path

    def recorded_drop_path(xc, xp, mask):
        masks.append(mask.clone())
        return drop_path(xc, xp, mask)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_steps, "sample_crop_boxes",
                   lambda gen, n, src: (boxes[0][:n], boxes[1][:n]))
        if masks is not None:
            mp.setattr(video_tower, "drop_path", recorded_drop_path)
        if charades:
            step = port_steps.make_charades_train_step(input_res=RES)
            inputs = {k: inputs[k] for k in ("frames", "text_ids",
                                             "text_mask")}
        else:
            step = port_steps.make_egoclip_train_step(input_res=RES,
                                                      n_micro=n_micro)
        losses = [step(model, opt, inputs, torch.Generator()).item()
                  for _ in range(n_steps)]
    moments = {k: {m: v.clone() for m, v in opt.state[p].items()}
               for k, p in model.named_parameters() if p in opt.state}
    return losses, grads, model.state_dict(), moments


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
# the runs each case's ranks take after the gather and ring steps:
# (name, the run, the one-process reference's name)
EXTRA = {
    "model2-sp": [
        ("resumed", {"mesh": {"model": 2}, "sp": True, "resume": "ckpt"},
         "two"),
        ("sp-drop", {"mesh": {"model": 2}, "sp": True, "video": DROP},
         "drop"),
        ("sp-drop-block", {"mesh": {"model": 2}, "sp": True,
                           "video": {**DROP, "remat": "block"}},
         "drop-block"),
        ("sp-grad-cache", {"mesh": {"model": 2}, "sp": True, "video": DROP,
                           "n_micro": 2}, "drop-grad-cache")],
    "model2-tp": [
        ("data2-drop", {"mesh": {"data": 2}, "video": DROP}, "drop"),
        ("data2-grad-cache", {"mesh": {"data": 2}, "video": DROP,
                              "n_micro": 2}, "drop-grad-cache"),
        ("data2-charades", {"mesh": {"data": 2}, "video": DROP,
                            "step": "charades"}, "drop-charades")],
    "data2-model2-sp": [
        ("clipped", {"mesh": {"data": 2, "model": 2}, "sp": True,
                     "max_grad_norm": MAX_GRAD_NORM, "steps": 2},
         "clipped")],
}
# the one-process references of those runs: one_process's arguments
REFS = {"two": {"n_steps": 2},
        "drop": {"video": DROP},
        "drop-block": {"video": {**DROP, "remat": "block"}},
        "drop-grad-cache": {"video": DROP, "n_micro": 2},
        "drop-charades": {"video": DROP, "charades": True},
        "clipped": {"n_steps": 2, "max_grad_norm": MAX_GRAD_NORM}}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every case's ranks started at once; meanwhile the one-process port
    steps and JAX's on the global batch."""
    params, batch, boxes = setup(4)
    procs = {}
    for name, (world, mesh, sp) in CASES.items():
        out = tmp_path_factory.mktemp(name)
        runs = [{"name": sim, "mesh": mesh, "sp": sp, "global_sim": sim,
                 **({"save": "ckpt"} if sim == "gather" else {})}
                for sim in SIMS]
        runs += [{"name": run, **spec} for run, spec, _ in EXTRA[name]]
        write_inputs(out, runs, params, batch, boxes)
        procs[name] = (out, start_workers("mesh", world, out))
    try:
        losses, grads, _, _ = one_process(params, batch, boxes)
        want_loss = jax_loss(params, batch)
        refs = {}
        for name, kw in REFS.items():
            masks = []
            refs[name] = (*one_process(params, batch, boxes, masks=masks,
                                       **kw), masks)
    except BaseException:
        for _, ps in procs.values():
            for p in ps:
                p.kill()
        raise
    np.testing.assert_allclose(losses[0], want_loss, rtol=LOSS_RTOL)
    yield types.SimpleNamespace(params=params, procs=procs, losses=losses,
                                grads=grads, want_loss=want_loss, refs=refs,
                                ranks={})
    for _, ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


def results(launched, case):
    """Each rank's results of ``case`` (its ranks waited for once)."""
    if case not in launched.ranks:
        out, ps = launched.procs[case]
        wait_all(ps)
        launched.ranks[case] = [torch.load(out / f"rank{r}.pt")
                                for r in range(len(ps))]
    return launched.ranks[case]


@pytest.mark.parametrize("case", list(CASES))
def test_egoclip_step_on_a_mesh_is_the_global_batch_step(case, launched):
    params, losses, grads = launched.params, launched.losses, launched.grads
    want_loss = launched.want_loss
    out, _ = launched.procs[case]
    ranks = results(launched, case)
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

    # local shapes between steps: qkv rows, row-parallel input dims; the
    # sequence-parallel tower stores tensor parallelism's split too, and
    # its moments with it
    D, hidden = VIDEO["embed_dim"], int(VIDEO["embed_dim"] * 4)
    local = ranks[0]["gather"]["local"]
    moments = ranks[0]["gather"]["local_moments"]
    video = {"video_model.blocks.0.attn.qkv.weight": (3 * D // 2, D),
             "video_model.blocks.0.attn.qkv.bias": (3 * D // 2,),
             "video_model.blocks.0.timeattn.qkv.weight": (3 * D // 2, D),
             "video_model.blocks.0.attn.proj.weight": (D, D // 2),
             "video_model.blocks.0.timeattn.proj.weight": (D, D // 2),
             "video_model.blocks.0.attn.proj.bias": (D,),
             "video_model.blocks.1.mlp.fc1.weight": (hidden // 2, D),
             "video_model.blocks.1.mlp.fc1.bias": (hidden // 2,),
             "video_model.blocks.1.mlp.fc2.weight": (D, hidden // 2),
             "video_model.blocks.1.mlp.fc2.bias": (D,),
             "video_model.blocks.1.norm1.weight": (D,),
             "video_model.cls_token": (1, 1, D)}
    for k, shape in video.items():
        assert local[k] == shape, (k, local[k])
        assert moments[k] == {"mu": shape, "nu": shape}, (k, moments[k])
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


def test_sequence_parallel_resumes_a_full_checkpoint(launched):
    """Rank 0's checkpoint of the gather step (the full state dict, one
    process's format) resumed onto the sequence-parallel mesh: the moments
    are cut to the slices, and the second step is one process's (the
    moments after it too, which a wrong cut would move)."""
    losses, _, _, moments, _ = launched.refs["two"]
    D = VIDEO["embed_dim"]
    qkv = "video_model.blocks.0.attn.qkv.weight"
    for r, res in enumerate(results(launched, "model2-sp")):
        got = res["resumed"]
        assert got["local_moments"][qkv] == {"mu": (3 * D // 2, D),
                                             "nu": (3 * D // 2, D)}
        np.testing.assert_allclose(got["losses"][0], losses[1],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
        for m in ("mu", "nu"):
            check_grads({k: v[m] for k, v in got["moments"].items()},
                        {k: v[m] for k, v in moments.items()},
                        f"{m} rank {r}")


def test_sequence_parallel_gathers_the_tower_once_a_step(launched):
    """The video tower stored split is gathered whole once a step: as many
    all-gathers with 'block' recompute (a block's forward again in the
    backward) and with GradCache (2 micro-batches, 2 passes each) as in a
    plain step, and it stays whole until the update (a recompute or a
    second pass on the slices would fail on their shapes)."""
    for r, res in enumerate(results(launched, "model2-sp")):
        plain = res["sp-drop"]["traffic"]
        for run in ("sp-drop-block", "sp-grad-cache"):
            got = res[run]["traffic"]
            assert got["all_gather"] == plain["all_gather"] > 0, (r, run)
            assert got["all_gather_bytes"] == plain["all_gather_bytes"]
            assert got["reduce_scatter"] == plain["reduce_scatter"] > 0


def test_clip_takes_the_global_norm_under_sequence_parallelism(launched):
    """Data 2 x model 2 with sequence parallelism, the video tower stored
    split: the norm that ``max_grad_norm`` clips by is one process's
    global gradient norm (each slice counted once, each replicated leaf
    once), and it clips."""
    losses, grads, _, _, _ = launched.refs["clipped"]
    want = torch.stack([g.norm() for g in grads.values()]).norm().item()
    assert want > MAX_GRAD_NORM
    for r, res in enumerate(results(launched, "data2-model2-sp")):
        got = res["clipped"]
        np.testing.assert_allclose(got["norms"][0], want, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        check_grads(got["grads"], grads, f"rank {r}")


# the drop-path runs: (case, run, reference, the parts of a pass's global
# batch that a rank holds a block of: the EgoClip step's positives and
# negatives, a GradCache micro-batch's or CharadesEgo's one)
DROP_RUNS = {"data2": ("model2-tp", "data2-drop", "drop", 2),
             "model2-sp": ("model2-sp", "sp-drop", "drop", 2),
             "model2-sp-block": ("model2-sp", "sp-drop-block", "drop-block",
                                 2),
             "model2-sp-grad-cache": ("model2-sp", "sp-grad-cache",
                                      "drop-grad-cache", 1),
             "data2-grad-cache": ("model2-tp", "data2-grad-cache",
                                  "drop-grad-cache", 1),
             "data2-charades": ("model2-tp", "data2-charades",
                                "drop-charades", 1)}


@pytest.mark.parametrize("name", list(DROP_RUNS))
def test_drop_path_masks_of_the_global_batch(name, launched):
    """Drop-path at rate 0.5 on a mesh equals one process on the global
    batch: each rank applies the one process's masks at its rows of the
    pass's global batch (data ranks their own rows, the model ranks of a
    replica the same ones), so the loss and every gradient are the one
    process's."""
    case, run, ref, parts = DROP_RUNS[name]
    losses, grads, _, _, want_masks = launched.refs[ref]
    every = torch.cat(want_masks)
    assert (every == 0).any() and (every > 0).any(), every
    mesh = {n: spec for n, spec, _ in EXTRA[case]}[run]["mesh"]
    n_data, n_model = mesh.get("data", 1), mesh.get("model", 1)
    for r, res in enumerate(results(launched, case)):
        got = res[run]
        label = f"{name} rank {r}"
        np.testing.assert_allclose(got["losses"][0], losses[0],
                                   rtol=LOSS_RTOL, err_msg=label)
        check_grads(got["grads"], grads, label)
        assert len(got["masks"]) == len(want_masks), label
        for mask, want in zip(got["masks"], want_masks):
            mine = want.view(parts, n_data, -1)[:, r // n_model].flatten()
            torch.testing.assert_close(mask, mine, rtol=0, atol=0,
                                       msg=label)


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
