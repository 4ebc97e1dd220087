"""One rank of a multi-process test of the PyTorch port, on the CPU (gloo).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_ddp_worker.py MODE DIR

Started by ``tests/test_torch_ddp.py``, one process a rank.  It imports
only torch and the port (no jax), joins the process group with
``core.dist.init_distributed(device='cpu')`` and, by ``MODE``:

* ``gather``: checks ``all_gather_rows`` (forward: every rank's rows in
  rank order; backward: the sum over ranks of the incoming gradient, this
  rank's rows) and ``psum_scalar`` / ``pmean_scalar``, and prints
  ``GATHER_OK``;
* ``step``: one training step of the model and optimizer that ``DIR``
  holds (``model.json``: the widths, the head's width ``proj`` (8 unless
  given), the schedule and the step, EgoClip unless its ``step`` names
  the EPIC max-margin step and its loss, or the video-only ``oscc`` /
  ``pnr`` step; an EgoClip step takes ``loss_type``, ``global_sim`` and
  ``n_micro`` from it when given; ``weights.pt``; ``batch.pt``: the global batch and its
  crop boxes), this rank's half of the batch, the model wrapped in
  ``DistributedDataParallel`` (``recipes.data_parallel``, video-only for
  oscc / pnr); writes the loss, every parameter's gradient before the
  optimizer (None where it got none) and the parameters after it to
  ``DIR/rank{r}.pt``; a video-only step's rank 0 also writes the trained
  model's checkpoint under ``DIR/ckpt`` through ``CheckpointManager``;
* ``ring``: ``objectives.ring.egoclip_ring_loss`` on this rank's rows of
  the global ``t``, ``v``, ``noun_vec``, ``verb_vec`` in ``DIR/ring.pt``
  (with scene negatives: rows ``[pos_r; neg_r]``, ``steps._global_rows``;
  its ``loss_type``), backward from it; writes the loss and the gradients
  of this rank's ``t`` and ``v`` rows to ``DIR/rank{r}.pt``;
* ``eval``: ``gather_eval`` / ``gather_arrays`` / ``gather_objects`` of
  this rank's rows of ``DIR/eval.pkl`` (``{'rows': [rank 0's, rank 1's],
  ...}``) and the EgoMCQ accuracies of the result, to ``DIR/rank{r}.pkl``;
* ``mesh``: the runs ``DIR/mesh.json`` lists, each on its own (data,
  model) mesh (``core/mesh.py``) with sequence parallelism and ZeRO as it
  says, from ``weights.pt`` (or, with ``resume``, the checkpoint an
  earlier run wrote) on ``batch.pt`` (the global batch and its boxes),
  this rank's data rows: ``steps`` EgoClip steps (``n_micro`` GradCache
  micro-batches when given), or CharadesEgo steps on the positives when
  its ``step`` says ``charades``; a run's ``video`` overrides the tower's
  config (``drop_path_rate``) and its ``max_grad_norm`` clips.  Records
  the losses, every parameter's reduced gradient of the first step
  gathered whole, the full state after the last step
  (``core.zero.full_state``, the moments by parameter name), the local
  shapes of the parameters and moments, the drop-path masks applied, the
  global gradient norms the clip took and the collectives' calls and
  bytes of the steps, and, with ``save``, rank 0 writes the checkpoint;
  all to ``DIR/rank{r}.pt``;
* ``pipeline``: ``core.pp.video_tower_pp_apply`` of the tower in
  ``DIR/pp.pt`` over a stage group of ``stages`` ranks (and a data axis
  when the world is larger), forward and the gradients of a fixed
  cotangent, to ``DIR/rank{r}.pt``.
"""

import json
import pickle
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from egovlp_tpu_torch.core.collectives import (  # noqa: E402
    all_gather_rows,
    pmean_scalar,
    psum_scalar,
)
from egovlp_tpu_torch.core.dist import init_distributed  # noqa: E402


def gather(rank, world, _):
    def x_of(r):
        return torch.randn(3, 5, generator=torch.Generator().manual_seed(r))

    def w_of(r):  # a loss that differs from rank to rank
        return torch.randn(3 * world, 5,
                           generator=torch.Generator().manual_seed(100 + r))

    x = x_of(rank).requires_grad_()
    y = all_gather_rows(x)
    if world == 1:
        assert y is x
        return
    assert torch.equal(y.detach(), torch.cat([x_of(r) for r in range(world)]))
    (y * w_of(rank)).sum().backward()
    want = torch.stack([w_of(s) for s in range(world)]).sum(0)
    torch.testing.assert_close(x.grad, want[3 * rank:3 * rank + 3],
                               rtol=0, atol=1e-6)
    one = torch.tensor(float(rank + 1))
    assert psum_scalar(one).item() == world * (world + 1) / 2
    assert pmean_scalar(one).item() == (world + 1) / 2
    assert one.item() == rank + 1  # not reduced in place


def step(rank, world, out):
    from egovlp_tpu_torch.models import (
        DualEncoder,
        DualEncoderConfig,
        TextTowerConfig,
        VideoTowerConfig,
    )
    from egovlp_tpu_torch.train import steps
    from egovlp_tpu_torch.train.recipes import data_parallel
    from egovlp_tpu_torch.train.state import make_optimizer

    spec = json.loads((out / "model.json").read_text())
    model = DualEncoder(DualEncoderConfig(
        video=VideoTowerConfig(**spec["video"]),
        text=TextTowerConfig(**spec["text"]),
        projection_dim=spec.get("proj", 8)))
    model.load_state_dict(torch.load(out / "weights.pt"), strict=True)
    data = torch.load(out / "batch.pt")
    boxes, flips = data["boxes"], data["flips"]

    def crop_boxes(gen, n, src):  # the global batch's boxes
        assert n == len(boxes), (n, len(boxes))
        return boxes, flips

    steps.sample_crop_boxes = crop_boxes
    b = len(data["batch"]["frames"]) // world
    local = {k: v[rank * b:(rank + 1) * b] for k, v in data["batch"].items()}
    opt, _ = make_optimizer(model, **spec["sched"])
    grads, update = {}, opt.step

    def recorded_step():
        grads.update({k: None if p.grad is None else p.grad.clone()
                      for k, p in model.named_parameters()})
        update()

    opt.step = recorded_step
    video_only = spec.get("step") in ("oscc", "pnr")
    ddp = data_parallel(model, torch.device("cpu"), video_only=video_only)
    assert isinstance(ddp, torch.nn.parallel.DistributedDataParallel)
    if video_only:
        step_fn = {"oscc": steps.make_oscc_train_step,
                   "pnr": steps.make_pnr_train_step}[spec["step"]](
                       input_res=spec["res"])
    elif spec.get("step") == "epic":
        step_fn = steps.make_epic_train_step(
            loss_type=spec["loss_type"], input_res=spec["res"],
            margin=spec["margin"])
    else:
        step_fn = steps.make_egoclip_train_step(
            input_res=spec["res"], loss_type=spec.get("loss_type", "EgoNCE"),
            global_sim=spec.get("global_sim", "gather"),
            n_micro=spec.get("n_micro", 1))
    loss = step_fn(ddp, opt, local, torch.Generator())
    if video_only:
        from egovlp_tpu_torch.io.checkpoints import CheckpointManager

        CheckpointManager(str(out / "ckpt")).save_epoch(1, ddp, opt, 0.0)
    torch.save({"loss": loss, "grads": grads, "params": model.state_dict()},
               out / f"rank{rank}.pt")


def ring(rank, world, out):
    from egovlp_tpu_torch.objectives.ring import egoclip_ring_loss
    from egovlp_tpu_torch.train.steps import _global_rows

    data = torch.load(out / "ring.pt")
    b = len(data["t"]) // (2 * world)
    rows = torch.stack([_global_rows(b, r, world, True)
                        for r in range(world)])
    mine = rows[rank]
    t, v = (data[k][mine].clone().requires_grad_() for k in ("t", "v"))
    loss = egoclip_ring_loss(t, v, data["noun_vec"][mine],
                             data["verb_vec"][mine], rows,
                             loss_type=data["loss_type"])
    loss.backward()
    torch.save({"loss": loss.detach(), "dt": t.grad, "dv": v.grad},
               out / f"rank{rank}.pt")


def evaluate(rank, world, out):
    from egovlp_tpu_torch.core.dist_eval import (
        gather_arrays,
        gather_eval,
        gather_objects,
    )
    from egovlp_tpu_torch.metrics.egomcq import egomcq_accuracy_metrics

    with open(out / "eval.pkl", "rb") as f:
        data = pickle.load(f)
    rows = data["rows"][rank]
    arrays = {k: v[rows] for k, v in data["arrays"].items()}
    paths = [data["paths"][i] for i in rows]
    g, objs = gather_eval(arrays, index=rows, objects={"paths": paths})
    res = {"eval": g, "objects": objs,
           "arrays": gather_arrays(arrays), "paths": gather_objects(paths),
           "metrics": egomcq_accuracy_metrics(g["preds"], g["gts"],
                                              g["types"])}
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


def _tiny_model(spec, video=None):
    from egovlp_tpu_torch.models import (
        DualEncoder,
        DualEncoderConfig,
        TextTowerConfig,
        VideoTowerConfig,
    )

    return DualEncoder(DualEncoderConfig(
        video=VideoTowerConfig(**{**spec["video"], **(video or {})}),
        text=TextTowerConfig(**spec["text"]),
        projection_dim=spec.get("proj", 8)))


def mesh(rank, world, out):
    from egovlp_tpu_torch.core import collectives
    from egovlp_tpu_torch.core.mesh import MeshSpec, create_mesh, shard_batch
    from egovlp_tpu_torch.core.zero import apply_mesh, full_state
    from egovlp_tpu_torch.io.checkpoints import CheckpointManager
    from egovlp_tpu_torch.models import video_tower
    from egovlp_tpu_torch.train import steps
    from egovlp_tpu_torch.train.recipes import data_parallel
    from egovlp_tpu_torch.train.state import make_optimizer

    spec = json.loads((out / "mesh.json").read_text())
    data = torch.load(out / "batch.pt")
    boxes, flips = data["boxes"], data["flips"]
    rows = {"n": len(boxes)}

    def crop_boxes(gen, n, src):  # the global batch's boxes
        assert n == rows["n"], (n, rows["n"])
        return boxes[:n], flips[:n]

    masks, drop_path = [], video_tower.drop_path

    def recorded_drop_path(xc, xp, mask):
        masks.append(mask.clone())
        return drop_path(xc, xp, mask)

    steps.sample_crop_boxes = crop_boxes
    video_tower.drop_path = recorded_drop_path
    results = {}
    for run in spec["runs"]:
        charades = run.get("step") == "charades"
        # CharadesEgo's global batch is the positives
        rows["n"] = len(boxes) // 2 if charades else len(boxes)
        masks.clear()
        model = _tiny_model(spec, run.get("video"))
        opt, _ = make_optimizer(model, **spec["sched"],
                                max_grad_norm=run.get("max_grad_norm"))
        if run.get("resume"):
            CheckpointManager(str(out / run["resume"])).restore(model, opt)
        else:
            model.load_state_dict(torch.load(out / "weights.pt"))
        grid = create_mesh(MeshSpec(**run["mesh"]))
        with grid:
            update = apply_mesh(model, opt, grid,
                                sequence_parallel=run.get("sp", False),
                                zero=run.get("zero", 0),
                                min_size=run.get("min_size", 16384))
            first, norms = {}, []
            if update is None:
                trained = data_parallel(model, torch.device("cpu"))
                step_opt = opt.step

                def recorded():
                    if not first:
                        first.update({k: p.grad.clone() for k, p in
                                      model.named_parameters()})
                    step_opt()

                opt.step = recorded
            else:
                trained = model
                reduce = update.gradients

                def recorded(params):
                    grads, targets = reduce(params)
                    if not first:
                        names = {id(p): k for k, p in
                                 model.named_parameters()}
                        for ps, gs in zip(params, grads):
                            for p, g in zip(ps, gs):
                                first[names[id(p)]] = update.full(g, p, True)
                    return grads, targets

                update.gradients = recorded
                norm_sq = update.norm_sq

                def recorded_norm(sq, params):
                    total = norm_sq(sq, params)
                    norms.append(total.sqrt().item())
                    return total

                update.norm_sq = recorded_norm
            if charades:
                step_fn = steps.make_charades_train_step(input_res=spec["res"])
                batch = {k: data["batch"][k]
                         for k in ("frames", "text_ids", "text_mask")}
            else:
                step_fn = steps.make_egoclip_train_step(
                    input_res=spec["res"],
                    global_sim=run.get("global_sim", "gather"),
                    n_micro=run.get("n_micro", 1))
                batch = data["batch"]
            local = shard_batch(batch, grid)
            collectives.traffic.clear()
            losses = [step_fn(trained, opt, local, torch.Generator()).item()
                      for _ in range(run.get("steps", 1))]
            traffic = dict(collectives.traffic)
            sd, osd = full_state(model, opt)
            if run.get("save"):
                CheckpointManager(str(out / run["save"])).save_epoch(
                    1, model, opt, 0.0)
            names = [k for k, _ in model.named_parameters()]
            results[run["name"]] = {
                "losses": losses, "grads": first, "params": sd,
                "moments": {k: osd["state"][i] for i, k in enumerate(names)
                            if i in osd["state"]},
                "masks": list(masks),
                "norms": norms, "traffic": traffic,
                "local": {k: tuple(p.shape) for k, p in
                          model.named_parameters()},
                "local_moments": {k: {m: tuple(v.shape) for m, v in
                                      opt.state[p].items()}
                                  for k, p in model.named_parameters()
                                  if p in opt.state}}
    torch.save(results, out / f"rank{rank}.pt")


def pipeline(rank, world, out):
    import torch.distributed as dist

    from egovlp_tpu_torch.core.pp import pp_rows, video_tower_pp_apply
    from egovlp_tpu_torch.models.video_tower import (
        SpaceTimeTransformer,
        VideoTowerConfig,
    )

    data = torch.load(out / "pp.pt")
    tower = SpaceTimeTransformer(VideoTowerConfig(**data["video"]))
    tower.load_state_dict(data["weights"])
    stages = data["stages"]
    groups = [dist.new_group(list(range(d * stages, (d + 1) * stages)))
              for d in range(world // stages)]
    data_groups = [dist.new_group(list(range(s, world, stages)))
                   for s in range(stages)] if world > stages else None
    d, s = divmod(rank, stages)
    out_v = video_tower_pp_apply(
        tower, data["video_in"], n_stages=stages, n_micro=data["n_micro"],
        stage_group=groups[d],
        data_group=data_groups[s] if data_groups else None)
    rows = pp_rows(len(data["video_in"]), data["n_micro"],
                   rank // stages, world // stages)
    (out_v * data["cotangent"][rows]).sum().backward()
    torch.save({"out": out_v.detach(),
                "grads": {k: p.grad for k, p in tower.named_parameters()}},
               out / f"rank{rank}.pt")


if __name__ == "__main__":
    mode, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    rank, world = init_distributed("cpu")
    {"gather": gather, "step": step, "ring": ring, "eval": evaluate,
     "mesh": mesh, "pipeline": pipeline}[mode](rank, world, out)
    torch.distributed.destroy_process_group()
    print(f"{mode.upper()}_OK rank {rank} of {world}", flush=True)
