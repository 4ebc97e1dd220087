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
* ``step``: one EgoClip step of the model and optimizer that ``DIR`` holds
  (``model.json``, ``weights.pt``, ``batch.pt``: the global batch and its
  crop boxes), this rank's half of the batch, the model wrapped in
  ``DistributedDataParallel``; writes the loss, every parameter's gradient
  before the optimizer and the parameters after it to ``DIR/rank{r}.pt``;
* ``eval``: ``gather_eval`` / ``gather_arrays`` / ``gather_objects`` of
  this rank's rows of ``DIR/eval.pkl`` (``{'rows': [rank 0's, rank 1's],
  ...}``) and the EgoMCQ accuracies of the result, to ``DIR/rank{r}.pkl``.
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
        text=TextTowerConfig(**spec["text"]), projection_dim=8))
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
    ddp = data_parallel(model, torch.device("cpu"))
    assert isinstance(ddp, torch.nn.parallel.DistributedDataParallel)
    loss = steps.make_egoclip_train_step(input_res=spec["res"])(
        ddp, opt, local, torch.Generator())
    torch.save({"loss": loss, "grads": grads, "params": model.state_dict()},
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


if __name__ == "__main__":
    mode, out = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    rank, world = init_distributed("cpu")
    {"gather": gather, "step": step, "eval": evaluate}[mode](rank, world, out)
    torch.distributed.destroy_process_group()
    print(f"{mode.upper()}_OK rank {rank} of {world}", flush=True)
