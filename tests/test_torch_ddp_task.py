"""The port's training entry point in 2 processes against 1, on the CPU.

``python -m egovlp_tpu_torch.cli.train --multihost --device cpu`` (gloo)
on the synthetic EgoClip tree (``egoclip_root``: 6 clips, 3 EgoMCQ items),
a tiny float32 model from seed 0, EgoMCQ validation after each epoch,
mirroring ``tests/test_multihost_proc.py``'s run_task test:

  run A: 1 process at batch 2 (2 + 2 scene negatives), 2 epochs;
  run B: 2 processes at batch 1 each (global 2), 1 epoch;
  run C: 2 processes resumed from B's checkpoint, trains epoch 2;
  run D: 2 processes, 2 epochs, started by torchrun itself;
  run E: 2 processes on a model-2 mesh with sequence parallelism (one
  data replica of batch 1 a chip: A's global batch), 2 epochs: the video
  tower stored split over the model group, gathered whole for the steps
  and for EgoMCQ validation, whole again in the checkpoints.

Each run's epoch logs are read from its rank 0's output (the Trainer logs
every key of every epoch; other ranks log warnings only).  Same topology
(B vs D's epoch 1, C vs D's epoch 2) agrees to 1e-6; across topologies
(D vs A, E vs A) to 2e-3 at epoch 1 and 1e-2 at epoch 2, the limits of
the JAX package's test (the gradient sums run in another order, and the
drift compounds through epoch 2); E's last checkpoint loads strictly into
one process.  Each run writes exactly one run directory
and one checkpoint an epoch, rank 0's, with no ``module.`` prefixes; B's
checkpoint loads into a one-process ``run_task(resume=...)`` and into
``cli.eval``, and ``cli.eval --multihost`` in 2 processes prints one
process's accuracies.
"""

import json
import re
import subprocess
import sys

import pytest
import torch

from egovlp_tpu_torch import build
from egovlp_tpu_torch.cli import eval as cli_eval
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.train import recipes
from tests.test_datasets import egoclip_root  # noqa: F401
from tests.test_torch_ddp import (
    ROOT,
    free_port,
    process_env,
    rank_env,
    wait_all,
)
from tests.test_torch_recipes import VOCAB, record_port, tiny_config

EPOCH_LINE = re.compile(r" - INFO -   epoch (\d+): (\S+): (\S+)$", re.M)


def epoch_logs(out: str) -> dict:
    """``{(epoch, key): value}`` of the Trainer's epoch lines."""
    return {(int(e), k): float(v) for e, k, v in EPOCH_LINE.findall(out)}


def start_cli(args, world: int, torchrun: bool = False):
    """``cli.train`` in ``world`` processes (one without ``--multihost``
    at world 1); by torchrun or with its environment set here."""
    cli = ["-m", "egovlp_tpu_torch.cli.train", *args, "--device", "cpu"]
    kw = dict(cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
              text=True)
    if world == 1:
        return [subprocess.Popen([sys.executable, *cli], env=process_env(),
                                 **kw)]
    if torchrun:
        return [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={world}", *cli, "--multihost"],
            env=process_env(), **kw)]
    port = free_port()
    return [subprocess.Popen([sys.executable, *cli, "--multihost"],
                             env=rank_env(r, world, port), **kw)
            for r in range(world)]


def run_dir(save_dir):
    (d,) = (save_dir / "models" / "tiny_egoclip").iterdir()
    for kind in ("log", "tf"):  # one timestamp for every rank
        assert [p.name for p in (save_dir / kind / "tiny_egoclip").iterdir()
                ] == [d.name], kind
    return d


@pytest.fixture(scope="module")
def runs(egoclip_root, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("ddp_task")
    vocab = tmp / "vocab.txt"
    vocab.write_text("\n".join(VOCAB))

    def config(name, epochs, world, mesh=None):
        cfg = tiny_config(egoclip_root, str(vocab), "", str(tmp / name),
                          epochs=epochs)
        cfg["n_devices"] = world
        cfg["data_loader"]["args"]["batch_size"] = 2 // world
        if mesh:
            cfg["mesh"] = mesh
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return ["--config", str(path)]

    procs = {"A": start_cli(config("A", 2, 1), 1),
             "B": start_cli(config("B", 1, 2), 2),
             "D": start_cli(config("D", 2, 2), 2, torchrun=True),
             "E": start_cli(config("E", 2, 2, {"model": 2,
                                               "sequence_parallel": True}),
                            2)}
    outs = {name: wait_all(p, timeout=240) for name, p in procs.items()}
    ckpt = run_dir(tmp / "B") / "checkpoint-epoch1.pth"
    outs["C"] = wait_all(start_cli(
        config("C", 2, 2) + ["--resume", str(ckpt)], 2), timeout=240)
    return dict(tmp=tmp, vocab=str(vocab), root=egoclip_root, ckpt=ckpt,
                outs=outs,
                logs={k: epoch_logs(v[0]) for k, v in outs.items()})


def test_two_processes_match_one(runs):
    a, b, c, d = (runs["logs"][k] for k in "ABCD")
    keys = {"loss_0", "Intra-video", "Inter-video"}
    assert {k for _, k in a} == keys
    assert sorted(b) == sorted((1, k) for k in keys)
    assert sorted(c) == sorted((2, k) for k in keys)  # epoch 2 alone
    assert sorted(d) == sorted(a)
    for key, val in b.items():
        assert val == pytest.approx(d[key], rel=1e-6, abs=1e-8), key
    for key, val in c.items():
        assert val == pytest.approx(d[key], rel=1e-6, abs=1e-8), key
    for key, val in d.items():
        tol = 2e-3 if key[0] == 1 else 1e-2
        assert val == pytest.approx(a[key], rel=tol, abs=1e-5), key


def test_sequence_parallel_run_matches_one_process(runs):
    a, e = runs["logs"]["A"], runs["logs"]["E"]
    assert sorted(e) == sorted(a)
    for key, val in e.items():
        tol = 2e-3 if key[0] == 1 else 1e-2
        assert val == pytest.approx(a[key], rel=tol, abs=1e-5), key
    # the last checkpoint: the whole video tower, strictly into one process
    payload = torch.load(run_dir(runs["tmp"] / "E") / "checkpoint-epoch2.pth",
                         weights_only=True)
    model, _ = build.build_model(tiny_config(
        runs["root"], runs["vocab"], "", "")["arch"], "cpu")
    model.load_state_dict(payload["state_dict"], strict=True)


def test_rank_0_alone_logs_and_writes_one_run(runs):
    b0, b1 = runs["outs"]["B"]
    assert " - INFO - " in b0 and " - INFO - " not in b1, b1
    for name, epochs in (("A", (1, 2)), ("B", (1,)), ("C", (2,)),
                         ("D", (1, 2))):
        ckpts = [f"checkpoint-epoch{e}.pth" for e in epochs]
        d = run_dir(runs["tmp"] / name)
        names = sorted(p.name for p in d.iterdir())
        assert names == sorted(ckpts + ["config.json", "model_best.pth"]), (
            name, names)
        assert json.loads((d / "config.json").read_text())["name"] == \
            "tiny_egoclip"
    payload = torch.load(runs["ckpt"], weights_only=True)
    assert payload["epoch"] == 1 and payload["step"] == 3
    assert not [k for k in payload["state_dict"] if k.startswith("module.")]


def test_the_two_process_checkpoint_loads_in_one_process(runs, monkeypatch):
    cfg = tiny_config(runs["root"], runs["vocab"], "",
                      str(runs["tmp"] / "resumed1"), epochs=2)
    logs = []
    record_port(monkeypatch, logs)
    recipes.run_task(Config(cfg), resume=str(runs["ckpt"]), device="cpu")
    assert [(kind, epoch) for kind, epoch, *_ in logs] == [("train", 2),
                                                          ("val", 2)]
    a = runs["logs"]["A"]
    assert logs[0][2]["loss_0"] == pytest.approx(a[(2, "loss_0")], rel=1e-2)
    for k, v in logs[1][2].items():
        assert v == pytest.approx(a[(2, k)], rel=1e-2, abs=1e-5), k

    path = runs["tmp"] / "eval.json"
    path.write_text(json.dumps(cfg))
    got = cli_eval.main(["--config", str(path), "--checkpoint",
                         str(runs["ckpt"]), "--device", "cpu"])
    b = runs["logs"]["B"]
    assert got == {k: b[(1, k)] for k in ("Intra-video", "Inter-video")}


def test_cli_eval_multihost_matches_one_process(runs):
    cfg = tiny_config(runs["root"], runs["vocab"], "",
                      str(runs["tmp"] / "eval2"))
    cfg["trainer"]["val_batch_size"] = 1  # one process's batches
    path = runs["tmp"] / "eval2.json"
    path.write_text(json.dumps(cfg))
    args = ["--config", str(path), "--checkpoint", str(runs["ckpt"]),
            "--device", "cpu"]
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "egovlp_tpu_torch.cli.eval", *args,
         "--multihost"], env=rank_env(r, 2, port), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = wait_all(procs)
    want = cli_eval.main(args)
    # rank 0 prints the accuracies as JSON, rank 1 nothing
    assert json.loads(outs[0][outs[0].index("{"):]) == want
    assert "{" not in outs[1], outs[1]
