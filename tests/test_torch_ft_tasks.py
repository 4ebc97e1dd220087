"""The port's fine-tune entry points on the CPU.

* ``cli.train --device cpu`` on a tiny EPIC MIR config (the adaptive
  max-margin loss, dual-softmax validation) and a tiny CharadesEgo config
  (InfoNCE, 157-class mAP), 2 epochs of 3 steps with validation on the
  test split after each.  The EPIC run is held to the JAX package's
  ``run_task`` on the same config and the same ``.pth``: both float32 on
  one device, the port's crops JAX's boxes for the same step key; the
  epochs' ``loss_0`` agree to rtol 1e-4 and the metrics to rel 1e-6 (the
  same ranks).  (The Charades step and evaluation are held to JAX's in
  ``tests/test_torch_finetune.py``.)
* checkpoints, ``--resume`` training the next epoch only, and
  ``cli.eval`` on the epoch-2 checkpoint giving the in-run validation's
  metrics, with the split defaulting to ``test``;
* the ranking visualizer's page from the EPIC validation and ``cli.eval``.
"""

import copy
import json

import numpy as np
import pytest
import torch

import egovlp_tpu.train.recipes as jax_recipes
from egovlp_tpu.io.config import Config as JaxConfig
from egovlp_tpu.models.convert import save_torch_checkpoint
from egovlp_tpu_torch.cli import eval as cli_eval
from egovlp_tpu_torch.cli import train as cli_train
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.train import recipes
from tests.test_torch_finetune import (  # noqa: F401
    PRE,
    charades_tree,
    ft_vocab,
)
from tests.test_torch_ft_data import graded_root  # noqa: F401
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    random_params,
)
from tests.test_torch_recipes import jax_crops, record_jax, record_port

METRICS = {"epic": {"nDCG_V2T", "nDCG_T2V", "nDCG_AVG", "mAP_V2T",
                    "mAP_T2V", "mAP_AVG"},
           "charades": {"mAP"}}


def ft_config(task, root, vocab, ckpt, save_dir, **trainer):
    """A tiny fine-tune config of ``task`` ('epic' or 'charades')."""
    epic = task == "epic"
    cfg = {
        "name": f"tiny_{task}",
        "task": task,
        "n_devices": 1,
        "arch": {"type": "FrozenInTime", "args": {
            "video_params": {"model": "SpaceTimeTransformer", **VIDEO},
            "text_params": {**TEXT, "max_length": 8, "vocab": vocab},
            "projection": "minimal", "projection_dim": 8,
            "load_checkpoint": ckpt, "precision": "fp32"}},
        "data_loader": {"type": "Loader", "args": {
            "dataset_name": "MultiInstanceRetrieval" if epic
            else "CharadesEgo",
            "data_dir": root, "meta_dir": root, "batch_size": 2,
            "num_workers": 2, "shuffle": True,
            "video_params": {"input_res": RES, "num_frames": 4,
                             "pre_size": PRE, "loading": "strict"}}},
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
        "loss": ({"type": "AdaptiveMaxMarginRankingLoss", "args": {}} if epic
                 else {"type": "NormSoftmaxLoss", "args": {}}),
        "trainer": {"epochs": 2, "save_dir": save_dir, "save_period": 1,
                    "monitor": "max nDCG_AVG" if epic else "max mAP",
                    "early_stop": 5, "init_val": False,
                    "lr_milestones": [60, 80], "max_samples_per_epoch": 6,
                    **trainer},
        "visualizer": {"type": ""},
    }
    if epic:
        cfg["dual_softmax"] = True
    else:
        cfg["charades_classes"] = f"{root}/Charades_v1_classes.txt"
    return cfg


@pytest.fixture(scope="module", params=["epic", "charades"])
def ft_run(request, graded_root, charades_tree,  # noqa: F811
           ft_vocab, tmp_path_factory):  # noqa: F811
    """The port's ``cli.train`` on one tiny config, and for EPIC the JAX
    package's ``run_task`` on it."""
    task = request.param
    root = graded_root if task == "epic" else charades_tree
    tmp = tmp_path_factory.mktemp(f"ft_{task}")
    params = random_params(13)
    ckpt = str(tmp / "init.pth")
    save_torch_checkpoint(params, jax_config(), ckpt)
    mp = pytest.MonkeyPatch()
    jax_logs, port_logs = [], []
    cfg = ft_config(task, root, ft_vocab, ckpt, str(tmp / "port"))
    path = tmp / "cfg.json"
    path.write_text(json.dumps(cfg))
    try:
        record_jax(mp, jax_logs)
        record_port(mp, port_logs)
        jax_crops(mp)
        if task == "epic":
            jax_recipes.run_task(JaxConfig(ft_config(
                task, root, ft_vocab, ckpt, str(tmp / "jax"))))
        model, opt = cli_train.main(["--config", str(path), "--device",
                                     "cpu"])
    finally:
        mp.undo()
    (run_dir,) = (tmp / "port" / "models" / f"tiny_{task}").iterdir()
    return dict(task=task, root=root, tmp=tmp, vocab=ft_vocab, cfg=cfg,
                jax_logs=jax_logs, port_logs=port_logs, model=model,
                opt=opt, run_dir=run_dir)


def test_cli_train_runs_and_matches_jax(ft_run):
    port, want = ft_run["port_logs"], ft_run["jax_logs"]
    assert [(kind, epoch) for kind, epoch, *_ in port] == [
        ("train", 1), ("val", 1), ("train", 2), ("val", 2)]
    for log in port:
        if log[0] == "train":
            assert np.isfinite(log[2]["loss_0"]) and log[2]["loss_0"] > 0
            assert log[3] == 3 * log[1]  # optimizer steps
        else:
            assert set(log[2]) == METRICS[ft_run["task"]]
            assert all(0.0 <= v <= 100.0 for v in log[2].values())
    if ft_run["task"] == "epic":
        assert [(kind, epoch) for kind, epoch, *_ in want] == [
            (kind, epoch) for kind, epoch, *_ in port]
    for got, w in zip(port, want):
        if got[0] == "train":
            # float32 through both towers, 3 AdamW steps an epoch at lr 1e-3
            np.testing.assert_allclose(got[2]["loss_0"], w[2]["loss_0"],
                                       rtol=1e-4)
            assert got[3] == w[3]
        else:
            # the same ranks from embeddings ~1e-6 apart
            assert got[2] == pytest.approx(w[2], rel=1e-6, abs=1e-9)
    names = sorted(p.name for p in ft_run["run_dir"].iterdir())
    assert {"checkpoint-epoch1.pth", "checkpoint-epoch2.pth",
            "config.json"} <= set(names)
    payload = torch.load(ft_run["run_dir"] / "checkpoint-epoch2.pth",
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 6
    monitor = "nDCG_AVG" if ft_run["task"] == "epic" else "mAP"
    assert payload["monitor_best"] == max(
        log[2][monitor] for log in port if log[0] == "val")


def test_cli_train_resumes_at_the_next_epoch(ft_run, monkeypatch):
    logs = []
    record_port(monkeypatch, logs)
    cfg = copy.deepcopy(ft_run["cfg"])
    cfg["trainer"]["save_dir"] = str(ft_run["tmp"] / "resumed")
    path = ft_run["tmp"] / "resume.json"
    path.write_text(json.dumps(cfg))
    ckpt = ft_run["run_dir"] / "checkpoint-epoch2.pth"
    model, opt = cli_train.main(["--config", str(path), "--device", "cpu",
                                 "--resume", str(ckpt),
                                 "-o", "trainer.epochs=3"])
    assert [(kind, epoch) for kind, epoch, *_ in logs] == [("train", 3),
                                                          ("val", 3)]
    assert opt.param_groups[0]["count"] == logs[0][3] == 9
    (run_dir,) = (ft_run["tmp"] / "resumed" / "models" /
                  f"tiny_{ft_run['task']}").iterdir()
    assert (run_dir / "checkpoint-epoch3.pth").exists()
    assert not (run_dir / "checkpoint-epoch1.pth").exists()


def test_cli_eval_matches_the_in_run_validation(ft_run, capsys):
    """``cli.eval`` on the epoch-2 checkpoint, on the test split by
    default (EPIC with the config's dual-softmax setting as the flag)."""
    ckpt = ft_run["run_dir"] / "checkpoint-epoch2.pth"
    cfg = copy.deepcopy(ft_run["cfg"])
    cfg["arch"]["args"]["load_checkpoint"] = ""
    cfg["data_loader"]["args"]["split"] = "train"  # as the eval presets
    path = ft_run["tmp"] / "eval.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config", str(path), "--checkpoint", str(ckpt), "--device",
            "cpu"]
    if ft_run["task"] == "epic":
        argv.append("--dual_softmax")
    got = cli_eval.main(argv)
    (in_run,) = [log[2] for log in ft_run["port_logs"]
                 if log[:2] == ("val", 2)]
    assert got == in_run
    out = capsys.readouterr().out
    assert json.loads(out[out.rindex("{"):]) == in_run  # printed as JSON
    if ft_run["task"] == "epic":  # without the flag: cosine scores
        cosine = cli_eval.main(argv[:-1])
        assert set(cosine) == METRICS["epic"] and cosine != in_run
        assert all(0.0 <= v <= 100.0 for v in cosine.values())


def test_visualizer_is_refused(graded_root, ft_vocab, tmp_path):  # noqa: F811
    """The ranking visualizer, refused until it was ported: the EPIC
    validation of a run with ``visualizer.type`` set writes its page for
    the epoch, and ``cli.eval`` on the run's checkpoint its epoch-0 page,
    both into ``{save_dir}/web``."""
    cfg = Config(ft_config("epic", graded_root, ft_vocab, "", str(tmp_path),
                           epochs=1))
    cfg.override("visualizer.type", "html")
    cfg.override("visualizer.args", {"num_samples": 2, "top_k": 3})
    recipes.run_task(cfg, device="cpu")
    web = tmp_path / "web"
    assert sorted(p.name for p in web.iterdir()) == ["index.html",
                                                     "ranking_ep1.html"]
    page = (web / "ranking_ep1.html").read_text()
    assert page.count('class="query"') == 2 and "GT rank" in page
    assert page.count("<video") >= 2 * 3  # top 3 of each query
    (run_dir,) = (tmp_path / "models" / "tiny_epic").iterdir()
    path = tmp_path / "eval.json"
    path.write_text(json.dumps(dict(cfg)))
    cli_eval.main(["--config", str(path), "--checkpoint",
                   str(run_dir / "checkpoint-epoch1.pth"), "--device", "cpu"])
    assert (web / "ranking_ep0.html").exists()
