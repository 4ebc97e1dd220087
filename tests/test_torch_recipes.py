"""The port's EgoMCQ evaluation, ``run_task`` and the train / eval CLIs vs
the JAX package (CPU, float32).

* ``mcq_scores`` against JAX ``_mcq_scores`` on the same weights
  (``params_from_jax``): relative 1e-5, equal accuracies;
* the port's eval chain reproduces ``tests/fixtures/golden_egomcq.npz``
  (recorded with reference semantics), as ``tests/test_golden_eval.py``
  does for the JAX package;
* a tiny ``run_task`` on the synthetic EgoClip tree (``egoclip_root``,
  2 epochs of 3 steps of 2 + 2 clips, EgoMCQ validation each epoch) on
  ``device='cpu'`` against JAX ``run_task``: both load one ``.pth``, run
  float32 on one device, and the port's crops are JAX's boxes for the
  same step key.  The epochs' ``loss_0`` agree to rtol 1e-4 and the
  accuracies are equal;
* resume, the eval-only preset through ``cli.train``, ``cli.eval`` on a
  checkpoint, and the keys and devices that raise.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

import egovlp_tpu.train.recipes as jax_recipes
from egovlp_tpu.data.pipeline import collate as jax_collate
from egovlp_tpu.evals.egomcq import _mcq_scores as jax_mcq_scores
from egovlp_tpu.io.config import Config as JaxConfig
from egovlp_tpu.metrics.egomcq import (
    egomcq_accuracy_metrics as jax_egomcq_accuracy_metrics,
)
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.models.convert import save_torch_checkpoint
from egovlp_tpu_torch.cli import eval as cli_eval
from egovlp_tpu_torch.cli import train as cli_train
from egovlp_tpu_torch.data.pipeline import Loader, collate
from egovlp_tpu_torch.evals.egomcq import evaluate_egomcq, mcq_scores
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.metrics.egomcq import egomcq_accuracy_metrics
from egovlp_tpu_torch.models import DualEncoder, DualEncoderConfig
from egovlp_tpu_torch.models import TextTowerConfig, VideoTowerConfig
from egovlp_tpu_torch.models.convert import load_pth
from egovlp_tpu_torch.train import recipes
from egovlp_tpu_torch.train import steps as port_steps
from tests.test_datasets import egoclip_root  # noqa: F401
from tests.test_golden_eval import FIXTURE as GOLDEN_MCQ
from tests.test_golden_eval import _McqFixtureDataset
from tests.test_golden_convert import FIXTURE as GOLDEN_CKPT
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)
from tests.test_torch_train import jax_boxes

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "#", "c", "does", "thing",
         "query", "opt"] + [str(i) for i in range(10)]


# --------------------------------------------------------------------------
# EgoMCQ scores
# --------------------------------------------------------------------------

def mcq_batch(seed, B=3, pre=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, TEXT["vocab_size"], (B, 8)).astype(np.int32)
    mask = np.ones((B, 8), np.int32)
    mask[0, 5:] = 0
    items = [{"frames_options": rng.integers(0, 256, (5, 4, pre, pre, 3),
                                             dtype=np.uint8),
              "text_ids": ids[i], "text_mask": mask[i],
              "correct": np.int64(rng.integers(0, 5)),
              "type": np.int64(1 + i % 2)} for i in range(B)]
    return items


def test_mcq_scores_match_jax():
    params = random_params(3)
    model = port_model(params)
    items = mcq_batch(0)
    want = np.asarray(jax_mcq_scores(JaxDualEncoder(jax_config()).apply,
                                     params, jax_collate(items), RES))
    got = mcq_scores(model, collate(items), RES)
    assert got.shape == (3, 5) and got.dtype == np.float32
    # float32 through both towers and a cosine: ~1e-7 apart
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    b = collate(items)
    assert egomcq_accuracy_metrics(got, b["correct"], b["type"]) == \
        jax_egomcq_accuracy_metrics(want, b["correct"], b["type"])


GOLDEN_CFG = DualEncoderConfig(
    video=VideoTowerConfig(img_size=32, patch_size=16, embed_dim=24, depth=2,
                           num_heads=2, num_frames=4),
    text=TextTowerConfig(vocab_size=100, dim=32, n_layers=2, n_heads=4,
                         hidden_dim=64, max_position_embeddings=48),
    projection_dim=8)


def test_golden_egomcq_via_the_port_eval_chain(tmp_path):
    """In-memory dataset -> Loader (collate, ``_index``) -> ``eval_resize``
    -> both towers -> scores -> metric, on the golden checkpoint."""
    ckpt = np.load(GOLDEN_CKPT)
    sd = {k[len("sd/"):]: torch.from_numpy(ckpt[k]) for k in ckpt.files
          if k.startswith("sd/")}
    path = tmp_path / "golden.pth"
    torch.save({"state_dict": sd}, path)
    model = DualEncoder(GOLDEN_CFG)
    model.load_state_dict(load_pth(str(path), 4), strict=True)
    data = np.load(GOLDEN_MCQ)
    loader = Loader(_McqFixtureDataset(data), batch_size=3, num_workers=1,
                    shuffle=False, drop_last=False)
    m = evaluate_egomcq(model, loader, input_res=32)
    assert m["Intra-video"] == pytest.approx(float(data["metric_intra"]))
    assert m["Inter-video"] == pytest.approx(float(data["metric_inter"]))
    items = [_McqFixtureDataset(data).get(i, None)
             for i in range(len(data["correct"]))]
    # the JAX test's limit for the same recording
    np.testing.assert_allclose(mcq_scores(model, collate(items), 32),
                               data["scores"], rtol=5e-4, atol=5e-4)


# --------------------------------------------------------------------------
# run_task
# --------------------------------------------------------------------------

def tiny_config(root, vocab, ckpt, save_dir, **trainer):
    video = {k: v for k, v in VIDEO.items()}
    return {
        "name": "tiny_egoclip",
        "task": "egoclip",
        "n_devices": 1,
        "arch": {"type": "FrozenInTime", "args": {
            "video_params": {"model": "SpaceTimeTransformer", **video},
            "text_params": {**TEXT, "max_length": 8, "vocab": vocab},
            "projection": "minimal", "projection_dim": 8,
            "load_checkpoint": ckpt, "precision": "fp32"}},
        "data_loader": {"type": "Loader", "args": {
            "dataset_name": "EgoClip_EgoMCQ", "data_dir": root,
            "meta_dir": root, "batch_size": 2, "num_workers": 2,
            "neg_param": 1,
            "video_params": {"input_res": RES, "num_frames": 4,
                             "pre_size": 40, "loading": "strict"}}},
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3}},
        "loss": {"type": "EgoNCE", "args": {}},
        "trainer": {"epochs": 2, "save_dir": save_dir, "save_period": 1,
                    "monitor": "max Inter-video", "early_stop": 5,
                    "init_val": False, "lr_milestones": [60, 80],
                    **trainer},
    }


def record_port(monkeypatch, logs):
    """Record the port Trainer's train and val logs, with their epochs."""
    cls = recipes.Trainer

    class Recording(cls):
        def __init__(self, cfg, train_epoch_fn, valid_fn=None, **kw):
            def train(model, opt, epoch, logger):
                out = train_epoch_fn(model, opt, epoch, logger)
                logs.append(("train", epoch, dict(out),
                             opt.param_groups[0]["count"]))
                return out

            def valid(model, epoch, logger):
                out = valid_fn(model, epoch, logger)
                logs.append(("val", epoch, dict(out)))
                return out

            super().__init__(cfg, train, valid, **kw)

    monkeypatch.setattr(recipes, "Trainer", Recording)


def record_jax(monkeypatch, logs):
    cls = jax_recipes.Trainer

    class Recording(cls):
        def __init__(self, cfg, train_epoch_fn, valid_fn=None, **kw):
            def train(state, epoch, mlog):
                state, out = train_epoch_fn(state, epoch, mlog)
                logs.append(("train", epoch, dict(out), int(state.step)))
                return state, out

            def valid(state, epoch, mlog):
                out = valid_fn(state, epoch, mlog)
                logs.append(("val", epoch, dict(out)))
                return out

            super().__init__(cfg, train, valid, **kw)

    monkeypatch.setattr(jax_recipes, "Trainer", Recording)


def jax_crops(monkeypatch):
    """The port's crop boxes become JAX's for the same step: the JAX epoch
    function's key is fold_in(fold_in(PRNGKey(0), epoch), step) and its
    step's transform key the first of split(key)."""
    current = {}
    make_gen = recipes.step_generator

    def step_generator(device, seed, epoch, index):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), epoch), index)
        current["key"] = jax.random.split(key)[0]
        return make_gen(device, seed, epoch, index)

    monkeypatch.setattr(recipes, "step_generator", step_generator)
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, b, src: jax_boxes(current["key"], b, src))


@pytest.fixture(scope="module")
def tiny_run(egoclip_root, tmp_path_factory):  # noqa: F811
    """One JAX ``run_task`` and one port ``run_task`` on the same config."""
    tmp = tmp_path_factory.mktemp("run")
    vocab = tmp / "vocab.txt"
    vocab.write_text("\n".join(VOCAB))
    params = random_params(7)
    ckpt = str(tmp / "init.pth")
    save_torch_checkpoint(params, jax_config(), ckpt)
    mp = pytest.MonkeyPatch()
    jax_logs, port_logs = [], []
    try:
        record_jax(mp, jax_logs)
        record_port(mp, port_logs)
        jax_crops(mp)
        jax_recipes.run_task(JaxConfig(tiny_config(
            egoclip_root, str(vocab), ckpt, str(tmp / "jax"))))
        model, opt = recipes.run_task(
            Config(tiny_config(egoclip_root, str(vocab), ckpt,
                               str(tmp / "port"))), device="cpu")
    finally:
        mp.undo()
    (run_dir,) = (tmp / "port" / "models" / "tiny_egoclip").iterdir()
    return dict(tmp=tmp, vocab=str(vocab), ckpt=ckpt, root=egoclip_root,
                jax_logs=jax_logs, port_logs=port_logs, model=model, opt=opt,
                run_dir=run_dir)


def test_run_task_matches_jax(tiny_run):
    port, want = tiny_run["port_logs"], tiny_run["jax_logs"]
    assert [(kind, epoch) for kind, epoch, *_ in port] == [
        ("train", 1), ("val", 1), ("train", 2), ("val", 2)]
    assert [(kind, epoch) for kind, epoch, *_ in want] == [
        (kind, epoch) for kind, epoch, *_ in port]
    for got, w in zip(port, want):
        if got[0] == "train":
            # float32 through both towers, 3 AdamW steps an epoch at lr 1e-3
            assert got[2].keys() == w[2].keys() == {"loss_0"}
            np.testing.assert_allclose(got[2]["loss_0"], w[2]["loss_0"],
                                       rtol=1e-4)
            assert got[3] == w[3] == 3 * got[1]  # optimizer steps
        else:
            assert got[2] == w[2]
            assert set(got[2]) == {"Intra-video", "Inter-video"}
    names = sorted(p.name for p in tiny_run["run_dir"].iterdir())
    assert names == ["checkpoint-epoch1.pth", "checkpoint-epoch2.pth",
                     "config.json", "model_best.pth"]
    payload = torch.load(tiny_run["run_dir"] / "checkpoint-epoch2.pth",
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 6
    assert payload["monitor_best"] == max(
        log[2]["Inter-video"] for log in port if log[0] == "val")


def test_metric_logger_tags_match_jax(tiny_run):
    """Both ``run_task``s log to ``{save_dir}/tf/{name}/{timestamp}/
    metrics.jsonl`` through their ``MetricLogger``s: the same tags at the
    same steps in the same order; the validation metrics equal, the
    logged losses within the epoch losses' rtol."""
    def records(side):
        (run,) = (tiny_run["tmp"] / side / "tf" / "tiny_egoclip").iterdir()
        return [json.loads(line) for line in open(run / "metrics.jsonl")]

    got, want = records("port"), records("jax")
    assert [(r["step"], r["tag"]) for r in got] == \
        [(r["step"], r["tag"]) for r in want]
    tags = [r["tag"] for r in got]
    assert tags[:2] == ["train/loss", "train/steps_per_sec"]
    assert tags.count("val/Inter-video") == 2  # one a validation, epochs 1-2
    for g, w in zip(got, want):
        if g["tag"].startswith("val/") and "steps_per_sec" not in g["tag"]:
            assert g["value"] == w["value"], g["tag"]
        elif g["tag"] == "train/loss":
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-4)


def test_run_task_resumes_at_the_next_epoch(tiny_run, monkeypatch):
    logs = []
    record_port(monkeypatch, logs)
    cfg = Config(tiny_config(tiny_run["root"], tiny_run["vocab"],
                             tiny_run["ckpt"],
                             str(tiny_run["tmp"] / "resumed"), epochs=3))
    ckpt = tiny_run["run_dir"] / "checkpoint-epoch2.pth"
    model, opt = recipes.run_task(cfg, resume=str(ckpt), device="cpu")
    assert [(kind, epoch) for kind, epoch, *_ in logs] == [("train", 3),
                                                          ("val", 3)]
    assert opt.param_groups[0]["count"] == logs[0][3] == 9
    (run_dir,) = (tiny_run["tmp"] / "resumed" / "models" /
                  "tiny_egoclip").iterdir()
    assert sorted(p.name for p in run_dir.iterdir() if p.suffix == ".pth"
                  )[0] == "checkpoint-epoch3.pth"
    assert not (run_dir / "checkpoint-epoch1.pth").exists()


def test_cli_eval_matches_the_in_run_validation(tiny_run, capsys):
    ckpt = tiny_run["run_dir"] / "checkpoint-epoch2.pth"
    cfg = tiny_config(tiny_run["root"], tiny_run["vocab"], "",
                      str(tiny_run["tmp"] / "eval"))
    path = tiny_run["tmp"] / "eval.json"
    path.write_text(json.dumps(cfg))
    got = cli_eval.main(["--config", str(path), "--checkpoint", str(ckpt),
                         "--device", "cpu"])
    (in_run,) = [log[2] for log in tiny_run["port_logs"]
                 if log[:2] == ("val", 2)]
    assert got == in_run
    out = capsys.readouterr().out
    assert json.loads(out[out.rindex("{"):]) == in_run  # printed as JSON
    # the same numbers in process, on the run's final model
    loader = recipes.build.build_loader(cfg["data_loader"]["args"], "val",
                                        recipes.build.build_tokenizer(
                                            Config(cfg), 8), batch_size=8)
    try:
        assert evaluate_egomcq(tiny_run["model"], loader, RES) == in_run
    finally:
        loader.close()


def test_cli_train_eval_only_preset_writes_no_checkpoint(tiny_run,
                                                        monkeypatch):
    logs = []
    record_port(monkeypatch, logs)
    cfg = tiny_config(tiny_run["root"], tiny_run["vocab"], tiny_run["ckpt"],
                      str(tiny_run["tmp"] / "preset"), epochs=0,
                      init_val=True)
    path = tiny_run["tmp"] / "preset.json"
    path.write_text(json.dumps(cfg))
    cli_train.main(["--config", str(path), "--device", "cpu",
                    "-o", "trainer.val_batch_size=2",
                    "-o", 'name="preset"'])
    assert [(kind, epoch) for kind, epoch, *_ in logs] == [("val", 0)]
    assert set(logs[0][2]) == {"Intra-video", "Inter-video"}
    (run_dir,) = (tiny_run["tmp"] / "preset" / "models" / "preset").iterdir()
    assert [p.name for p in run_dir.iterdir()] == ["config.json"]
    saved = json.loads((run_dir / "config.json").read_text())
    assert saved["trainer"]["val_batch_size"] == 2


@pytest.mark.parametrize("key,value,match", [
    ("task", "nlq", "cli.extract"), ("task", "mq", "cli.extract"),
    ("mesh", {"model": 2}, "mesh 1x0x2"),
    ("mesh", {"model": 2, "sequence_parallel": True}, "mesh 1x0x2"),
    ("mesh", {"zero": 1}, "trains"), ("mesh", {"data": 2}, "world size is 1"),
    ("n_devices", 2, "world size is 1")])
def test_unported_keys_raise(key, value, match, tmp_path, request,
                             monkeypatch):
    """The tasks that train nothing (nlq, mq) raise NotImplementedError
    naming ``cli.extract``; a mesh that does not cover the world (here 1:
    one process; ``model`` 2 with or without sequence parallelism) raises
    ValueError naming the mesh and the world (JAX's ``MeshSpec.resolve``
    text), as does a data-parallel size other than the world size; ZeRO 1
    at world 1 trains, with nothing sharded, the plain run's first
    epoch."""
    if match == "trains":
        run = request.getfixturevalue("tiny_run")
        logs = []
        record_port(monkeypatch, logs)
        cfg = Config(tiny_config(run["root"], run["vocab"], run["ckpt"],
                                 str(tmp_path), epochs=1))
        cfg.override(key, value)
        model, opt = recipes.run_task(cfg, device="cpu")
        assert not opt.mesh_update.sharded()
        assert logs[0][:2] == run["port_logs"][0][:2] == ("train", 1)
        assert logs[0][2] == run["port_logs"][0][2]
        assert logs[1] == run["port_logs"][1]
        return
    cfg = Config(tiny_config("unused", "unused", "", str(tmp_path)))
    cfg.override(key, value)
    if match.startswith("world"):
        with pytest.raises(ValueError, match=f"=2 but the {match}"):
            recipes.run_task(cfg, device="cpu")
    elif match.startswith("mesh"):
        with pytest.raises(ValueError, match=rf"{match} \(dcn x data x "
                                             r"model\) does not cover 1 "
                                             "devices"):
            recipes.run_task(cfg, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=match):
            recipes.run_task(cfg, device="cpu")
    assert not (tmp_path / "models").exists()


def test_cuda_is_the_default_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config("unused", "unused", "", str(tmp_path))
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipes.run_task(Config(copy.deepcopy(cfg)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["--config", str(path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.main(["--config", str(path)])
    assert not (tmp_path / "models").exists()
