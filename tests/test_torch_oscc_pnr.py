"""The port's Ego4D OSCC / PNR fine-tunes vs the JAX package (CPU, float32),
at tiny width (2 video blocks of D 24 at 16 frames, 2 text layers).

* ``sample_state_change_frames`` over a grid of bounds, lengths and
  keyframes (0 and None included): exact;
* OSCC and PNR items, train and val, on a tree with a keyframe past each
  end of the train sub-clip, a keyframe at frame 0 (read as none, from
  the negatives' directory) and a clip without one: the same index and
  item generator give equal items; a missing JPEG under lax and strict
  loading;
* ``cross_entropy``, ``oscc_metrics`` and ``pnr_metrics``: rtol 1e-6;
* one OSCC and one PNR step (a state mask with a zero) against JAX's
  ``make_{oscc,pnr}_train_step`` on JAX's crop boxes: loss and gradients
  rtol 1e-5; the text tower gets no gradient where JAX's is exactly 0;
* ``evaluate_oscc`` / ``evaluate_pnr`` through the Loader against JAX's
  through its Loader;
* ``cli.train`` on tiny OSCC and PNR configs against JAX ``run_task`` from
  one ``.pth``: epoch losses rtol 1e-4, validation metrics equal, and the
  text tower bit-equal to the checkpoint's in both (the port's AdamW skips
  parameters without a gradient, JAX's updates them by 0 at
  ``weight_decay`` 0); resume;
  ``cli.eval`` on the ``val`` split by default, equal to the in-run
  validation.

The JAX side is jitted.
"""

import copy
import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egovlp_tpu.train.recipes as jax_recipes
from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
from egovlp_tpu.data.datasets import dataset_factory as jax_dataset_factory
from egovlp_tpu.data.datasets.oscc_pnr import (
    sample_state_change_frames as jax_sample_sc_frames,
)
from egovlp_tpu.data.pipeline import Loader as JaxLoader
from egovlp_tpu.evals.oscc_pnr import evaluate_oscc as jax_evaluate_oscc
from egovlp_tpu.evals.oscc_pnr import evaluate_pnr as jax_evaluate_pnr
from egovlp_tpu.io.config import Config as JaxConfig
from egovlp_tpu.metrics.oscc_pnr import oscc_metrics as jax_oscc_metrics
from egovlp_tpu.metrics.oscc_pnr import pnr_metrics as jax_pnr_metrics
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.models import DualEncoderConfig as JaxDualEncoderConfig
from egovlp_tpu.models import TextTowerConfig as JaxTextTowerConfig
from egovlp_tpu.models import VideoTowerConfig as JaxVideoTowerConfig
from egovlp_tpu.models.convert import save_torch_checkpoint
from egovlp_tpu.objectives.classification import (
    cross_entropy as jax_cross_entropy,
)
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.steps import make_oscc_train_step as jax_oscc_step
from egovlp_tpu.train.steps import make_pnr_train_step as jax_pnr_step
from egovlp_tpu_torch.cli import eval as cli_eval
from egovlp_tpu_torch.cli import train as cli_train
from egovlp_tpu_torch.data.datasets import (
    DatasetConfig,
    Ego4DOSCCDataset,
    Ego4DPNRDataset,
    dataset_factory,
)
from egovlp_tpu_torch.data.datasets.oscc_pnr import sample_state_change_frames
from egovlp_tpu_torch.data.pipeline import Loader
from egovlp_tpu_torch.evals.oscc_pnr import evaluate_oscc, evaluate_pnr
from egovlp_tpu_torch.metrics.oscc_pnr import oscc_metrics, pnr_metrics
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.objectives.classification import cross_entropy
from egovlp_tpu_torch.train import steps as port_steps
from tests.test_torch_datasets import assert_items_equal
from tests.test_torch_finetune import (  # noqa: F401
    PRE,
    KeepGrads,
    ft_vocab,
    grad_capture,
)
from tests.test_torch_models import RES, TEXT, VIDEO
from tests.test_torch_recipes import jax_crops, record_jax, record_port
from tests.test_torch_train import jax_boxes

VIDEO16 = {**VIDEO, "num_frames": 16}
HEADS = {"oscc": 2, "pnr": 16}  # projection_dim: the class head's logits
# (unique_id, state_change, parent_pnr_frame, parent start / end second):
# sc_late's keyframe lies past most train sub-clips' end, sc_early's
# before their start; sc_zero's keyframe at frame 0 reads as none
CLIPS = [("sc_late", True, 262, 1.0, 9.0), ("neg_a", False, None, 2.0, 10.0),
         ("sc_early", True, 14, 0.0, 8.0), ("sc_zero", True, 0, 0.0, 8.0),
         ("sc_mid", True, 131, 0.5, 8.5), ("neg_b", False, None, 1.5, 9.5)]
N_JPEG = 301  # frames 0-300 in every clip directory


# --------------------------------------------------------------------------
# the frame sampler and the datasets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pnr", [None, 0, 1, 37, 120, 400])
@pytest.mark.parametrize("start,end", [(0, 240), (30, 270), (45, 196),
                                       (17, 33), (0, 16), (149, 290),
                                       (60, 301)])
def test_sample_state_change_frames_equals_jax(start, end, pnr):
    for required in (16, 4, 7):
        if end - start < required:
            continue
        got = sample_state_change_frames(start, end, required, pnr)
        want = jax_sample_sc_frames(start, end, required, pnr)
        assert got == want
        assert len(got[0]) == required
    with pytest.raises(ValueError, match="cannot sample"):
        sample_state_change_frames(0, 15, 16, pnr)


@pytest.fixture(scope="module")
def ego4d_root(tmp_path_factory):
    """Six clips of the JSON schema Ego4D ships, train and val, with JPEG
    directories of 301 frames at 48 x 36 (each frame's pixels its index
    and its clip's number); the two splits list the clips in other
    orders."""
    root = tmp_path_factory.mktemp("ego4d_fho")
    clips = []
    for c, (uid, state, pnr, s0, s1) in enumerate(CLIPS):
        d = root / ("frames_jpeg" if pnr else "frames_jpeg_neg") / uid
        d.mkdir(parents=True)
        for fn in range(N_JPEG):
            img = np.full((36, 48, 3), fn % 256, np.uint8)
            img[:, : 4 * c + 2] = (37 * c) % 256
            cv2.imwrite(str(d / f"{fn}.jpeg"), img)
        clips.append({
            "unique_id": uid, "video_uid": f"v{c}", "clip_id": c,
            "state_change": state, "clip_pnr_frame": pnr,
            "parent_pnr_frame": pnr, "clip_start_sec": 0.0,
            "clip_end_sec": 8.0, "parent_start_sec": s0,
            "parent_end_sec": s1, "clip_start_frame": 0,
            "clip_end_frame": 240, "parent_start_frame": int(s0 * 30),
            "parent_end_frame": int(s1 * 30)})
    (root / "fho_oscc-pnr_train.json").write_text(
        json.dumps({"version": "1", "clips": clips}))
    (root / "fho_oscc-pnr_val.json").write_text(
        json.dumps({"version": "1", "clips": clips[::-1]}))
    return str(root)


def _datasets(name, root, split, **kw):
    opts = dict(data_dir=root, split=split, num_frames=16, pre_size=PRE,
                **kw)
    return (dataset_factory(name)(DatasetConfig(**opts)),
            jax_dataset_factory(name)(JaxDatasetConfig(**opts)))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", ["Ego4D_OSCC", "Ego4D_PNR"])
def test_items_equal_jax(ego4d_root, name, split):
    got, want = _datasets(name, ego4d_root, split)
    assert type(got) is (Ego4DOSCCDataset if name == "Ego4D_OSCC"
                         else Ego4DPNRDataset)
    # PNR keeps the state-change clips (sc_zero's keyframe 0 included)
    assert len(got) == len(want) == (6 if name == "Ego4D_OSCC" else 4)
    widened = set()
    for seed in range(6 if split == "train" else 1):
        for i in range(len(got)):
            a = got.get(i, np.random.default_rng(seed))
            b = want.get(i, np.random.default_rng(seed))
            assert_items_equal(a, b)
            assert a["frames"].shape == (16, PRE, PRE, 3)
            if a["parent_pnr_frame"]:
                assert a["labels"].sum() == 1.0  # a one-hot keyframe
            else:  # the dists list of a clip without a keyframe: zeros
                assert not a["labels"].any()
            first, last = int(a["frames"][0, 0, -1, 0]), int(
                a["frames"][-1, 0, -1, 0])
            widened.add((a["unique_id"], first, last))
    if split == "val":
        item = got.get(0, np.random.default_rng(0))
        # fps = the inclusive frame count over the clip's seconds
        assert item["fps"] == np.float32(241 / 8.0)
    else:  # the random sub-clips differ from seed to seed
        assert len(widened) > len(got)


def test_missing_jpeg_follows_the_loading_policy(ego4d_root, tmp_path):
    """A gap in a clip's frames: lax repeats the last frame read, strict
    raises, both as the JAX dataset does (``extra.no_sc_dir``)."""
    import shutil

    neg = tmp_path / "neg"
    shutil.copytree(f"{ego4d_root}/frames_jpeg_neg", neg)
    (neg / "neg_a" / "75.jpeg").unlink()  # neg_a's 2nd val frame
    for loading in ("lax", "strict"):
        got, want = _datasets("Ego4D_OSCC", ego4d_root, "val",
                              loading=loading, extra={"no_sc_dir": str(neg)})
        i = [m["unique_id"] for m in got.metadata].index("neg_a")
        if loading == "strict":
            with pytest.raises(ValueError, match="missing frame 75"):
                got.get(i, np.random.default_rng(0))
            continue
        a = got.get(i, np.random.default_rng(0))
        assert_items_equal(a, want.get(i, np.random.default_rng(0)))
        np.testing.assert_array_equal(a["frames"][1], a["frames"][0])


# --------------------------------------------------------------------------
# the loss and the metrics
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_cls", [2, 16])
def test_cross_entropy_matches_jax(n_cls):
    rng = np.random.default_rng(n_cls)
    logits = (3 * rng.normal(size=(9, n_cls))).astype(np.float32)
    targets = rng.integers(0, n_cls, 9).astype(np.int32)
    want = float(jax.jit(jax_cross_entropy)(logits, targets))
    for dtype in (torch.float32, torch.bfloat16):
        got = cross_entropy(torch.from_numpy(logits).to(dtype),
                            torch.from_numpy(targets))
        assert got.dtype == torch.float32
        tol = 1e-6 if dtype == torch.float32 else 2e-2
        np.testing.assert_allclose(got.item(), want, rtol=tol)


def test_oscc_and_pnr_metrics_match_jax():
    rng = np.random.default_rng(3)
    n = 11
    preds2 = rng.normal(size=(n, 2))
    states = rng.integers(0, 2, n)
    got = oscc_metrics(preds2, states)
    assert got == jax_oscc_metrics(preds2, states)
    assert 0.0 <= got["accuracy"] <= 100.0
    preds16 = rng.normal(size=(n, 16)).astype(np.float32)
    start = rng.integers(0, 300, n).astype(np.int32)
    end = (start + 240).astype(np.int32)
    pnr = (start + rng.integers(0, 240, n)).astype(np.int32)
    fps = np.full(n, 241 / 8.0, np.float32)
    labels = np.eye(16, dtype=np.float32)[rng.integers(0, 16, n)]
    args = (preds16, labels, states, fps, start, end, pnr)
    got = pnr_metrics(*args)
    np.testing.assert_allclose(got["keyframe_distance"],
                               jax_pnr_metrics(*args)["keyframe_distance"],
                               rtol=1e-6)
    assert got["keyframe_distance"] >= 0.0
    # no state-change clip: 0, as the reference reports
    none = (preds16, labels, np.zeros(n), fps, start, end, pnr)
    assert pnr_metrics(*none) == jax_pnr_metrics(*none) == {
        "keyframe_distance": 0.0}


# --------------------------------------------------------------------------
# one step against the JAX step
# --------------------------------------------------------------------------

def jax_config(proj: int) -> JaxDualEncoderConfig:
    return JaxDualEncoderConfig(
        video=JaxVideoTowerConfig(**VIDEO16, attention_impl="xla"),
        text=JaxTextTowerConfig(**TEXT), projection_dim=proj)


def random_params(seed: int, proj: int):
    """The tiny 16-frame JAX dual encoder's params from a numpy seed:
    LayerNorm scales near 1, every other leaf normal with std 0.2."""
    shapes = jax.eval_shape(
        JaxDualEncoder(jax_config(proj)).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, RES, RES, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.normal(size=s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.2 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_model(params, proj: int) -> DualEncoder:
    model = DualEncoder(DualEncoderConfig(
        video=VideoTowerConfig(**VIDEO16), text=TextTowerConfig(**TEXT),
        projection_dim=proj)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def sc_batch(seed, b=4, states=(1, 0, 1, 1)):
    """A collated OSCC / PNR batch: 16 frames, one-hot keyframe labels on
    the state-change rows, zeros elsewhere."""
    rng = np.random.default_rng(seed)
    state = np.asarray(states[:b], np.int32)
    labels = np.eye(16, dtype=np.float32)[rng.integers(0, 16, b)]
    labels[state == 0] = 0.0
    return {"frames": rng.integers(0, 256, (b, 16, PRE, PRE, 3),
                                   dtype=np.uint8),
            "labels": labels, "state": state,
            "fps": np.full(b, 241 / 8.0, np.float32),
            "unique_id": [f"u{i}" for i in range(b)]}


STEPS = {"oscc": (jax_oscc_step, port_steps.make_oscc_train_step),
         "pnr": (jax_pnr_step, port_steps.make_pnr_train_step)}


def text_keys(model):
    return [k for k, _ in model.named_parameters()
            if k.startswith(("text_model.", "txt_proj."))]


@pytest.mark.parametrize("task", ["oscc", "pnr"])
def test_step_loss_and_grads_match_jax(task, monkeypatch):
    proj = HEADS[task]
    params = random_params(20 + proj, proj)
    batch = sc_batch(30 + proj)
    jax_make, port_make = STEPS[task]
    rng = jax.random.PRNGKey(5)
    state = create_train_state(JaxDualEncoder(jax_config(proj)), params,
                               grad_capture())
    state, want = jax_make(input_res=RES)(state, batch, rng)
    want_g = params_from_jax(jax.tree.map(np.asarray, state.opt_state))
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, b, src: jax_boxes(
                            jax.random.split(rng)[0], b, src))
    model = port_model(params, proj)
    inputs = {k: torch.from_numpy(v) for k, v in
              port_steps.numeric_batch(batch).items()}
    got = port_make(input_res=RES)(model, KeepGrads(model), inputs,
                                   torch.Generator())
    # float32 through 2 blocks at 16 frames and a softmax
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    text = set(text_keys(model))
    assert text and all(model.get_parameter(k).grad is None for k in text)
    g_max = max(w.abs().max().item() for w in want_g.values())
    for k, w in want_g.items():
        if k in text:  # JAX differentiates through nothing there
            assert not w.abs().any(), k
            continue
        # float32 sums over 4 clips x 16 frames in another order: a floor
        # of 1e-5 of the largest gradient for elements that cancel (the
        # key biases' are 0 in exact arithmetic)
        np.testing.assert_allclose(model.get_parameter(k).grad.numpy(),
                                   w.numpy(), rtol=1e-5, atol=1e-5 * g_max,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the evaluations through the Loader
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["oscc", "pnr"])
def test_evaluation_matches_jax(task, ego4d_root):
    proj = HEADS[task]
    params = random_params(50 + proj, proj)
    name = "Ego4D_OSCC" if task == "oscc" else "Ego4D_PNR"
    port_ds, jax_ds = _datasets(name, ego4d_root, "val")
    opts = dict(batch_size=4, num_workers=2, drop_last=False, shuffle=True,
                seed=3)
    port_l, jax_l = Loader(port_ds, **opts), JaxLoader(jax_ds, **opts)
    try:
        got = (evaluate_oscc if task == "oscc" else evaluate_pnr)(
            port_model(params, proj), port_l, RES)
        want = (jax_evaluate_oscc if task == "oscc" else jax_evaluate_pnr)(
            JaxDualEncoder(jax_config(proj)), params, jax_l, RES)
    finally:
        port_l.close()
        jax_l.close()
    # float32 logits ~1e-6 apart: the same argmax, so equal metrics
    assert got == want
    key = "accuracy" if task == "oscc" else "keyframe_distance"
    assert set(got) == {key} and got[key] >= 0.0


# --------------------------------------------------------------------------
# cli.train / run_task against JAX run_task; resume; cli.eval
# --------------------------------------------------------------------------

def sc_config(task, root, vocab, ckpt, save_dir, **trainer):
    return {
        "name": f"tiny_{task}",
        "task": task,
        "n_devices": 1,
        "arch": {"type": "FrozenInTime", "args": {
            "video_params": {"model": "SpaceTimeTransformer", **VIDEO16},
            "text_params": {**TEXT, "max_length": 8, "vocab": vocab},
            "projection": "minimal", "projection_dim": HEADS[task],
            "load_checkpoint": ckpt, "precision": "fp32"}},
        "data_loader": {"type": "Loader", "args": {
            "dataset_name": "Ego4D_OSCC" if task == "oscc" else "Ego4D_PNR",
            "data_dir": root, "meta_dir": root, "batch_size": 2,
            "num_workers": 2, "shuffle": True, "split": "train",
            "video_params": {"input_res": RES, "num_frames": 16,
                             "pre_size": PRE, "loading": "strict"}}},
        "optimizer": {"type": "AdamW", "args": {"lr": 1e-3,
                                                "mu_dtype": "bfloat16"}},
        "loss": {"type": "CrossEntropy", "args": {}},
        "trainer": {"epochs": 2, "save_dir": save_dir, "save_period": 1,
                    "monitor": ("max accuracy" if task == "oscc"
                                else "min keyframe_distance"),
                    "early_stop": 5, "init_val": False,
                    "lr_milestones": [60, 80], "max_samples_per_epoch": 4,
                    **trainer},
        "visualizer": {"type": ""},
    }


@pytest.fixture(scope="module", params=["oscc", "pnr"])
def sc_run(request, ego4d_root, ft_vocab,  # noqa: F811
           tmp_path_factory):
    """The port's ``cli.train`` and the JAX package's ``run_task`` on one
    tiny config from one ``.pth``."""
    task = request.param
    tmp = tmp_path_factory.mktemp(f"sc_{task}")
    params = random_params(60 + HEADS[task], HEADS[task])
    ckpt = str(tmp / "init.pth")
    save_torch_checkpoint(params, jax_config(HEADS[task]), ckpt)
    mp = pytest.MonkeyPatch()
    jax_logs, port_logs = [], []
    cfg = sc_config(task, ego4d_root, ft_vocab, ckpt, str(tmp / "port"))
    path = tmp / "cfg.json"
    path.write_text(json.dumps(cfg))
    try:
        record_jax(mp, jax_logs)
        record_port(mp, port_logs)
        jax_crops(mp)
        jax_state = jax_recipes.run_task(JaxConfig(sc_config(
            task, ego4d_root, ft_vocab, ckpt, str(tmp / "jax"))))
        model, opt = cli_train.main(["--config", str(path), "--device",
                                     "cpu"])
    finally:
        mp.undo()
    (run_dir,) = (tmp / "port" / "models" / f"tiny_{task}").iterdir()
    return dict(task=task, tmp=tmp, cfg=cfg, params=params, model=model,
                jax_params=jax.tree.map(np.asarray, jax_state.params),
                jax_logs=jax_logs, port_logs=port_logs, run_dir=run_dir)


def test_cli_train_matches_jax_run_task(sc_run):
    port, want = sc_run["port_logs"], sc_run["jax_logs"]
    key = "accuracy" if sc_run["task"] == "oscc" else "keyframe_distance"
    assert [(kind, epoch) for kind, epoch, *_ in port] == [
        ("train", 1), ("val", 1), ("train", 2), ("val", 2)]
    assert [(kind, epoch) for kind, epoch, *_ in want] == [
        (kind, epoch) for kind, epoch, *_ in port]
    for got, w in zip(port, want):
        if got[0] == "train":
            assert np.isfinite(got[2]["loss_0"]) and got[3] == 2 * got[1]
            # float32 through both towers, 2 AdamW steps an epoch at 1e-3
            np.testing.assert_allclose(got[2]["loss_0"], w[2]["loss_0"],
                                       rtol=1e-4)
            assert got[3] == w[3]
        else:
            assert set(got[2]) == {key} and got[2] == w[2]
    # the text tower never trains: the port's AdamW skips it (no
    # gradient), JAX's moves it by 0 / (0 + eps) at weight_decay 0; both
    # bit-equal to the checkpoint's (a known difference only where a
    # config sets weight_decay)
    before = params_from_jax(sc_run["params"])
    jax_after = params_from_jax(sc_run["jax_params"])
    for k in text_keys(sc_run["model"]):
        assert torch.equal(sc_run["model"].get_parameter(k).detach(),
                           before[k]), k
        assert torch.equal(jax_after[k], before[k]), k
    assert not torch.equal(jax_after["vid_proj.0.weight"],
                           before["vid_proj.0.weight"])
    payload = torch.load(sc_run["run_dir"] / "checkpoint-epoch2.pth",
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["step"] == 4
    vals = [log[2][key] for log in port if log[0] == "val"]
    assert payload["monitor_best"] == (max(vals) if key == "accuracy"
                                       else min(vals))


def test_cli_train_resumes_at_the_next_epoch(sc_run, monkeypatch):
    logs = []
    record_port(monkeypatch, logs)
    cfg = copy.deepcopy(sc_run["cfg"])
    cfg["trainer"]["save_dir"] = str(sc_run["tmp"] / "resumed")
    path = sc_run["tmp"] / "resume.json"
    path.write_text(json.dumps(cfg))
    _, opt = cli_train.main(["--config", str(path), "--device", "cpu",
                             "--resume",
                             str(sc_run["run_dir"] / "checkpoint-epoch2.pth"),
                             "-o", "trainer.epochs=3"])
    assert [(kind, epoch) for kind, epoch, *_ in logs] == [("train", 3),
                                                          ("val", 3)]
    assert opt.param_groups[0]["count"] == logs[0][3] == 6


def test_cli_eval_defaults_to_val_and_matches_in_run(sc_run, capsys,
                                                     monkeypatch):
    """``cli.eval`` on the epoch-2 checkpoint with no ``--split``: the
    ``val`` split (JAX's default for oscc/pnr), the in-run metrics."""
    splits = []
    build_loader = cli_eval.build.build_loader

    def recording(dl_args, split, *a, **kw):
        splits.append(split)
        return build_loader(dl_args, split, *a, **kw)

    monkeypatch.setattr(cli_eval.build, "build_loader", recording)
    cfg = copy.deepcopy(sc_run["cfg"])
    cfg["arch"]["args"]["load_checkpoint"] = ""
    path = sc_run["tmp"] / "eval.json"
    path.write_text(json.dumps(cfg))
    got = cli_eval.main(["--config", str(path), "--checkpoint",
                         str(sc_run["run_dir"] / "checkpoint-epoch2.pth"),
                         "--device", "cpu"])
    assert splits == ["val"]
    (in_run,) = [log[2] for log in sc_run["port_logs"]
                 if log[:2] == ("val", 2)]
    assert got == in_run
    out = capsys.readouterr().out
    assert json.loads(out[out.rindex("{"):]) == in_run
