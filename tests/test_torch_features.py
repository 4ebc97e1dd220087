"""The port's Ego4D NLQ / MQ feature extraction vs the JAX package (CPU,
float32, tiny width: 2 video blocks of D 24 at 4 frames, 2 text layers).

* ``sample_frames_clips`` over a grid of bounds, lengths and counts:
  exact;
* NLQ items in video and text modes and MQ items (forced to video), on a
  tree of two videos, three clips and six queries (two empty, dropped):
  equal to the JAX datasets' items;
* ``extract_video_features`` (micro-batches of 4 over 9 windows, the last
  of one window: the JAX package pads it, the port does not) and
  ``extract_text_features`` (CLS and token level), ``.npy`` and ``.pt``,
  against the JAX functions on the same weights: rtol 1e-5;
* ``cli.extract`` end to end: video features equal JAX ``cli.extract``'s
  from one ``.pth`` (rtol 1e-5), text features (CLS and token level) and
  MQ; ``--device`` defaults to cuda.  (``cli.eval``'s refusal of nlq /
  mq: ``tests/test_torch_finetune.py``.)
"""

import json

import numpy as np
import pytest
import torch

from egovlp_tpu.cli.extract import main as jax_extract_main
from egovlp_tpu.data import samplers as jax_samplers
from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
from egovlp_tpu.data.datasets import dataset_factory as jax_dataset_factory
from egovlp_tpu.data.text import WordPieceTokenizer as JaxTokenizer
from egovlp_tpu.evals.features import (
    extract_text_features as jax_extract_text,
)
from egovlp_tpu.evals.features import (
    extract_video_features as jax_extract_video,
)
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.models.convert import save_torch_checkpoint
from egovlp_tpu_torch.cli import extract as cli_extract
from egovlp_tpu_torch.data import samplers
from egovlp_tpu_torch.data.datasets import (
    DatasetConfig,
    Ego4DMQDataset,
    Ego4DNLQDataset,
    dataset_factory,
)
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.evals.features import (
    extract_text_features,
    extract_video_features,
)
from tests.test_readers import make_video
from tests.test_torch_datasets import assert_items_equal
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)

PRE = 32
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "where", "did", "i", "put",
         "the", "knife", "who", "talk", "to", "open", "door"]
# (video, clip, start s, end s, queries); 9 windows of 4 frames in clip_b
CLIPS = [("vid_a", "clip_a", 0.0, 2.5, ["where did i put the knife", "",
                                        "who did i talk to"]),
         ("vid_a", "clip_b", 0.5, 5.5, ["open the door", ""]),
         ("vid_b", "clip_c", 1.0, 2.9, ["who did i talk to"])]


@pytest.mark.parametrize("acc", [1, 4, 16, 37])
@pytest.mark.parametrize("start,end,vlen", [(0, 75, 90), (15, 165, 180),
                                            (-5, 40, 30), (30, 87, 300),
                                            (10, 12, 50)])
def test_sample_frames_clips_equals_jax(start, end, vlen, acc):
    got = samplers.sample_frames_clips(start, end, vlen, acc)
    assert got == jax_samplers.sample_frames_clips(start, end, vlen, acc)
    assert len(got) == acc


@pytest.fixture(scope="module")
def em_root(tmp_path_factory):
    """Two 30-fps videos (6 s and 3 s) and the NLQ / MQ val json: three
    clips, six queries (two empty); the MQ json has the same clips."""
    root = tmp_path_factory.mktemp("ego4d_em")
    make_video(root / "vid_a.mp4", n_frames=180)
    make_video(root / "vid_b.mp4", n_frames=90, size=(48, 64))
    videos = {}
    for vid, clip, s0, s1, queries in CLIPS:
        videos.setdefault(vid, []).append({
            "clip_uid": clip, "video_start_sec": s0, "video_end_sec": s1,
            "annotations": [{"language_queries": [{"query": q}
                                                  for q in queries]}]})
    anno = {"videos": [{"video_uid": v, "clips": c}
                       for v, c in videos.items()]}
    for name in ("nlq_val.json", "moments_val.json"):
        (root / name).write_text(json.dumps(anno))
    (root / "vocab.txt").write_text("\n".join(WORDS))
    return str(root)


def _datasets(name, root, subsample):
    opts = dict(data_dir=root, split="val", num_frames=4, pre_size=PRE,
                subsample=subsample)
    return (dataset_factory(name)(DatasetConfig(**opts)),
            jax_dataset_factory(name)(JaxDatasetConfig(**opts)))


@pytest.mark.parametrize("name,subsample", [
    ("Ego4D_NLQ", "video"), ("Ego4D_NLQ", "text"), ("Ego4D_MQ", "text"),
    ("Ego4D_MQ", 1)])
def test_items_equal_jax(em_root, name, subsample):
    got, want = _datasets(name, em_root, subsample)
    assert type(got) is (Ego4DNLQDataset if name == "Ego4D_NLQ"
                         else Ego4DMQDataset)
    mode = "video" if name == "Ego4D_MQ" else subsample  # MQ: video only
    assert got.cfg.subsample == mode
    assert len(got) == len(want) == (3 if mode == "video" else 4)
    for i in range(len(got)):
        a = got.get(i, np.random.default_rng(i))
        b = want.get(i, np.random.default_rng(i))
        assert list(a) == list(b) and a["meta"] == b["meta"]
        if mode == "text":
            assert a["text"] == b["text"] and a["text"]
        else:
            assert_items_equal({"frames": a["frames"]},
                               {"frames": b["frames"]})
    if mode == "video":  # 5 s of clip_b at 1.87 fps x 4 frames
        assert got.get(1, None)["frames"].shape == (37, PRE, PRE, 3)
    else:  # the empty queries are dropped
        assert [got.get(i, None)["text"] for i in range(4)] == [
            "where did i put the knife", "who did i talk to",
            "open the door", "who did i talk to"]


def test_nlq_refuses_another_subsample(em_root):
    with pytest.raises(ValueError, match="subsample='video' or 'text'"):
        _datasets("Ego4D_NLQ", em_root, 1)


def _load(path):
    if path.suffix == ".pt":
        return torch.load(path, weights_only=True).numpy()
    return np.load(path)


@pytest.mark.parametrize("save_format", ["npy", "pt"])
def test_extract_video_features_match_jax(em_root, tmp_path, save_format):
    params = random_params(70)
    port_ds, jax_ds = _datasets("Ego4D_MQ", em_root, "video")
    extract_video_features(port_model(params), port_ds, tmp_path / "port",
                           num_frames=4, input_res=RES, micro_batch=4,
                           save_format=save_format)
    jax_extract_video(JaxDualEncoder(jax_config()), params, jax_ds,
                      str(tmp_path / "jax"), num_frames=4, input_res=RES,
                      micro_batch=4, save_format=save_format)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"clip_{c}.{save_format}" for c in "abc"]
    # windows: 18 // 4, 37 // 4 (the last micro-batch one window), 14 // 4
    for name, n in zip(names, (4, 9, 3)):
        got, want = (_load(tmp_path / d / name) for d in ("port", "jax"))
        assert got.shape == (n, 8) and got.dtype == np.float32
        # float32 through 2 blocks, summed in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("token_level", [False, True])
def test_extract_text_features_match_jax(em_root, tmp_path, token_level):
    params = random_params(71)
    port_ds, jax_ds = _datasets("Ego4D_NLQ", em_root, "text")
    vocab = f"{em_root}/vocab.txt"
    fmt = "pt" if token_level else "npy"
    extract_text_features(port_model(params), port_ds,
                          WordPieceTokenizer(vocab, max_length=8),
                          tmp_path / "port", token_level=token_level,
                          save_format=fmt)
    jax_extract_text(JaxDualEncoder(jax_config()), params, jax_ds,
                     JaxTokenizer(vocab, max_length=8), str(tmp_path / "jax"),
                     token_level=token_level, save_format=fmt)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"clip_a_sentence_0.{fmt}", f"clip_a_sentence_1.{fmt}",
                     f"clip_b_sentence_0.{fmt}", f"clip_c_sentence_0.{fmt}"]
    for name in names:
        got, want = (_load(tmp_path / d / name) for d in ("port", "jax"))
        assert got.shape == ((8, 8) if token_level else (8,))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def em_config(task, root, ckpt):
    return {
        "name": f"tiny_{task}_extract", "task": task,
        "arch": {"type": "FrozenInTime", "args": {
            "video_params": {"model": "SpaceTimeTransformer", **VIDEO},
            "text_params": {**TEXT, "max_length": 8,
                            "vocab": f"{root}/vocab.txt"},
            "projection": "minimal", "projection_dim": 8,
            "load_checkpoint": ckpt, "precision": "fp32"}},
        "data_loader": {"type": "Loader", "args": {
            "dataset_name": "Ego4D_NLQ" if task == "nlq" else "Ego4D_MQ",
            "data_dir": root, "meta_dir": root, "batch_size": 1,
            "split": "train", "subsample": "video",
            "video_params": {"input_res": RES, "num_frames": 4,
                             "pre_size": PRE}}},
    }


def test_cli_extract_end_to_end(em_root, tmp_path):
    params = random_params(72)
    ckpt = str(tmp_path / "init.pth")
    save_torch_checkpoint(params, jax_config(), ckpt)
    paths = {}
    for task in ("nlq", "mq"):
        paths[task] = tmp_path / f"{task}.json"
        paths[task].write_text(json.dumps(em_config(task, em_root, ckpt)))
    cpu = ["--device", "cpu"]
    cli_extract.main(["-c", str(paths["nlq"]), "--out",
                      str(tmp_path / "video"), *cpu])
    jax_extract_main(["-c", str(paths["nlq"]), "--out",
                      str(tmp_path / "jax_video")])
    for c, n in zip("abc", (4, 9, 3)):
        got = np.load(tmp_path / "video" / f"clip_{c}.npy")
        want = np.load(tmp_path / "jax_video" / f"clip_{c}.npy")
        assert got.shape == (n, 8)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # text mode from the same config, CLS (.npy) and token level (.pt)
    cli_extract.main(["-c", str(paths["nlq"]), "--out",
                      str(tmp_path / "text"), "--subsample", "text", *cpu])
    cli_extract.main(["-c", str(paths["nlq"]), "--out",
                      str(tmp_path / "tokens"), "--subsample", "text",
                      "--token_level", "--save_format", "pt", *cpu])
    cls = np.load(tmp_path / "text" / "clip_b_sentence_0.npy")
    tokens = torch.load(tmp_path / "tokens" / "clip_b_sentence_0.pt",
                        weights_only=True)
    assert cls.shape == (8,) and tokens.shape == (8, 8)
    assert len(list((tmp_path / "tokens").iterdir())) == 4
    # MQ is video only, whatever --subsample says
    cli_extract.main(["-c", str(paths["mq"]), "--out", str(tmp_path / "mq"),
                      "--subsample", "text", *cpu])
    np.testing.assert_array_equal(np.load(tmp_path / "mq" / "clip_b.npy"),
                                  np.load(tmp_path / "video" / "clip_b.npy"))


def test_cli_extract_needs_cuda_by_default(em_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "nlq.json"
    path.write_text(json.dumps(em_config("nlq", em_root, "")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_extract.main(["-c", str(path), "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()
