"""The port's host-side extras vs the JAX package's (CPU).

* ``MetricLogger``: the same calls write the same tags, steps and values
  to ``metrics.jsonl`` (exact); disabled it writes nothing; ``Profiler``
  writes one Chrome trace between its steps;
* ``RetrievalVisualizer``: the HTML pages for a fixed ``sims`` and seed
  equal JAX's byte for byte; ``visualise_path`` / ``batch_path_vis``
  exactly; ``build_visualizer`` from a config section;
* ``io/util``: the cases of ``tests/test_util.py``, against JAX's where
  both compute; ``memory_summary`` without a device;
* the multi-crop helpers on the same frames as JAX's (exact: slices);
* ``cli.convert inspect`` prints JAX's summary of a ``.pth`` line for
  line, and refuses an Orbax directory and the conversion modes;
* ``tools/``: ``charades_meta`` writes JAX's file byte for byte, and
  ``video_prep`` resizes and chunks as JAX's does (ffmpeg where it is on
  PATH, else OpenCV).
"""

import json
import os

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from egovlp_tpu.cli.convert import inspect_checkpoint as jax_inspect
from egovlp_tpu.data import transforms as jax_transforms
from egovlp_tpu.io import logging as jax_logging
from egovlp_tpu.io import util as jax_util
from egovlp_tpu.io import visualizer as jax_visualizer
from egovlp_tpu.models.convert import save_torch_checkpoint
from egovlp_tpu.tools import charades_meta as jax_charades_meta
from egovlp_tpu.tools import video_prep as jax_video_prep
from egovlp_tpu_torch.cli import convert
from egovlp_tpu_torch.data import transforms
from egovlp_tpu_torch.io import logging as port_logging
from egovlp_tpu_torch.io import util
from egovlp_tpu_torch.io import visualizer
from egovlp_tpu_torch.tools import charades_meta, video_prep
from tests.test_readers import make_video
from tests.test_torch_models import jax_config, random_params


# --------------------------------------------------------------------------
# MetricLogger / Profiler
# --------------------------------------------------------------------------

def _drive(mlog):
    for step in range(3):
        mlog.set_step(step, "train")
        mlog.scalar("loss", 1.0 / (step + 1))
    mlog.set_step(1, "val")
    mlog.scalars({"Intra-video": 50.0, "Inter-video": 75.5})
    mlog.scalar("loss", 0.25, step=7)
    mlog.close()


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_metric_logger_matches_jax(tmp_path):
    _drive(port_logging.MetricLogger(str(tmp_path / "port")))
    _drive(jax_logging.MetricLogger(str(tmp_path / "jax")))
    got = _records(tmp_path / "port" / "metrics.jsonl")
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    strip = [{k: r[k] for k in ("step", "tag")} for r in got]
    assert strip == [{k: r[k] for k in ("step", "tag")} for r in want]
    assert [r["tag"] for r in got] == [
        "train/loss", "train/steps_per_sec", "train/loss",
        "train/steps_per_sec", "train/loss", "val/steps_per_sec",
        "val/Intra-video", "val/Inter-video", "val/loss"]
    for g, w in zip(got, want):  # rates are clock readings: not compared
        if not g["tag"].endswith("steps_per_sec"):
            assert g["value"] == w["value"]
        assert g["value"] > 0
    # tensorboardX is importable here: its event file sits beside the JSONL
    assert any(p.name.startswith("events.out.tfevents")
               for p in (tmp_path / "port").iterdir())


def test_metric_logger_disabled_writes_nothing(tmp_path):
    _drive(port_logging.MetricLogger(str(tmp_path / "off"), enabled=False))
    _drive(port_logging.MetricLogger(None))
    assert not (tmp_path / "off").exists()


def test_profiler_writes_one_trace_between_its_steps(tmp_path):
    prof = port_logging.Profiler(str(tmp_path / "prof"), start=1, stop=3)
    x = torch.ones(64, 64)
    for step in range(5):
        prof.step(step)
        x = torch.tanh(x @ x / 64)
    prof.close()
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "trace_steps1-3.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    off = port_logging.Profiler(str(tmp_path / "off"))
    for step in range(3):
        off.step(step)
    off.close()
    assert not (tmp_path / "off").exists()


# --------------------------------------------------------------------------
# visualizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("show_gt", [True, False])
def test_ranking_pages_equal_jax(tmp_path, show_gt):
    sims = np.random.default_rng(4).normal(size=(7, 7))
    queries = [f"query {i} <b>&" for i in range(7)]
    paths = [f"vid{i}.mp4" if i % 2 else f"img{i}.jpg" for i in range(7)]
    pages = {}
    for name, mod in (("port", visualizer), ("jax", jax_visualizer)):
        vis = mod.RetrievalVisualizer(str(tmp_path / name), num_samples=4,
                                      top_k=3, seed=2)
        for epoch in (1, 2):
            vis.visualize_ranking(sims, epoch, queries, paths,
                                  gt_index=np.roll(np.arange(7), 1),
                                  show_gt=show_gt)
        pages[name] = {p.name: p.read_bytes()
                       for p in (tmp_path / name).iterdir()}
    assert sorted(pages["port"]) == ["index.html", "ranking_ep1.html",
                                     "ranking_ep2.html"]
    assert pages["port"] == pages["jax"]
    assert b"&lt;b&gt;&amp;" in pages["port"]["ranking_ep1.html"]


def test_alignment_paths_equal_jax():
    window = np.zeros((3, 6), np.float32)
    window[0, 4:] = np.nan
    target = [(10, 0), (10, 1), (11, 2), (12, 4)]
    preds = {"dtw": [(10, 0), (11, 1), (12, 4)], "min_dist": [(11, 2)]}
    got = visualizer.batch_path_vis(preds, target, window)
    want = jax_visualizer.batch_path_vis(preds, target, window)
    assert got.shape == (2, 3, 3, 6) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        visualizer.visualise_path(preds["dtw"], target, window),
        jax_visualizer.visualise_path(preds["dtw"], target, window))


def test_build_visualizer(tmp_path):
    assert visualizer.build_visualizer({"visualizer": {"type": ""}},
                                       str(tmp_path)) is None
    assert visualizer.build_visualizer({}, str(tmp_path)) is None
    vis = visualizer.build_visualizer(
        {"visualizer": {"type": "RetrievalVis", "args": {
            "num_samples": 3, "top_k": 2, "exp_name": "ignored"}}},
        str(tmp_path / "web"))
    assert (vis.web_dir, vis.num_samples, vis.top_k) == (tmp_path / "web", 3,
                                                         2)


# --------------------------------------------------------------------------
# io/util
# --------------------------------------------------------------------------

def test_replace_nested_dict_item_and_json(tmp_path):
    def tree():
        return {"a": {"split": "train", "b": {"split": "train"}},
                "split": "train"}

    assert (util.replace_nested_dict_item(tree(), "split", "val")
            == jax_util.replace_nested_dict_item(tree(), "split", "val"))
    util.write_json({"b": 1, "a": [2, 3]}, tmp_path / "x.json")
    jax_util.write_json({"b": 1, "a": [2, 3]}, tmp_path / "y.json")
    assert (tmp_path / "x.json").read_text() == \
        (tmp_path / "y.json").read_text()
    assert list(util.read_json(tmp_path / "x.json")) == ["b", "a"]


def test_inf_loop():
    it = util.inf_loop([1, 2, 3])
    assert [next(it) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]

    class FakeLoader:
        def __init__(self):
            self.epochs = []

        def epoch(self, e):
            self.epochs.append(e)
            yield from [e * 10, e * 10 + 1]

    loader = FakeLoader()
    it = util.inf_loop(loader)
    assert [next(it) for _ in range(5)] == [0, 1, 10, 11, 20]
    assert loader.epochs == [0, 1, 2]


def test_np_loader_and_memcache(tmp_path):
    np.save(tmp_path / "f.npy", np.asarray([[3.0, 4.0], [0.0, 0.0]]))
    np.save(tmp_path / "d.npy", {"k": np.asarray([3.0, 4.0])},
            allow_pickle=True)
    for name in ("f.npy", "d.npy"):
        for l2 in (False, True):
            got = util.np_loader(str(tmp_path / name), l2norm=l2)
            want = jax_util.np_loader(str(tmp_path / name), l2norm=l2)
            if isinstance(want, dict):
                assert got.keys() == want.keys()
                got, want = got["k"], want["k"]
            np.testing.assert_array_equal(got, want)
    assert util.memcache(str(tmp_path / "f.npy")) is \
        util.memcache(str(tmp_path / "f.npy"))
    with pytest.raises(ValueError, match="suffix"):
        util.memcache(str(tmp_path / "f.pkl"))


def test_timer_and_memory_summary(capsys):
    t = util.Timer()
    assert t.check() >= 0 and t.check() >= 0
    t.reset()
    assert t.check() < 10
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the summary reads it")
    assert util.memory_summary() == ">>> memory_summary: no CUDA device"
    assert "no CUDA device" in capsys.readouterr().out


# --------------------------------------------------------------------------
# multi-crop helpers
# --------------------------------------------------------------------------

def test_multi_crops_match_jax():
    frames = np.random.default_rng(0).integers(
        0, 255, size=(1, 2, 48, 64, 3)).astype(np.uint8)
    x = torch.from_numpy(frames)

    def unfold(a, lead):
        return np.asarray(a).reshape(*lead, 32, 32, 3)

    five = transforms.center_plus_four_crops(x, 32)
    assert five.shape == (5, 1, 2, 32, 32, 3)
    np.testing.assert_array_equal(five.numpy(), unfold(
        jax_transforms.center_plus_four_crops(frames, 32), (5, 1, 2)))
    three = transforms.center_plus_two_horizontal_crops(x, 32)
    np.testing.assert_array_equal(three.numpy(), unfold(
        jax_transforms.center_plus_two_horizontal_crops(frames, 32),
        (3, 1, 2)))
    for index in (0, 1):
        got = transforms.two_horizontal_crop(x, 32, index)
        np.testing.assert_array_equal(got.numpy(), unfold(
            jax_transforms.two_horizontal_crop(frames, 32, index), (1, 2)))
    np.testing.assert_array_equal(
        transforms.two_horizontal_crop(x, 32, 0).numpy(),
        frames[..., 8:40, :32, :])


# --------------------------------------------------------------------------
# cli.convert inspect
# --------------------------------------------------------------------------

def test_inspect_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "egovlp.pth")
    save_torch_checkpoint(random_params(1), jax_config(), path, epoch=3,
                          monitor_best=41.5)
    got_lines, want_lines = [], []
    got = convert.inspect_checkpoint(path, got_lines.append)
    want = jax_inspect(path, want_lines.append)
    assert got_lines == want_lines and got == want
    assert got_lines[-1].endswith("meta={'epoch': 3, 'monitor_best': 41.5}")
    assert convert.main(["inspect", "-k", path]) == got
    assert capsys.readouterr().out.splitlines() == got_lines
    raw = str(tmp_path / "raw.pth")
    torch.save({"w": torch.zeros(2, 3), "b": torch.ones(3)}, raw)
    lines = []
    convert.inspect_checkpoint(raw, lines.append)
    assert lines[-1] == "-- 2 tensors, 0.00M params"


def test_convert_refuses_what_needs_jax(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="egovlp_tpu.cli.convert"):
        convert.inspect_checkpoint(str(tmp_path / "orbax"))
    for mode in ("import_torch", "export_torch"):
        with pytest.raises(SystemExit, match="egovlp_tpu.cli.convert"):
            convert.main([mode, "-k", "x.pth", "--config", "c.json",
                          "--out", "o"])


# --------------------------------------------------------------------------
# tools
# --------------------------------------------------------------------------

def test_charades_meta_matches_jax(tmp_path):
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        (d / "Charades_v1_classes.txt").write_text(
            "c092 someone is opening a door\nc101 a person sits down\n")
        pd.DataFrame({"id": ["VID01EGO", "VID02EGO"],
                      "actions": ["c092 0.0 1.0;c101 0.5 1.5", ""]}).to_csv(
            d / "CharadesEgo_v1_train_only1st.csv", index=False)
    got = charades_meta.build_metadata(str(tmp_path / "port"), "train")
    want = jax_charades_meta.build_metadata(str(tmp_path / "jax"), "train")
    assert open(got, "rb").read() == open(want, "rb").read()
    df = pd.read_csv(got, sep="\t")
    assert list(df["cls"]) == ["c092", "c101"]
    assert df.iloc[0]["narration"] == "someone is opening a door"


def _size(path):
    cap = cv2.VideoCapture(path)
    out = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
           int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
           int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
    cap.release()
    return out


def test_resize_video_matches_jax(tmp_path):
    src = make_video(tmp_path / "in.mp4", n_frames=10, size=(128, 64))
    got, want = str(tmp_path / "port.mp4"), str(tmp_path / "jax.mp4")
    video_prep.resize_video(src, got, short_side=32)
    jax_video_prep.resize_video(src, want, short_side=32)
    assert _size(got) == _size(want)
    w, h, _ = _size(got)
    assert min(w, h) == 32 and w % 2 == 0 and h % 2 == 0


@pytest.mark.parametrize("chunk_sec", [1, 600])
def test_chunk_video_matches_jax(tmp_path, chunk_sec):
    src = make_video(tmp_path / "long.mp4", n_frames=90, fps=30)  # 3 s
    video_prep.chunk_video(src, str(tmp_path / "port"), chunk_sec=chunk_sec)
    jax_video_prep.chunk_video(src, str(tmp_path / "jax"),
                               chunk_sec=chunk_sec)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == (4 if chunk_sec == 1 else 1)
    for name in names:
        assert (_size(str(tmp_path / "port" / name))
                == _size(str(tmp_path / "jax" / name)))
    if chunk_sec == 1:
        assert _size(str(tmp_path / "port" / "0.mp4"))[2] == 30
