"""The port's WebVid and CC3M datasets and its image and raw-frame readers
vs the JAX package's (CPU, exact: numpy and OpenCV on both sides).

WebVid runs on the synthetic tree of JAX's ``webvid_root`` fixture
(``tests/test_datasets.py``; built again here), CC3M on a tree of JPEGs
and a tab-separated caption file; the same index and item generator give
equal frames and texts.
"""

import os

import cv2
import numpy as np
import pandas as pd
import pytest

from egovlp_tpu.data import readers as jax_readers
from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
from egovlp_tpu.data.datasets import dataset_factory as jax_dataset_factory
from egovlp_tpu_torch.data import readers
from egovlp_tpu_torch.data.datasets import (
    ConceptualCaptionsDataset,
    DatasetConfig,
    WebVidDataset,
    dataset_factory,
)
from tests.test_readers import make_video

PRE = 32


def _cfgs(root, **kw):
    kw.setdefault("pre_size", PRE)
    return JaxDatasetConfig(data_dir=root, **kw), DatasetConfig(data_dir=root,
                                                                **kw)


def assert_items_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w and type(got[k]) is type(w), k


@pytest.fixture(scope="module")
def webvid_root(tmp_path_factory):
    """JAX's ``webvid_root``: two mp4s of 50 and 10 frames and the 2M
    train / val csvs."""
    root = tmp_path_factory.mktemp("webvid")
    (root / "videos").mkdir()
    make_video(root / "videos" / "101.mp4", n_frames=50)
    make_video(root / "videos" / "102.mp4", n_frames=10)
    (root / "metadata").mkdir()
    df = pd.DataFrame({"videoid": [101, 102],
                       "name": ["pouring water", "closing a jar"]})
    for split in ("train", "val"):
        df.to_csv(root / "metadata" / f"results_2M_{split}.csv", index=False)
    return str(root)


@pytest.fixture(scope="module")
def cc3m_root(tmp_path_factory):
    """Three JPEGs (one wide, one tall, one missing) and
    ``cc3m_{train,val}.tsv`` with a caption and a path column."""
    root = tmp_path_factory.mktemp("cc3m")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    for name, (h, w) in (("a.jpg", (40, 60)), ("b.jpg", (70, 36))):
        cv2.imwrite(str(root / "images" / name),
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    df = pd.DataFrame({"caption": ["a dog runs", "a red door", "3"],
                       "path": ["images/a.jpg", "images/b.jpg",
                                "images/missing.jpg"]})
    for split in ("train", "val"):
        df.to_csv(root / f"cc3m_{split}.tsv", sep="\t", index=False)
    return str(root)


@pytest.mark.parametrize("split", ["train", "val"])
def test_webvid_items_match_jax(webvid_root, split):
    jax_cfg, cfg = _cfgs(webvid_root, split=split, num_frames=4)
    got_ds, want_ds = WebVidDataset(cfg), jax_dataset_factory("WebVid")(jax_cfg)
    assert len(got_ds) == len(want_ds) == 2
    for idx in range(3):
        assert_items_equal(got_ds.get(idx, np.random.default_rng(idx)),
                           want_ds.get(idx, np.random.default_rng(idx)))


def test_webvid_sliding_windows_match_jax(webvid_root):
    jax_cfg, cfg = _cfgs(webvid_root, split="test", num_frames=4,
                         sliding_window_stride=3)
    got_ds, want_ds = WebVidDataset(cfg), jax_dataset_factory("WebVid")(jax_cfg)
    assert got_ds._windows == want_ds._windows == [(0, 0), (0, 3), (0, 6),
                                                   (0, 9), (1, 0)]
    for idx in range(len(want_ds)):
        assert_items_equal(got_ds.get(idx, np.random.default_rng(0)),
                           want_ds.get(idx, np.random.default_rng(0)))


def test_webvid_subsample_is_seeded(webvid_root):
    _, cfg = _cfgs(webvid_root, split="train", subsample=0.5)
    a, b = WebVidDataset(cfg), WebVidDataset(cfg)
    assert len(a) == 1 and a.get(0, np.random.default_rng(0))["text"] == \
        b.get(0, np.random.default_rng(0))["text"]


@pytest.mark.parametrize("loading", ["lax", "strict"])
def test_cc3m_items_match_jax(cc3m_root, loading):
    jax_cfg, cfg = _cfgs(cc3m_root, split="train", loading=loading)
    got_ds = ConceptualCaptionsDataset(cfg)
    want_ds = jax_dataset_factory("ConceptualCaptions3M")(jax_cfg)
    assert len(got_ds) == len(want_ds) == 3
    for idx in (0, 1, 4):  # 4 wraps to the second row
        item = got_ds.get(idx, np.random.default_rng(idx))
        assert item["frames"].shape == (1, PRE, PRE, 3)
        assert_items_equal(item, want_ds.get(idx, np.random.default_rng(idx)))
    if loading == "lax":  # the missing image: a black frame, as JAX's
        item = got_ds.get(2, np.random.default_rng(0))
        assert item["text"] == "3" and item["frames"].sum() == 0
        assert_items_equal(item, want_ds.get(2, np.random.default_rng(0)))
    else:
        with pytest.raises(OSError, match="cannot read image"):
            got_ds.get(2, np.random.default_rng(0))


def test_registry_builds_both(webvid_root, cc3m_root):
    _, cfg = _cfgs(webvid_root, split="val")
    assert type(dataset_factory("WebVid")(cfg)) is WebVidDataset
    _, cfg = _cfgs(cc3m_root, split="val")
    assert (type(dataset_factory("ConceptualCaptions3M")(cfg))
            is ConceptualCaptionsDataset)


def test_read_image_matches_jax(cc3m_root):
    for name in ("a.jpg", "b.jpg"):
        path = os.path.join(cc3m_root, "images", name)
        got = readers.read_image(path, PRE)
        assert got.shape == (1, PRE, PRE, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_readers.read_image(path, PRE))
    with pytest.raises(OSError):
        readers.read_image(os.path.join(cc3m_root, "none.jpg"))


@pytest.mark.parametrize("sample", ["uniform", "rand"])
def test_load_frames_from_video_path_matches_jax(webvid_root, tmp_path,
                                                 sample):
    video = os.path.join(webvid_root, "videos", "101.mp4")
    got, got_idx = readers.load_frames_from_video_path(
        video, 4, sample=sample, rng=np.random.default_rng(5),
        save_dir=str(tmp_path / "port"))
    want, want_idx = jax_readers.load_frames_from_video_path(
        video, 4, sample=sample, rng=np.random.default_rng(5),
        save_dir=str(tmp_path / "jax"))
    assert got.shape == (4, 48, 64, 3) and got.dtype == np.float32
    assert got_idx == want_idx
    np.testing.assert_array_equal(got, want)
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax"))
            == sorted(f"{i}.jpg" for i in got_idx))
    with pytest.raises(OSError, match="cannot open"):
        readers.load_frames_from_video_path(str(tmp_path / "no.mp4"), 4)
