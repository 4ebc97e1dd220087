"""The port's EPIC-Kitchens MIR and CharadesEgo data path vs the JAX
package's (CPU, exact).

On ``tests/test_datasets.py``'s ``epic_root`` and ``charades_root`` trees,
and on an EPIC tree with a graded relevancy matrix (several positives a
clip, so the caption draw ``rng.choice`` matters) and quoted narrations,
the same index and the same item generator give equal items, train and
test: frames, text, path, ``relation``, ``item_v`` / ``item_t`` and the
Charades ``target``.  The readers, collated Loader batches, the comma
``read_table`` against ``pandas.read_csv`` and ``load_epic_annotations``
against the JAX package's pandas reader are held the same way.
"""

import math
import pickle

import cv2
import numpy as np
import pandas as pd
import pytest

from egovlp_tpu.data import readers as jax_readers
from egovlp_tpu.data.datasets import dataset_factory as jax_dataset_factory
from egovlp_tpu.data.pipeline import Loader as JaxLoader
from egovlp_tpu.metrics.mir import (
    load_epic_annotations as jax_load_epic_annotations,
)
from egovlp_tpu_torch.data import readers
from egovlp_tpu_torch.data.datasets import (
    CharadesEgoDataset,
    EpicMIRDataset,
    dataset_factory,
)
from egovlp_tpu_torch.data.datasets.charades import parse_charades_actions
from egovlp_tpu_torch.data.datasets.table import read_table
from egovlp_tpu_torch.data.pipeline import Loader
from egovlp_tpu_torch.metrics.mir import load_epic_annotations
from tests.test_datasets import charades_root, epic_root  # noqa: F401
from tests.test_torch_datasets import PRE, _cfgs, assert_items_equal

N_GRADED = 6


@pytest.fixture(scope="module")
def graded_root(tmp_path_factory):
    """Two frame directories, 6 clips, narrations with commas and quotes,
    a sentence csv of 8 sentences, and seeded graded relevancy matrices:
    in train every clip but the first has 2-4 sentences past 0.1."""
    root = tmp_path_factory.mktemp("epic_graded")
    for vid in ("P02_1", "P03_7"):
        d = root / vid.split("_")[0] / "rgb_frames" / vid
        d.mkdir(parents=True)
        for i in range(1, 60):
            img = np.full((36, 64, 3), (i * 4) % 256, np.uint8)
            img[:, : i % 64] = 200
            cv2.imwrite(str(d / f"frame_{i:010d}.jpg"), img)
    rng = np.random.default_rng(11)
    vids = ["P02/rgb_frames/P02_1", "P03/rgb_frames/P03_7"]
    clips = pd.DataFrame({
        "narration_id": [f"P0{2 + i % 2}_{i}" for i in range(N_GRADED)],
        "participant_id": ["P02", "P03"] * (N_GRADED // 2),
        "video_id": [vids[i % 2] for i in range(N_GRADED)],
        "narration_timestamp": ["00:00:01.00"] * N_GRADED,
        "start_timestamp": ["00:00:01.00"] * N_GRADED,
        "stop_timestamp": ["00:00:02.50"] * N_GRADED,
        "start_frame": [1 + 7 * i for i in range(N_GRADED)],
        "stop_frame": [17 + 7 * i for i in range(N_GRADED)],
        "narration": ['put "pan", then lid' if i == 2 else f"wash cup {i}"
                      for i in range(N_GRADED)],
        "verb_class": [i % 3 for i in range(N_GRADED)],
    })
    # the sentences of the test split are named by a clip with them (as
    # in EPIC: 6 clips' own and 2 more of clips 0 and 3)
    sent = pd.DataFrame({
        "narration_id": [clips["narration_id"][i % 6] if i < 6 else
                         clips["narration_id"][3 * (i - 6)]
                         for i in range(8)],
        "narration": [f"sentence, {i}" for i in range(8)],
    })
    for split in ("train", "test"):
        clips.to_csv(root / f"EPIC_100_retrieval_{split}.csv", index=False)
        sent.to_csv(root / f"EPIC_100_retrieval_{split}_sentence.csv",
                    index=False)
    # train: 2-4 graded positives a clip, none for clip 0 (its own
    # narration); test: every clip and every sentence with an exact 1
    rel = {"train": np.zeros((N_GRADED, 8)), "test": np.zeros((N_GRADED, 8))}
    for i in range(N_GRADED):
        cols = rng.choice(8, size=2 + i % 3, replace=False)
        for split in rel:
            rel[split][i, cols] = rng.choice([0.34, 0.5, 0.67, 1.0],
                                             size=len(cols))
    rel["train"][0, :] = 0.05
    rel["test"][np.arange(8) % 6, np.arange(8)] = 1.0
    (root / "relevancy").mkdir()
    for split in ("train", "test"):
        with open(root / "relevancy" /
                  f"caption_relevancy_EPIC_100_retrieval_{split}.pkl",
                  "wb") as f:
            pickle.dump(rel[split], f)
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("tree", ["epic_root", "graded_root"])
def test_epic_items_equal_jax(split, tree, request):
    root = request.getfixturevalue(tree)
    jax_cfg, cfg = _cfgs(root, split=split, num_frames=4)
    want_ds = jax_dataset_factory("MultiInstanceRetrieval")(jax_cfg)
    got_ds = dataset_factory("MultiInstanceRetrieval")(cfg)
    assert isinstance(got_ds, EpicMIRDataset)
    assert len(got_ds) == len(want_ds)
    drawn = set()
    for idx in range(len(want_ds) + 2):  # past the end wraps
        got = got_ds.get(idx, Loader.item_rng(5, 2, idx))
        assert_items_equal(got, want_ds.get(idx, JaxLoader.item_rng(5, 2,
                                                                    idx)))
        assert got["frames"].shape == (4, PRE, PRE, 3)
        drawn.add(int(got["item_t"]))
    if split == "train" and tree == "graded_root":
        assert len(drawn) > 3  # graded positives: several captions drawn


@pytest.mark.parametrize("split", ["train", "test"])
def test_charades_items_equal_jax(charades_root, split):  # noqa: F811
    jax_cfg, cfg = _cfgs(charades_root, split=split, num_frames=4)
    want_ds = jax_dataset_factory("CharadesEgo")(jax_cfg)
    got_ds = dataset_factory("CharadesEgo")(cfg)
    assert isinstance(got_ds, CharadesEgoDataset)
    assert len(got_ds) == len(want_ds)
    for idx in range(len(want_ds) + 1):
        got = got_ds.get(idx, Loader.item_rng(1, 1, idx))
        assert_items_equal(got, want_ds.get(idx, JaxLoader.item_rng(1, 1,
                                                                    idx)))
    if split == "test":
        assert got["target"].shape == (157,)
        assert np.flatnonzero(got["target"]).tolist() == [92, 101]


def test_charades_subsample_is_seeded(charades_root):  # noqa: F811
    """``subsample < 1`` draws the same rows every time (the JAX package
    draws them unseeded)."""
    cfg = _cfgs(charades_root, split="train", subsample=0.5)[1]
    rows = [CharadesEgoDataset(cfg)._rows.tolist() for _ in range(2)]
    assert rows[0] == rows[1] and len(rows[0]) == 1


def test_parse_charades_actions(tmp_path):
    path = tmp_path / "a.csv"
    pd.DataFrame({"id": ["A", "B"], "actions": ["c001 0.5 1.5;c156 2 3",
                                                ""]}).to_csv(path, index=False)
    assert parse_charades_actions(str(path)) == {
        "A": [{"class": "c001", "start": 0.5, "end": 1.5},
              {"class": "c156", "start": 2.0, "end": 3.0}],
        "B": []}


@pytest.mark.parametrize("sample", ["rand", "uniform"])
def test_read_frames_epic_equals_jax(graded_root, sample):
    d = f"{graded_root}/P03/rgb_frames/P03_7"
    # 70 is past the last frame (59): those frames stay black
    for start, stop in ((3, 40), (50, 70)):
        got = readers.read_frames_epic(d, start, stop, 8, sample,
                                       pre_size=PRE,
                                       rng=np.random.default_rng(4))
        want = jax_readers.read_frames_epic(d, start, stop, 8, sample,
                                            pre_size=PRE,
                                            rng=np.random.default_rng(4))
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])
    assert not got[0][-1].any()


@pytest.mark.parametrize("bounds", [(None, None), (0.3, 1.2)])
def test_read_frames_charades_equals_jax(charades_root, bounds):  # noqa: F811
    path = f"{charades_root}/VID01EGO.mp4"
    got = readers.read_frames_charades(path, 6, "rand", *bounds,
                                       pre_size=PRE,
                                       rng=np.random.default_rng(2))
    want = jax_readers.read_frames_charades(path, 6, "rand", *bounds,
                                            pre_size=PRE,
                                            rng=np.random.default_rng(2))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("split", ["train", "test"])
def test_epic_loader_batches_equal_jax(graded_root, split):
    """Collated batches over 2 epochs x 2 shards, test split padded
    (``drop_last`` off): the numeric columns and the strings (the JAX
    Loader folds the frames' channels into the width, a TPU layout)."""
    from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
    from egovlp_tpu_torch.data.datasets import DatasetConfig

    kw = dict(data_dir=graded_root, split=split, num_frames=2, pre_size=PRE)
    for shard in range(2):
        opts = dict(batch_size=2, num_workers=2, seed=3, shard=shard,
                    num_shards=2, drop_last=split == "train")
        got_l = Loader(EpicMIRDataset(DatasetConfig(**kw)), **opts)
        want_l = JaxLoader(jax_dataset_factory("EpicKitchens_MIR")(
            JaxDatasetConfig(**kw)), **opts)
        try:
            for epoch in range(2):
                got = list(got_l.epoch(epoch))
                want = list(want_l.epoch(epoch))
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    for k in ("frames", "relation", "item_v", "item_t",
                              "_index"):
                        wk = np.asarray(w[k]).reshape(g[k].shape)
                        assert g[k].dtype == wk.dtype, k
                        np.testing.assert_array_equal(g[k], wk)
                    assert g["text"] == w["text"] and g["path"] == w["path"]
        finally:
            got_l.close()
            want_l.close()


def _same(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    return a == b


def test_read_table_comma_matches_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text(
        'id,n,x,text\n'
        'a,1,0.1,"quoted, comma"\n'
        'b,2,,"say ""hi"""\n'
        '\n'
        'c,3,2.5e-3,plain\n')
    got = read_table(str(path))
    want = pd.read_csv(path)
    assert list(got) == list(want.columns)
    for k in want.columns:
        w = want[k].tolist()
        g = got[k].tolist() if isinstance(got[k], np.ndarray) else got[k]
        if want[k].dtype.kind in "if":
            assert got[k].dtype == want[k].dtype, k
        assert len(g) == len(w) and all(map(_same, g, w)), k


@pytest.mark.parametrize("tree", ["epic_root", "graded_root"])
def test_load_epic_annotations_matches_jax(tree, request):
    root = request.getfixturevalue(tree)
    got = load_epic_annotations(root)
    want = jax_load_epic_annotations(root)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tolist() == w.tolist()
        assert [type(x) for x in g] == [type(x) for x in w]
    np.testing.assert_array_equal(got[2], want[2])


def test_load_epic_annotations_numeric_ids(tmp_path):
    """Numeric first columns come out as pandas' ``.values[:, 0]``: an
    object array of Python ints beside a string column, the frame's common
    dtype when every column is numeric."""
    pd.DataFrame({"id": [3, 1], "t": ["x", "y"]}).to_csv(
        tmp_path / "EPIC_100_retrieval_test.csv", index=False)
    pd.DataFrame({"id": [5, 6], "n": [0.5, 1.0]}).to_csv(
        tmp_path / "EPIC_100_retrieval_test_sentence.csv", index=False)
    (tmp_path / "relevancy").mkdir()
    with open(tmp_path / "relevancy" /
              "caption_relevancy_EPIC_100_retrieval_test.pkl", "wb") as f:
        pickle.dump(np.eye(2), f)
    got = load_epic_annotations(str(tmp_path))
    want = jax_load_epic_annotations(str(tmp_path))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.tolist() == w.tolist()
        assert [type(x) for x in g] == [type(x) for x in w]
