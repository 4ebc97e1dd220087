"""The port's EgoClip / EgoMCQ datasets and EgoClip reader vs the JAX
package's (CPU, exact).

On the synthetic ``egoclip_root`` tree (a 3-s mp4, ``egoclip.csv``,
``egomcq.json``) and on a tree whose clips cross a 600-s chunk boundary,
the same index and the same item generator give equal items: frames,
text, noun/verb vectors, scene negatives, MCQ options, ``correct`` and
``type``.  The port reads the csv with the standard library; it is held
to ``pandas.read_csv(sep='\\t', on_bad_lines='skip')`` on a file with a
row of one field too many, a short row, missing values and numeric-looking
captions.
"""

import math

import numpy as np
import pandas as pd
import pytest

from egovlp_tpu.data import readers as jax_readers
from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
from egovlp_tpu.data.datasets import dataset_factory as jax_dataset_factory
from egovlp_tpu.data.pipeline import Loader as JaxLoader
from egovlp_tpu_torch.data import readers
from egovlp_tpu_torch.data.datasets import (
    DatasetConfig,
    EgoClipDataset,
    EgoMCQDataset,
    dataset_factory,
)
from egovlp_tpu_torch.data.datasets.egoclip import read_tsv
from egovlp_tpu_torch.data.pipeline import Loader
from tests.test_datasets import egoclip_root  # noqa: F401
from tests.test_readers import make_video

PRE = 32
COLUMNS = ["video_uid", "video_dur", "narration_source", "narration_ind",
           "narration_time", "clip_start", "clip_end", "clip_text",
           "tag_verb", "tag_noun"]


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
def chunked_root(tmp_path_factory):
    """Two uids; ``vid_b`` has chunks 0 and 1 (20 frames each), and its
    clips straddle the 600-s boundary, so their frames come from both
    files; several narrations share a 60-s segment."""
    root = tmp_path_factory.mktemp("chunked")
    for uid, chunks in (("vid_a", (0,)), ("vid_b", (0, 1))):
        (root / uid).mkdir()
        for c in chunks:
            make_video(root / uid / f"{c}.mp4", n_frames=20)
    lines = ["\t".join(COLUMNS)]
    for i in range(8):
        uid = "vid_b" if i % 2 else "vid_a"
        t0 = 599.2 + 0.05 * i if uid == "vid_b" else 0.1 * i
        lines.append("\t".join(str(v) for v in (
            uid, 1200.0, "narration_pass_1", i, t0 + 0.3, t0, t0 + 0.9,
            f"#C C moves {i}", f"[{i % 3}]", f"[{i % 2}, {i % 5}]")))
    (root / "egoclip.csv").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("neg_param", [1, None])
def test_egoclip_items_equal_jax(egoclip_root, split, neg_param):  # noqa: F811
    want_ds = jax_dataset_factory("EgoClip")(
        _cfgs(egoclip_root, split=split, neg_param=neg_param)[0])
    got_ds = dataset_factory("EgoClip")(
        _cfgs(egoclip_root, split=split, neg_param=neg_param)[1])
    assert len(got_ds) == len(want_ds) == 6
    for idx in range(8):  # past the end wraps
        rng = JaxLoader.item_rng(3, 1, idx)
        assert_items_equal(got_ds.get(idx, Loader.item_rng(3, 1, idx)),
                           want_ds.get(idx, rng))


@pytest.mark.parametrize("neg_param", [60, 1])
def test_egoclip_chunk_crossing_items_equal_jax(chunked_root, neg_param):
    jax_cfg, cfg = _cfgs(chunked_root, split="train", neg_param=neg_param)
    want_ds = jax_dataset_factory("EgoClip")(jax_cfg)
    got_ds = dataset_factory("EgoClip")(cfg)
    for idx in range(len(want_ds)):
        assert_items_equal(got_ds.get(idx, np.random.default_rng(idx)),
                           want_ds.get(idx, np.random.default_rng(idx)))


@pytest.mark.parametrize("split", ["train", "val"])
def test_egomcq_items_equal_jax(egoclip_root, split):  # noqa: F811
    want_ds = jax_dataset_factory("EgoMCQ")(_cfgs(egoclip_root,
                                                  split=split)[0])
    got_ds = dataset_factory("EgoMCQ")(_cfgs(egoclip_root, split=split)[1])
    assert len(got_ds) == len(want_ds) == 3
    for idx in range(len(want_ds)):
        got = got_ds.get(idx, np.random.default_rng(idx))
        assert_items_equal(got, want_ds.get(idx, np.random.default_rng(idx)))
        assert got["frames_options"].shape == (5, 4, PRE, PRE, 3)


@pytest.mark.parametrize("backend", ["auto", "cv2"])
@pytest.mark.parametrize("sample", ["rand", "uniform"])
def test_read_frames_egoclip_across_chunks_equals_jax(chunked_root, backend,
                                                      sample):
    base = f"{chunked_root}/vid_b"
    # 599.5 s to 600.4 s: global frames 17985..18012 around the bound 18000;
    # locals past it are index % 18000, before it clamp to the 20 frames
    args = (f"{base}/0.mp4", f"{base}/1.mp4", 8, sample, 599.5, 600.4, 600.0)
    got, got_idx = readers.read_frames_egoclip(
        *args, pre_size=PRE, rng=np.random.default_rng(5), backend=backend)
    want, want_idx = jax_readers.read_frames_egoclip(
        *args, pre_size=PRE, rng=np.random.default_rng(5), backend=backend)
    assert got_idx == want_idx
    assert min(want_idx) <= 18000 < max(want_idx)  # both chunks read
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, PRE, PRE, 3)


def test_video_len_and_handle_cache(chunked_root):
    path = f"{chunked_root}/vid_a/0.mp4"
    assert readers.get_video_len(path) == jax_readers.get_video_len(path) == 20
    assert readers.get_video_len(f"{chunked_root}/missing.mp4") == 0
    v = readers.acquire_video(path)
    readers.release_video(path, "auto", v)
    assert readers.acquire_video(path) is v  # this thread's cached handle
    readers.release_video(path, "auto", v, ok=False)  # closed, not cached
    assert readers.acquire_video(path) is not v


def _same_value(a, b):
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    return a == b and type(a) is type(b)


def test_read_tsv_matches_pandas(tmp_path):
    rows = [COLUMNS,
            ["vid_a", "3.0", "p1", "0", "0.2", "0.1", "0.8", "5", "[0]", "[1]"],
            ["vid_a", "3.0", "p1", "1", "", "0.4", "1.1", "07", "[1]", "[2]"],
            # one field too many: dropped
            ["vid_b", "3.0", "p1", "2", "1.0", "0.7", "1.4", "9", "[2]", "[3]",
             "extra"],
            ["vid_b", "NA", "p1", "3", "1.4", "1.0", "1.7", "1.50", "[0]",
             "[0, 3]"],
            # a short row: padded with missing values
            ["vid_c", "2.0", "p2", "4", "1.8", "1.3", "2.0", "12"]]
    path = tmp_path / "egoclip.csv"
    path.write_text("\n".join("\t".join(r) for r in rows) + "\n\n")
    got = read_tsv(str(path))
    want = pd.read_csv(path, sep="\t", on_bad_lines="skip")
    assert list(got) == list(want.columns)
    for col in want.columns:
        w = want[col]
        if w.dtype.kind in "if":
            assert got[col].dtype == w.dtype, col
            np.testing.assert_array_equal(got[col], w.to_numpy(), err_msg=col)
        else:
            assert all(_same_value(a, b) for a, b in zip(got[col], w.tolist())
                       ), (col, got[col], w.tolist())
    assert len(got["clip_text"]) == 4
    assert [str(v) for v in got["clip_text"]] == ["5.0", "7.0", "1.5", "12.0"]

    # the dataset reads that file as the JAX package does: captions, tags
    # and scene groups (a row without narration_time has no group on the
    # JAX side, whose get() raises KeyError there; the port's groups it
    # under "{uid}_nan")
    jax_cfg, cfg = _cfgs(str(tmp_path), neg_param=1, split="val")
    want_ds = jax_dataset_factory("EgoClip")(jax_cfg)
    got_ds = EgoClipDataset(cfg)
    for idx in range(3):
        w, g = want_ds.metadata.iloc[idx], got_ds._row(idx)
        assert got_ds._caption(g)[0] == want_ds._caption(w)[0]
        for a, b in zip(got_ds._caption(g)[1:], want_ds._caption(w)[1:]):
            np.testing.assert_array_equal(a, b)
        if math.isnan(w["narration_time"]):
            continue
        group = want_ds._segment_groups[w["segment_id"]]
        np.testing.assert_array_equal(
            got_ds._segment_groups[got_ds._segment_ids[idx]], group)
    # the short row's missing tags: both raise
    for ds, row in ((want_ds, want_ds.metadata.iloc[3]), (got_ds,
                                                          got_ds._row(3))):
        with pytest.raises(ValueError):
            ds._caption(row)


def test_dataset_factory_dispatch_matches_jax(egoclip_root):  # noqa: F811
    for split, cls in (("train", EgoClipDataset), ("val", EgoMCQDataset),
                       ("test", EgoMCQDataset)):
        jax_cfg, cfg = _cfgs(egoclip_root, split=split)
        got = dataset_factory("EgoClip_EgoMCQ")(cfg)
        want = jax_dataset_factory("EgoClip_EgoMCQ")(jax_cfg)
        assert type(got) is cls and type(want).__name__ == cls.__name__
    assert dataset_factory("EgoClip") is EgoClipDataset
    assert dataset_factory("EgoMCQ") is EgoMCQDataset
    # ported: see tests/test_torch_ft_data.py, test_torch_oscc_pnr.py,
    # test_torch_features.py and test_torch_legacy_data.py (WebVid, CC3M)
    for name in ("MultiInstanceRetrieval", "EpicKitchens_MIR", "CharadesEgo",
                 "Ego4D_OSCC", "Ego4D_PNR", "Ego4D_NLQ", "Ego4D_MQ",
                 "WebVid", "ConceptualCaptions3M"):
        assert dataset_factory(name).__name__ == \
            jax_dataset_factory(name).__name__
    with pytest.raises(NotImplementedError, match="unknown"):
        dataset_factory("NoSuchDataset")


def test_lax_loading_gives_black_frames(egoclip_root, tmp_path):  # noqa: F811
    (tmp_path / "egoclip.csv").write_text(
        (__import__("pathlib").Path(egoclip_root) / "egoclip.csv").read_text())
    for loading in ("lax", "strict"):
        cfg = DatasetConfig(data_dir=str(tmp_path), split="val",
                            pre_size=PRE, loading=loading)
        ds = EgoClipDataset(cfg)  # no videos under tmp_path
        if loading == "strict":
            with pytest.raises(ValueError, match="strict"):
                ds.get(0, np.random.default_rng(0))
        else:
            frames = ds.get(0, np.random.default_rng(0))["frames"]
            assert frames.shape == (4, PRE, PRE, 3) and not frames.any()


def test_csv_numbers_convert_as_pandas_converts_them(tmp_path):
    """Seeded decimal strings of every length, as a csv writer emits times:
    the port's converter gives pandas' doubles, where Python's ``float``
    (correctly rounded) differs on some."""
    rng = np.random.default_rng(0)
    x = rng.random(4000) * 10.0 ** rng.integers(-4, 6, 4000)
    strs = ([repr(float(v)) for v in x]
            + [f"{v:.{d}f}" for v, d in zip(x, rng.integers(1, 20, 4000))]
            + [repr(0.1 + 0.3 * i) for i in range(50)]
            + ["0.9999999999999999", "-0.0", "1e-320", "7E+2", ".5", "5.",
               "123456789012345678901234.5", "inf", "-Infinity"])
    path = tmp_path / "numbers.csv"
    path.write_text("x\n" + "\n".join(strs) + "\n")
    want = pd.read_csv(path, sep="\t")["x"].to_numpy()
    got = read_tsv(str(path))["x"]
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert any(float(s) != w for s, w in zip(strs, want))
