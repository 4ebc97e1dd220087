"""The port's host input pipeline vs the JAX package's (CPU, exact).

``shard_indices`` over a grid of sizes, shards, shuffle and ``drop_last``;
``Loader`` batches on the synthetic EgoClip tree over 2 epochs and 2
shards, with ``max_samples_per_epoch`` cycling and ``validation_split``
(the port keeps frames ``[B, T, pre, pre, 3]``; the JAX Loader folds them
to ``[B, T, pre, pre * 3]``); thread- and process-decoded batches; the lax
straggler policy; ``MultiLoader``; and the eval gather's pad dedupe by
``_index``.
"""

import numpy as np
import pytest

from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
from egovlp_tpu.core.dist_eval import gather_eval as jax_gather_eval
from egovlp_tpu.data.datasets import EgoClipDataset as JaxEgoClipDataset
from egovlp_tpu.data.datasets import EgoMCQDataset as JaxEgoMCQDataset
from egovlp_tpu.data.pipeline import Loader as JaxLoader
from egovlp_tpu.data.pipeline import MultiLoader as JaxMultiLoader
from egovlp_tpu.data.pipeline import collate as jax_collate
from egovlp_tpu.data.pipeline import shard_indices as jax_shard_indices
from egovlp_tpu.data.text import WordPieceTokenizer as JaxTokenizer
from egovlp_tpu_torch.core import dist_eval
from egovlp_tpu_torch.data.datasets import (
    DatasetConfig,
    EgoClipDataset,
    EgoMCQDataset,
)
from egovlp_tpu_torch.data.pipeline import (
    Loader,
    MultiLoader,
    collate,
    shard_indices,
)
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from tests.test_datasets import egoclip_root  # noqa: F401

PRE = 32
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "#", "c", "does", "thing",
         "query", "opt"] + [str(i) for i in range(10)]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "vocab.txt"
    p.write_text("\n".join(VOCAB))
    return WordPieceTokenizer(str(p), 8), JaxTokenizer(str(p), 8)


def assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            if k.startswith("frames"):
                # the JAX Loader folds [..., W, 3] into [..., W * 3]
                assert g.shape[-1] == 3
                w = w.reshape(g.shape)
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_shard_indices_match_jax(shuffle, drop_last):
    for n in (1, 5, 6, 17):
        for num_shards in (1, 2, 3, 4):
            for shard in range(num_shards):
                for epoch in (0, 3):
                    kw = dict(epoch=epoch, shuffle=shuffle, seed=11,
                              shard=shard, num_shards=num_shards,
                              drop_last=drop_last)
                    np.testing.assert_array_equal(
                        shard_indices(n, **kw), jax_shard_indices(n, **kw))


def _loaders(root, tokenizers, **kw):
    port_tok, jax_tok = tokenizers
    cfg = dict(data_dir=root, pre_size=PRE, neg_param=1, split="train")
    port = Loader(EgoClipDataset(DatasetConfig(**cfg)), tokenizer=port_tok,
                  num_workers=2, **kw)
    jax = JaxLoader(JaxEgoClipDataset(JaxDatasetConfig(**cfg)),
                    tokenizer=jax_tok, num_workers=2, **kw)
    return port, jax


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, max_samples_per_epoch=10),  # 6 items cycled to 5
    dict(batch_size=2, drop_last=False, shuffle=False),
    dict(batch_size=1, validation_split=2),
], ids=["cycle", "keep_last", "validation_split"])
def test_loader_batches_match_jax(egoclip_root, tokenizers, kw):  # noqa: F811
    for shard in range(2):
        port, jax = _loaders(egoclip_root, tokenizers, shard=shard,
                             num_shards=2, seed=4, **kw)
        pairs = [(port, jax)]
        if "validation_split" in kw:
            pairs.append((port.split_validation(), jax.split_validation()))
        try:
            for p, j in pairs:
                assert len(p) == len(j) > 0
                for epoch in (1, 2):
                    got, want = list(p.epoch(epoch)), list(j.epoch(epoch))
                    assert len(got) == len(want) == len(p)
                    for g, w in zip(got, want):
                        assert_batches_equal(g, w)
                        assert g["frames"].shape[1:] == (4, PRE, PRE, 3)
        finally:
            for p, j in pairs:
                p.close()
                j.close()


def test_loader_threads_and_processes_give_the_same_batches(
        egoclip_root, tokenizers):  # noqa: F811
    port_tok, _ = tokenizers
    ds = EgoClipDataset(DatasetConfig(data_dir=egoclip_root, pre_size=PRE,
                                      neg_param=1, split="train"))
    threads = Loader(ds, batch_size=2, tokenizer=port_tok, num_workers=2)
    procs = Loader(ds, batch_size=2, tokenizer=port_tok, num_procs=2)
    try:
        for epoch in (0, 1):
            got, want = list(procs.epoch(epoch)), list(threads.epoch(epoch))
            assert len(got) == len(want) == 3
            for g, w in zip(got, want):
                assert_batches_equal(g, w)
    finally:
        threads.close()
        procs.close()


class _FlakyDataset:
    """Item 2 raises; the others are their index."""

    def __init__(self, loading):
        self.cfg = DatasetConfig(split="val", loading=loading)

    def __len__(self):
        return 6

    def get(self, idx, rng):
        if idx == 2:
            raise IOError("corrupt video")
        return {"x": np.full(3, idx, np.int64), "text": f"item {idx}"}


def test_lax_policy_substitutes_a_neighbour():
    lax = Loader(_FlakyDataset("lax"), batch_size=3, num_workers=2,
                 shuffle=False, drop_last=False)
    jax = JaxLoader(_FlakyDataset("lax"), batch_size=3, num_workers=2,
                    shuffle=False, drop_last=False)
    strict = Loader(_FlakyDataset("strict"), batch_size=3, num_workers=2,
                    shuffle=False, drop_last=False)
    try:
        got, want = list(lax.epoch(0)), list(jax.epoch(0))
        assert [b["x"][:, 0].tolist() for b in got] == [[0, 1, 0], [3, 4, 5]]
        for g, w in zip(got, want):
            assert_batches_equal(g, w)
        np.testing.assert_array_equal(got[0]["_index"], [0, 1, 2])
        with pytest.raises(IOError, match="corrupt"):
            list(strict.epoch(0))
    finally:
        for loader in (lax, jax, strict):
            loader.close()


def test_multiloader_zips_its_loaders(egoclip_root, tokenizers):  # noqa: F811
    port_tok, jax_tok = tokenizers
    cfg = dict(data_dir=egoclip_root, pre_size=PRE, split="val")
    port = MultiLoader([
        Loader(EgoClipDataset(DatasetConfig(**cfg)), 2, tokenizer=port_tok,
               num_workers=1),
        Loader(EgoMCQDataset(DatasetConfig(**cfg)), 1, tokenizer=port_tok,
               num_workers=1)])
    jax = JaxMultiLoader([
        JaxLoader(JaxEgoClipDataset(JaxDatasetConfig(**cfg)), 2,
                  tokenizer=jax_tok, num_workers=1),
        JaxLoader(JaxEgoMCQDataset(JaxDatasetConfig(**cfg)), 1,
                  tokenizer=jax_tok, num_workers=1)])
    try:
        assert len(port) == len(jax) == 3 and port.batch_size == 3
        got, want = list(port.epoch(0)), list(jax.epoch(0))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert len(g) == 2
            for gb, wb in zip(g, w):
                assert_batches_equal(gb, wb)
        assert got[0][1]["frames_options"].shape == (1, 5, 4, PRE, PRE, 3)
        assert got[0][1]["text_options_ids"].shape == (1, 5, 8)
    finally:
        for loader in port.loaders + jax.loaders:
            loader.close()


def test_collate_keeps_frames_and_tokenizes(tokenizers):
    port_tok, jax_tok = tokenizers
    rng = np.random.default_rng(0)
    items = [{"frames": rng.integers(0, 256, (4, 5, 5, 3), dtype=np.uint8),
              "text": f"c does thing {i}", "video_uid": f"v{i}",
              "type": i, "meta": {"i": i},
              "text_options": ["opt 1", "query"]} for i in range(3)]
    got, want = collate(items, port_tok), jax_collate(items, jax_tok)
    assert_batches_equal(got, want)
    assert got["frames"].shape == (3, 4, 5, 5, 3)
    assert "video_uid_ids" not in got and got["video_uid"] == ["v0", "v1",
                                                               "v2"]


def test_gather_eval_dedupes_shard_pads_like_jax(monkeypatch):
    # rows of two shards of 5 items, the last one padded with item 0
    index = np.array([0, 2, 4, 1, 3, 0])
    arrays = {"preds": np.arange(12.0).reshape(6, 2),
              "types": np.array([1, 2, 1, 2, 1, 1])}
    got, objs = dist_eval.gather_eval(arrays, index)
    want, _ = jax_gather_eval(arrays, index)
    assert got.keys() == want.keys() and objs is None
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["preds"][:, 0], [0, 6, 2, 8, 4])
    assert dist_eval.gather_eval(arrays)[0]["types"].tolist() == arrays[
        "types"].tolist()
    # a world of 2 reaches the collective: here a stand-in all-gather that
    # gives every rank's part as this rank's, one length exchange and one
    # gather a column
    calls = []

    def all_gather(x):
        calls.append(x.shape)
        return [x, x]

    monkeypatch.setattr(dist_eval, "process_shard", lambda: (0, 2))
    monkeypatch.setattr(dist_eval, "_all_gather", all_gather)
    got, _ = dist_eval.gather_eval(arrays, index)
    assert calls == [(1,), (6, 2), (6,), (6,)]
    for k in want:  # the second copy is dropped as pads
        np.testing.assert_array_equal(got[k], want[k])
