"""The port's own data helpers vs the JAX package's, and the import guard.

The port keeps copies of the tokenizer, the frame samplers and the reader
front end so that it imports nothing of the JAX package; these tests hold
the copies to the originals (exact: the same integer outputs), and a
fresh interpreter shows that importing every module of the port loads
neither jax nor any ``egovlp_tpu.`` module.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from egovlp_tpu.data import samplers as jax_samplers
from egovlp_tpu.data.readers import _pad_to as jax_pad_to
from egovlp_tpu.data.text import WordPieceTokenizer as JaxWordPieceTokenizer
import egovlp_tpu_torch
from egovlp_tpu_torch.data import samplers
from egovlp_tpu_torch.data.readers import _pad_to
from egovlp_tpu_torch.data.text import WordPieceTokenizer

ROOT = Path(__file__).resolve().parents[1]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "cuts", "an",
         "onion", "cafe", "the", "door", "##s", "##ing", "open", ",", ".",
         "!", "c", "#", "'", "$", "x", "##x"]
TEXTS = ["a person cuts an onion", "#C C opens the door.", "Café, cafés!",
         "naïve façade", "  the   door  ", "", "cutting onions",
         "x" * 120, "a " * 40, "$5 'quoted' the,door", "ÀÉÎ cafe\tdoor\n",
         "unknownword opens"]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB))
    return str(p)


@pytest.mark.parametrize("backend", ["python", "auto"])
@pytest.mark.parametrize("max_length", [6, 30])
def test_tokenizer_matches_jax(vocab, backend, max_length):
    got = WordPieceTokenizer(vocab, max_length=max_length, backend=backend)
    want = JaxWordPieceTokenizer(vocab, max_length=max_length,
                                 backend=backend)
    for texts in (TEXTS, TEXTS[0]):
        (gi, gm), (wi, wm) = got(texts), want(texts)
        assert gi.dtype == np.int32 and gm.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


@pytest.mark.parametrize("sample", ["rand", "uniform"])
@pytest.mark.parametrize("fix_start", [None, 1])
def test_sample_frames_matches_jax(sample, fix_start):
    for num_frames, vlen in ((4, 300), (4, 3), (16, 40), (8, 8), (4, 1)):
        got = samplers.sample_frames(num_frames, vlen, sample, fix_start,
                                     np.random.default_rng(0))
        want = jax_samplers.sample_frames(num_frames, vlen, sample, fix_start,
                                          np.random.default_rng(0))
        assert got == want
    for num_frames, start, end in ((4, 10, 200), (4, 0, 2), (16, 5, 40)):
        got = samplers.sample_frames_start_end(
            num_frames, start, end, sample, fix_start,
            np.random.default_rng(1))
        want = jax_samplers.sample_frames_start_end(
            num_frames, start, end, sample, fix_start,
            np.random.default_rng(1))
        assert got == want


@pytest.mark.parametrize("valid", [0, 2, 4])
def test_pad_to_matches_jax(valid):
    frames = np.random.default_rng(valid).integers(
        0, 256, (4, 5, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(_pad_to(frames, valid, 4),
                                  jax_pad_to(frames, valid, 4))


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        egovlp_tpu_torch.__path__, "egovlp_tpu_torch."))
    assert "egovlp_tpu_torch.train.trainer" in modules
    # the data subpackage, the fine-tune modules and the entry points are
    # walked too
    assert {"egovlp_tpu_torch.data.datasets",
            "egovlp_tpu_torch.data.datasets.egoclip",
            "egovlp_tpu_torch.data.datasets.epic",
            "egovlp_tpu_torch.data.datasets.charades",
            "egovlp_tpu_torch.data.datasets.table",
            "egovlp_tpu_torch.objectives.ranking",
            "egovlp_tpu_torch.metrics.ndcg", "egovlp_tpu_torch.metrics.map",
            "egovlp_tpu_torch.metrics.mir",
            "egovlp_tpu_torch.metrics.charades",
            "egovlp_tpu_torch.evals.epic_mir",
            "egovlp_tpu_torch.evals.charades",
            "egovlp_tpu_torch.data.datasets.oscc_pnr",
            "egovlp_tpu_torch.data.datasets.nlq_mq",
            "egovlp_tpu_torch.objectives.classification",
            "egovlp_tpu_torch.metrics.oscc_pnr",
            "egovlp_tpu_torch.evals.oscc_pnr",
            "egovlp_tpu_torch.evals.features",
            "egovlp_tpu_torch.data.pipeline", "egovlp_tpu_torch.cli.train",
            "egovlp_tpu_torch.cli.eval",
            "egovlp_tpu_torch.cli.extract",
            "egovlp_tpu_torch.train.grad_cache",
            "egovlp_tpu_torch.objectives.ring",
            "egovlp_tpu_torch.kernels.ops", "egovlp_tpu_torch.io.export",
            "egovlp_tpu_torch.io.util", "egovlp_tpu_torch.io.visualizer",
            "egovlp_tpu_torch.io.logging", "egovlp_tpu_torch.metrics",
            "egovlp_tpu_torch.metrics.retrieval",
            "egovlp_tpu_torch.data.datasets.webvid",
            "egovlp_tpu_torch.data.datasets.cc3m",
            "egovlp_tpu_torch.cli.convert",
            "egovlp_tpu_torch.tools.charades_meta",
            "egovlp_tpu_torch.tools.video_prep"} <= set(modules)
    # nor pandas, nor cv2: the EgoClip, EPIC and Charades csvs are read
    # with the standard library, and cv2 is imported only where a video or
    # a frame (the EPIC and Ego4D JPEGs too) is decoded with it
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax',"
        " 'pandas', 'cv2') or m.startswith(('jax.', 'egovlp_tpu.', 'pandas.',"
        " 'cv2.')) or m == 'egovlp_tpu')\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
