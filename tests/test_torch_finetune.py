"""The port's EPIC-Kitchens MIR and CharadesEgo fine-tunes vs the JAX
package (CPU, float32), at tiny width (2 video blocks, 2 text layers,
D 24).

* ``max_margin`` / ``adaptive_max_margin``: values and gradients, with
  ``fix_norm`` on and off;
* ``calculate_nDCG``, ``calculate_mAP``, ``mir_metrics_from_matrices``,
  ``charades_map`` / ``charades_metrics`` and ``evaluate_epic_mir``
  (dual-softmax and cosine): the same numpy on the same inputs, so equal;
* ``embed_dataset`` and ``evaluate_charades`` on a tiny model through the
  Loader, against the JAX evaluations through the JAX Loader;
* one EPIC step (max-margin and adaptive) and one Charades step: the loss
  and every parameter's gradient against the JAX steps, the port's crop
  sampler patched to JAX's boxes for the step's key;
* the video tower at 16 frames against the JAX tower with its Pallas
  kernels in interpret mode (the time kernel's f > 8 path);
* ``cli.eval``'s refusal of NLQ / MQ, which have no evaluation.

Tolerances are stated per test.  The JAX side is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from egovlp_tpu.data.datasets import DatasetConfig as JaxDatasetConfig
from egovlp_tpu.data.datasets import dataset_factory as jax_dataset_factory
from egovlp_tpu.data.pipeline import Loader as JaxLoader
from egovlp_tpu.data.text import WordPieceTokenizer as JaxTokenizer
from egovlp_tpu.evals.charades import evaluate_charades as jax_eval_charades
from egovlp_tpu.evals.epic_mir import embed_dataset as jax_embed_dataset
from egovlp_tpu.evals.epic_mir import evaluate_epic_mir as jax_eval_epic
from egovlp_tpu.metrics.charades import charades_map as jax_charades_map
from egovlp_tpu.metrics.charades import (
    charades_metrics as jax_charades_metrics,
)
from egovlp_tpu.metrics.map import calculate_mAP as jax_map
from egovlp_tpu.metrics.mir import (
    mir_metrics_from_matrices as jax_mir_from_matrices,
)
from egovlp_tpu.metrics.ndcg import calculate_nDCG as jax_ndcg
from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.models import DualEncoderConfig as JaxDualEncoderConfig
from egovlp_tpu.models import TextTowerConfig as JaxTextTowerConfig
from egovlp_tpu.models import VideoTowerConfig as JaxVideoTowerConfig
from egovlp_tpu.objectives import adaptive_max_margin as jax_adaptive
from egovlp_tpu.objectives import max_margin as jax_max_margin
from egovlp_tpu.train.state import create_train_state
from egovlp_tpu.train.steps import (
    make_charades_train_step as jax_make_charades_step,
)
from egovlp_tpu.train.steps import make_epic_train_step as jax_make_epic_step
from egovlp_tpu_torch.cli import eval as cli_eval
from egovlp_tpu_torch.data.datasets import DatasetConfig, dataset_factory
from egovlp_tpu_torch.data.pipeline import Loader
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.evals.charades import (
    evaluate_charades,
    load_charades_classes,
)
from egovlp_tpu_torch.evals.epic_mir import (
    cosine_rescaled,
    dual_softmax,
    embed_dataset,
    evaluate_epic_mir,
)
from egovlp_tpu_torch.metrics.charades import charades_map, charades_metrics
from egovlp_tpu_torch.metrics.map import calculate_mAP
from egovlp_tpu_torch.metrics.mir import mir_metrics_from_matrices
from egovlp_tpu_torch.metrics.ndcg import calculate_nDCG
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.objectives.ranking import adaptive_max_margin, max_margin
from egovlp_tpu_torch.train import steps as port_steps
from tests.test_readers import make_video
from tests.test_torch_ft_data import graded_root  # noqa: F401
from tests.test_torch_models import (
    RES,
    TEXT,
    VIDEO,
    jax_config,
    port_model,
    random_params,
)
from tests.test_torch_train import jax_boxes

PRE = 40
FT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "wash", "cup", "put", "pan",
            "then", "lid", "sentence", ",", "someone", "is", "opening",
            "door", "a", "person", "sits", "holding", "box"] + [
                str(i) for i in range(10)]


# --------------------------------------------------------------------------
# max-margin objectives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fix_norm", [True, False])
@pytest.mark.parametrize("adaptive", [False, True])
def test_max_margin_value_and_grad_match_jax(adaptive, fix_norm):
    rng = np.random.default_rng(3 + adaptive)
    n = 7
    sim = np.tanh(rng.normal(size=(n, n))).astype(np.float32)
    weight = rng.choice([0.34, 0.5, 1.0], n).astype(np.float32)
    if adaptive:
        def jax_loss(s):
            return jax_adaptive(s, weight, margin=0.4, fix_norm=fix_norm)
    else:
        def jax_loss(s):
            return jax_max_margin(s, margin=0.2, fix_norm=fix_norm)
    want, want_g = jax.jit(jax.value_and_grad(jax_loss))(sim)
    s = torch.from_numpy(sim).requires_grad_()
    got = (adaptive_max_margin(s, torch.from_numpy(weight), margin=0.4,
                               fix_norm=fix_norm) if adaptive
           else max_margin(s, margin=0.2, fix_norm=fix_norm))
    got.backward()
    # float32 sums of 2n^2 terms in another order; gradients are
    # multiples of 1 / (2 n (n - 1)) or 1 / (2 n^2), ~1e-2
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-7)
    # fix_norm averages the off-diagonal pairs only: the diagonal pairs
    # contribute the margin and no gradient
    assert not fix_norm or (s.grad.diagonal().abs().sum() > 0 or
                            float(want) == 0)


def test_max_margin_casts_bf16_to_float32():
    sim = torch.tanh(torch.randn(5, 5, generator=torch.Generator()
                                 .manual_seed(0)))
    a = max_margin(sim.to(torch.bfloat16))
    b = max_margin(sim.to(torch.bfloat16).float())
    assert a.dtype == torch.float32 and a.item() == b.item()


# --------------------------------------------------------------------------
# metrics (numpy on the host, copies of the JAX package's)
# --------------------------------------------------------------------------

def graded_relevancy(rng, nv, nt):
    """``[nv, nt]`` graded relevancy in which every video and every
    sentence has at least one exact 1 (mAP's indicator), as in EPIC."""
    rel = rng.choice([0.0, 0.0, 0.34, 0.5, 1.0], size=(nv, nt))
    rel[np.arange(max(nv, nt)) % nv, np.arange(max(nv, nt)) % nt] = 1.0
    return rel


def _graded(seed, nv=9, nt=7):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nv, nt)), graded_relevancy(rng, nv, nt)


@pytest.mark.parametrize("seed", [0, 1])
def test_ndcg_and_map_equal_jax(seed):
    sim, rel = _graded(seed)
    for s, r in ((sim, rel), (sim.T, rel.T)):
        assert calculate_nDCG(s, r) == jax_ndcg(s, r)
        np.testing.assert_array_equal(calculate_nDCG(s, r, reduction=None),
                                      jax_ndcg(s, r, reduction=None))
        assert calculate_mAP(s, r) == jax_map(s, r)


def test_mir_metrics_from_matrices_equal_jax():
    rng = np.random.default_rng(4)
    n = 8
    emb_t, emb_v = rng.normal(size=(2, n, 6))
    sim = (emb_t / np.linalg.norm(emb_t, axis=1, keepdims=True)) @ (
        emb_v / np.linalg.norm(emb_v, axis=1, keepdims=True)).T
    idx = rng.permutation(n)  # model order
    video_ids = np.array([f"v{i // 2}" for i in range(n)], object)  # pairs
    text_ids = np.array([f"v{i}" for i in range(n // 2)], object)
    rel = graded_relevancy(rng, n, n // 2)
    got = mir_metrics_from_matrices(sim, idx, video_ids, text_ids, rel)
    assert got == jax_mir_from_matrices(sim, idx, video_ids, text_ids, rel)
    assert set(got) == {"nDCG_V2T", "nDCG_T2V", "nDCG_AVG", "mAP_V2T",
                        "mAP_T2V", "mAP_AVG"}


def test_charades_map_equals_jax():
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(12, 157))
    gt = (rng.random((12, 157)) < 0.05).astype(np.int32)
    gt[3] = 0  # a video with no action: masked to -inf
    gt[:, 7] = 0  # a class with no video: NaN, left out of the mean
    gt[:, 9] = 1
    m, w, ap = charades_map(scores, gt)
    jm, jw, jap = jax_charades_map(scores, gt)
    assert m == jm and np.isnan(ap[7])
    np.testing.assert_array_equal(ap, jap)
    np.testing.assert_array_equal(w, jw)
    assert charades_metrics(scores, gt) == jax_charades_metrics(scores, gt)


@pytest.mark.parametrize("use_dual_softmax", [True, False])
def test_evaluate_epic_mir_equals_jax(use_dual_softmax):
    rng = np.random.default_rng(6)
    n, d = 10, 8
    t = rng.normal(size=(n, d)).astype(np.float32) * 3
    v = rng.normal(size=(n, d)).astype(np.float32) * 3
    video_ids = np.array([f"P01_{i % 7}" for i in range(n)], object)
    text_ids = np.array([f"P01_{i}" for i in range(7)], object)
    rel = graded_relevancy(rng, n, 7)
    got = evaluate_epic_mir(t, v, video_ids, text_ids, rel,
                            use_dual_softmax=use_dual_softmax)
    want = jax_eval_epic(t, v, video_ids, text_ids, rel,
                         use_dual_softmax=use_dual_softmax)
    assert got == want
    assert all(0.0 <= x <= 100.0 for x in got.values())
    # dual-softmax is a column softmax of raw dot products: columns sum
    # to 1; cosine rescaled lies in [0, 1]
    np.testing.assert_allclose(dual_softmax(t, v).sum(0), 1.0, rtol=1e-5)
    c = cosine_rescaled(t, v)
    assert c.min() >= 0.0 and c.max() <= 1.0


# --------------------------------------------------------------------------
# evaluations through the Loader, on a tiny model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ft_vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(FT_VOCAB))
    return str(path)


def _loaders(name, root, split, vocab, bs=4):
    kw = dict(data_dir=root, split=split, num_frames=4, pre_size=PRE)
    opts = dict(batch_size=bs, num_workers=2, drop_last=False)
    port = Loader(dataset_factory(name)(DatasetConfig(**kw)),
                  tokenizer=WordPieceTokenizer(vocab, max_length=8), **opts)
    jax_loader = JaxLoader(jax_dataset_factory(name)(JaxDatasetConfig(**kw)),
                           tokenizer=JaxTokenizer(vocab, max_length=8),
                           **opts)
    return port, jax_loader


def test_embed_dataset_and_epic_metrics_match_jax(graded_root,  # noqa: F811
                                                  ft_vocab):
    params = random_params(8)
    model = port_model(params)
    port_l, jax_l = _loaders("MultiInstanceRetrieval", graded_root, "test",
                             ft_vocab)
    try:
        t, v, idx = embed_dataset(model, port_l, RES)
        jt, jv, jidx = jax_embed_dataset(JaxDualEncoder(jax_config()),
                                         params, jax_l, RES)
    finally:
        port_l.close()
        jax_l.close()
    np.testing.assert_array_equal(idx, np.arange(len(idx)))
    np.testing.assert_array_equal(idx, jidx)
    # float32 through both towers (raw embeddings, ~1 in size)
    np.testing.assert_allclose(t, jt, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-5)
    from egovlp_tpu_torch.metrics.mir import load_epic_annotations

    ann = load_epic_annotations(graded_root)
    for dual in (True, False):
        got = evaluate_epic_mir(t, v, *ann, use_dual_softmax=dual)
        want = jax_eval_epic(jt, jv, *ann, use_dual_softmax=dual)
        # the same ranks: the embeddings differ by ~1e-6, far below the
        # gaps between the scores of these random clips
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


@pytest.fixture(scope="module")
def charades_tree(tmp_path_factory):
    """4 videos, a test csv with 0-3 actions a video (one has none), a
    train csv, and the 157-line class file."""
    import pandas as pd

    root = tmp_path_factory.mktemp("charades_ft")
    ids = [f"V{i}EGO" for i in range(4)]
    for i, vid in enumerate(ids):
        make_video(root / f"{vid}.mp4", n_frames=30 + 10 * i)
    actions = ["c001 0.0 1.0;c003 0.5 1.5", "c003 0.1 0.9", "",
               "c001 0.0 0.5;c002 0.2 1.0;c156 0.1 0.3"]
    pd.DataFrame({
        "id": ids, "subject": ["s"] * 4, "scene": ["x"] * 4,
        "quality": [5] * 4, "relevance": [5] * 4, "verified": ["Yes"] * 4,
        "descriptions": ["a person sits"] * 4, "actions": actions,
        "length": [2.0] * 4,
    }).to_csv(root / "CharadesEgo_v1_test_only1st.csv", index=False)
    pd.DataFrame({
        "id": ids * 2, "narration": ["someone is opening door",
                                     "a person sits"] * 4,
        "cls": ["c001", "c003"] * 4, "t_start": [0.0, 0.2] * 4,
        "t_end": [0.8, 1.0] * 4,
    }).to_csv(root / "metadata_train.csv", sep="\t", index=False)
    words = ["someone is holding box", "a person sits", "opening door"]
    (root / "Charades_v1_classes.txt").write_text("\n".join(
        f"c{i:03d} {words[i % 3]} {i % 10}" for i in range(157)))
    return str(root)


def test_evaluate_charades_matches_jax(charades_tree, ft_vocab):
    params = random_params(9)
    model = port_model(params)
    classes = load_charades_classes(f"{charades_tree}/Charades_v1_classes.txt")
    assert len(classes) == 157 and classes[3] == "someone is holding box 3"
    port_l, jax_l = _loaders("CharadesEgo", charades_tree, "test", ft_vocab,
                             bs=3)
    try:
        got = evaluate_charades(model, port_l, classes,
                                WordPieceTokenizer(ft_vocab, max_length=8),
                                RES)
        want = jax_eval_charades(JaxDualEncoder(jax_config()), params, jax_l,
                                 classes, JaxTokenizer(ft_vocab, max_length=8),
                                 RES)
    finally:
        port_l.close()
        jax_l.close()
    assert set(got) == {"mAP"} and 0.0 <= got["mAP"] <= 1.0
    # float32 embeddings ~1e-6 apart: the same ranks, the same mAP
    assert got["mAP"] == pytest.approx(want["mAP"], rel=1e-6)


# --------------------------------------------------------------------------
# one training step against the JAX step: loss and gradients
# --------------------------------------------------------------------------

def grad_capture():
    """An optax transformation that applies nothing and keeps the last
    gradients as its state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class KeepGrads:
    """An optimizer that keeps the gradients the step computed."""

    def __init__(self, model):
        self.model = model

    def zero_grad(self, set_to_none=True):
        self.model.zero_grad(set_to_none=set_to_none)

    def step(self):
        pass


def ft_batch(seed, b=4, frames=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, TEXT["vocab_size"], (b, 8)).astype(np.int32)
    mask = np.ones((b, 8), np.int32)
    mask[1, 4:] = 0
    ids[mask == 0] = 0
    return {"frames": rng.integers(0, 256, (b, frames, PRE, PRE, 3),
                                   dtype=np.uint8),
            "text_ids": ids, "text_mask": mask,
            "relation": rng.choice([0.34, 0.5, 0.67, 1.0], b).astype(
                np.float32),
            "item_v": np.arange(b, dtype=np.int32),
            "text": ["unused caption"] * b}


def step_against_jax(jax_step, port_step, params, batch, monkeypatch,
                     key=7):
    """``(port loss, jax loss, port grads, jax grads)`` of one step on
    ``batch`` from ``params``; the port takes JAX's crop boxes."""
    rng = jax.random.PRNGKey(key)
    state = create_train_state(JaxDualEncoder(jax_config("xla")), params,
                               grad_capture())
    state, want = jax_step(state, batch, rng)
    want_g = params_from_jax(jax.tree.map(np.asarray, state.opt_state))
    monkeypatch.setattr(port_steps, "sample_crop_boxes",
                        lambda gen, b, src: jax_boxes(
                            jax.random.split(rng)[0], b, src))
    model = port_model(params)
    got = port_step(model, KeepGrads(model),
                    {k: torch.from_numpy(v) for k, v in
                     port_steps.numeric_batch(batch).items()},
                    torch.Generator())
    got_g = {k: p.grad for k, p in model.named_parameters()}
    return got, want, got_g, want_g


def assert_grads_close(got_g, want_g):
    assert set(got_g) == set(want_g)
    g_max = max(g.abs().max().item() for g in want_g.values())
    for k, w in want_g.items():
        assert got_g[k] is not None, k
        # float32 through both towers, summed in another order: 1e-4 of
        # an element, and a floor of 1e-5 of the largest gradient (the
        # key biases' gradients are zero in exact arithmetic)
        np.testing.assert_allclose(got_g[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * g_max, err_msg=k)


@pytest.mark.parametrize("loss_type,margin", [
    ("MaxMarginRankingLoss", 0.2), ("AdaptiveMaxMarginRankingLoss", 0.4)])
def test_epic_step_loss_and_grads_match_jax(loss_type, margin, monkeypatch):
    params = random_params(10)
    batch = ft_batch(20)
    got, want, got_g, want_g = step_against_jax(
        jax_make_epic_step(loss_type=loss_type, input_res=RES, margin=margin),
        port_steps.make_epic_train_step(loss_type=loss_type, input_res=RES,
                                        margin=margin),
        params, batch, monkeypatch)
    assert float(want) > 0  # some pairs inside the margin: a gradient
    # float32 through both towers and the ranking loss
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    assert_grads_close(got_g, want_g)


def test_charades_step_loss_and_grads_match_jax(monkeypatch):
    params = random_params(11)
    batch = ft_batch(21)
    got, want, got_g, want_g = step_against_jax(
        jax_make_charades_step(input_res=RES),
        port_steps.make_charades_train_step(input_res=RES),
        params, batch, monkeypatch, key=8)
    # float32 through both towers and InfoNCE at temperature 0.05
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    assert_grads_close(got_g, want_g)


# --------------------------------------------------------------------------
# 16 frames: the video tower against JAX's Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def test_video_tower_at_16_frames_matches_jax_pallas():
    """The time attention at f 16, where JAX's time kernel takes one row
    max over all heads of a lane block and the port one per head: the
    same softmax wherever no head's exponentials underflow, as here
    (logits of a few units)."""
    video = {**VIDEO, "num_frames": 16}
    jcfg = JaxDualEncoderConfig(
        video=JaxVideoTowerConfig(**video, attention_impl="pallas"),
        text=JaxTextTowerConfig(**TEXT), projection_dim=8)
    jmodel = JaxDualEncoder(jcfg)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 16, RES, RES, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(12)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 + 0.1 * rng.normal(size=s.shape)
                         if path[-1].key == "scale"
                         else 0.2 * rng.normal(size=s.shape)
                         ).astype(np.float32), shapes)
    clips = rng.normal(size=(2, 16, RES, RES, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x, method="encode_video"))(params, clips))
    model = DualEncoder(DualEncoderConfig(
        video=VideoTowerConfig(**video), text=TextTowerConfig(**TEXT),
        projection_dim=8)).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = model.encode_video(torch.from_numpy(clips)).numpy()
    # float32 through 2 blocks, Pallas in interpret mode vs the port's
    # plain twins: ~1e-6 apart
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# cli.eval: the tasks it has no evaluation for
# --------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["nlq", "mq"])
def test_cli_eval_refuses_the_tasks_still_to_port(task, tmp_path):
    """NLQ / MQ have no metric in either package: ``cli.eval`` raises
    before it builds anything, naming ``cli.extract``, where their
    features come from.  (OSCC and PNR are evaluated:
    ``tests/test_torch_oscc_pnr.py``.)"""
    import json

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"task": task, "arch": {"args": {}}}))
    with pytest.raises(NotImplementedError, match="cli.extract"):
        cli_eval.main(["--config", str(path), "--device", "cpu"])
