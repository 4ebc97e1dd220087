"""The kernels as registered ops, and the AOT serving artifact (CPU).

* every one of the ten ops (K1, K2, K4, K5 and K3, forward and backward)
  passes ``torch.library.opcheck`` on CPU tensors, and its CPU
  implementation equals its plain twin bit for bit;
* ``torch.export`` of a two-block video tower holds one
  ``egovlp_torch.space_attention_fwd`` and one ``time_attention_fwd``
  node a block;
* the artifact of a tiny dual encoder (D 64, two blocks, DistilBERT's
  vocabulary of 30,522 so that the weights are real bytes) at buckets
  (1, 2, 4): ``ExportedEmbedder`` equals the live ``Embedder`` at atol
  1e-6 on a padded request (both run the same ops on the same inputs:
  0 expected); above bucket 4 it raises; it serves over HTTP; it is under
  5% of the weights' bytes and its programs hold no parameter; loaded in
  a fresh interpreter it imports no ``egovlp_tpu_torch.models``; a
  manifest exported for ``cuda`` refuses the CPU; the CLI's
  ``--export-aot`` and ``--aot``;
* against the JAX package: the same weights through the bridge, JAX's
  ``ExportedEmbedder`` and the port's embed the same texts and clips
  within ``tests/test_torch_serving.py``'s rtol / atol 1e-4 (float32
  through both towers).
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egovlp_tpu.io.export import ExportedEmbedder as JaxExportedEmbedder
from egovlp_tpu.io.export import export_embedder as jax_export_embedder
from egovlp_tpu.models import (
    DualEncoder as JaxDualEncoder,
    DualEncoderConfig as JaxDualEncoderConfig,
    TextTowerConfig as JaxTextTowerConfig,
    VideoTowerConfig as JaxVideoTowerConfig,
)
from egovlp_tpu.models.convert import save_torch_checkpoint
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.io.export import ExportedEmbedder, export_embedder
from egovlp_tpu_torch.kernels import cuda_attention as ca
from egovlp_tpu_torch.kernels import fused_ln
from egovlp_tpu_torch.models import (
    DualEncoder,
    DualEncoderConfig,
    TextTowerConfig,
    VideoTowerConfig,
)
from egovlp_tpu_torch.models.convert import params_from_jax
from egovlp_tpu_torch.serving import Embedder, serve
from tests.test_torch_models import RES, TEXT, VIDEO

ROOT = Path(__file__).resolve().parents[1]
E = torch.ops.egovlp_torch
PRE = 40
BUCKETS = (1, 2, 4)
VIDEO64 = dict(VIDEO, embed_dim=64)
TEXT64 = dict(TEXT, vocab_size=30522, dim=64, hidden_dim=128)
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "cuts", "onion",
         "opens", "door", "##s"] + [str(i) for i in range(10)]
TEXTS = ["a person cuts onions", "opens door", "3 doors"]


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------

def _randn(g, *shape):
    return torch.randn(*shape, generator=g)


def op_cases():
    """``{op name: (args, plain twin call)}`` on small CPU tensors."""
    g = torch.Generator().manual_seed(0)
    B, f, n, D, H = 2, 3, 5, 16, 2
    grid = [_randn(g, B, f, n, D) for _ in range(4)]
    cls = [_randn(g, B, 1, D) for _ in range(2)]
    hs = [_randn(g, 6, f, n, 8) for _ in range(4)]
    hs_cls = [_randn(g, 6, 1, 8) for _ in range(2)]
    x, scale, bias = _randn(g, 7, 16), _randn(g, 16), _randn(g, 16)
    _, mu, rstd = fused_ln.layer_norm_fwd_plain(x, scale, bias, 1e-6)
    dy = _randn(g, 7, 16)
    cases = {}
    for kind in ("space", "time"):
        fwd = (*grid[:3], *cls)
        cases[f"{kind}_attention_fwd"] = (
            (*fwd, H, 0.25), lambda a, k=kind: getattr(
                ca, f"{k}_attention_fwd_plain")(*a[:5], heads=H, scale=0.25))
        cases[f"{kind}_attention_bwd"] = (
            (*fwd, grid[3], H, 0.25), lambda a, k=kind: getattr(
                ca, f"{k}_attention_bwd_plain")(*a[:6], heads=H, scale=0.25))
    for name in ("grouped_attention", "time_attention_hs"):
        fwd = (*hs[:3], *hs_cls)
        cases[f"{name}_fwd"] = (fwd, lambda a, m=name: getattr(
            ca, f"{m}_fwd_plain")(*a))
        cases[f"{name}_bwd"] = ((*fwd, hs[3]), lambda a, m=name: getattr(
            ca, f"{m}_bwd_plain")(*a))
    cases["layer_norm_fwd"] = ((x, scale, bias, 1e-6),
                               lambda a: fused_ln.layer_norm_fwd_plain(*a))
    cases["layer_norm_bwd"] = ((x, scale, mu, rstd, dy),
                               lambda a: fused_ln.layer_norm_bwd_plain(*a))
    return cases


OP_CASES = op_cases()


def test_ten_ops():
    assert sorted(OP_CASES) == sorted(
        f"{k}_{d}" for k in ("space_attention", "time_attention",
                             "grouped_attention", "time_attention_hs",
                             "layer_norm") for d in ("fwd", "bwd"))


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_opcheck(name):
    args, _ = OP_CASES[name]
    torch.library.opcheck(getattr(E, name).default, args)


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_cpu_op_is_the_plain_twin(name):
    args, plain = OP_CASES[name]
    got = getattr(E, name)(*args)
    want = plain(args)
    if name.endswith("fwd") and not name.startswith("layer_norm"):
        got, want = (got,), (want,)
    elif name == "layer_norm_fwd":
        got = (got[0], *got[1].unbind(0))
    else:  # the stacked outputs, as the wrappers unbind them
        got = (got[0], *got[1].unbind(0)) if name == "layer_norm_bwd" \
            else (*got[0].unbind(0), *got[1].unbind(0))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_ops_check_like_the_launchers():
    args, _ = OP_CASES["space_attention_fwd"]
    with pytest.raises(ValueError, match="divisible"):
        E.space_attention_fwd(*args[:5], 3, 0.25)
    bad = (args[0].double(), *args[1:])
    with pytest.raises(TypeError, match="one dtype"):
        E.space_attention_fwd(*bad)


def test_exported_tower_holds_one_node_a_kernel_call():
    cfg = VideoTowerConfig(**VIDEO64)
    model = DualEncoder(DualEncoderConfig(video=cfg,
                                          text=TextTowerConfig(**TEXT),
                                          projection_dim=8)).video_model.eval()
    video = torch.zeros(1, 4, RES, RES, 3)
    with torch.no_grad():
        ep = torch.export.export(model, (video,))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    depth = cfg.depth
    assert depth == 2
    assert targets.count("egovlp_torch.space_attention_fwd.default") == depth
    assert targets.count("egovlp_torch.time_attention_fwd.default") == depth
    assert targets.count("egovlp_torch.layer_norm_fwd.default") == \
        6 * depth + 1
    assert not [t for t in targets if "bwd" in t]


# --------------------------------------------------------------------------
# the artifact
# --------------------------------------------------------------------------

def jax_cfg():
    return JaxDualEncoderConfig(
        video=JaxVideoTowerConfig(**VIDEO64, attention_impl="xla"),
        text=JaxTextTowerConfig(**TEXT64), projection_dim=8)


@pytest.fixture(scope="module")
def jax_params():
    """The tiny D-64 dual encoder's JAX tree from a numpy seed (LayerNorm
    scales near 1, every other leaf normal with std 0.2)."""
    shapes = jax.eval_shape(
        JaxDualEncoder(jax_cfg()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 4, RES, RES, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)

    def leaf(path, s):
        x = rng.normal(size=s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.2 * x

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    p = tmp_path_factory.mktemp("tok") / "vocab.txt"
    p.write_text("\n".join(WORDS))
    return WordPieceTokenizer(str(p), max_length=8, backend="python")


@pytest.fixture(scope="module")
def artifact(jax_params, tokenizer, tmp_path_factory):
    """The port's artifact of the bridged model, and the live Embedder."""
    cfg = DualEncoderConfig(video=VideoTowerConfig(**VIDEO64),
                            text=TextTowerConfig(**TEXT64), projection_dim=8)
    model = DualEncoder(cfg).eval()
    model.load_state_dict(params_from_jax(jax_params), strict=True)
    path = tmp_path_factory.mktemp("aot") / "embedder.zip"
    manifest = export_embedder(model, str(path), num_frames=4, input_res=RES,
                               pre_size=PRE, max_length=8, buckets=BUCKETS)
    live = Embedder(model, tokenizer, num_frames=4, input_res=RES,
                    pre_size=PRE, buckets=BUCKETS)
    aot = ExportedEmbedder(str(path), model.state_dict(), tokenizer,
                           device="cpu")
    return dict(path=path, manifest=manifest, model=model, live=live, aot=aot)


def clips(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 4, PRE, PRE, 3)).astype(np.uint8)


def test_artifact_equals_the_live_embedder(artifact):
    live, aot = artifact["live"], artifact["aot"]
    assert artifact["manifest"]["buckets"] == [1, 2, 4]
    assert artifact["manifest"]["device"] == "cpu"
    for n in (1, 2, 3, 4):  # 3: padded to bucket 4
        v = aot.embed_frames(clips(n, n))
        np.testing.assert_allclose(v, live.embed_frames(clips(n, n)),
                                   rtol=0, atol=1e-6)
        texts = (TEXTS * 2)[:n]
        t = aot.embed_texts(texts)
        assert t.shape == (n, 8) and v.shape == (n, 8)
        np.testing.assert_allclose(t, live.embed_texts(texts), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="bucket"):
        aot.embed_texts(["a"] * 5)
    with pytest.raises(ValueError, match="bucket"):
        aot.embed_frames(clips(5))
    with pytest.raises(ValueError, match="frames"):
        aot.embed_frames(clips(2)[:, :2])


def test_artifact_holds_no_weights(artifact):
    weights = sum(t.numel() * t.element_size()
                  for t in artifact["model"].state_dict().values())
    size = os.path.getsize(artifact["path"])
    assert size < 0.05 * weights, (size, weights)
    with zipfile.ZipFile(artifact["path"]) as zf:
        for name in zf.namelist():
            if name.endswith(".pt2"):
                ep = torch.export.load(io.BytesIO(zf.read(name)))
                assert not ep.state_dict
                # the ImageNet mean / std and nothing the size of a weight
                assert all(t.numel() <= 3 for t in ep.constants.values())


def test_artifact_serves_over_http(artifact):
    server = serve(artifact["aot"], port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        req = urllib.request.Request(
            f"{url}/embed_text", data=json.dumps({"texts": TEXTS}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            got = np.asarray(json.loads(r.read())["embeddings"])
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
    np.testing.assert_allclose(got, artifact["live"].embed_texts(TEXTS),
                               rtol=0, atol=1e-6)


LOADER = """
import sys
import numpy as np
import torch
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.io.export import ExportedEmbedder
art, weights, vocab, out = sys.argv[1:5]
emb = ExportedEmbedder(art, torch.load(weights, weights_only=True),
                       WordPieceTokenizer(vocab, max_length=8,
                                          backend="python"), device="cpu")
frames = np.random.default_rng(3).integers(0, 256, (3, 4, 40, 40, 3))
np.savez(out, text=emb.embed_texts(["a person cuts onions", "opens door"]),
         video=emb.embed_frames(frames.astype(np.uint8)))
bad = sorted(m for m in sys.modules
             if m.startswith(("egovlp_tpu_torch.models", "jax"))
             or m == "egovlp_tpu" or m.startswith("egovlp_tpu."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_loading_imports_no_model_code(artifact, tokenizer, tmp_path):
    weights = tmp_path / "weights.pt"
    torch.save(artifact["model"].state_dict(), weights)
    res = subprocess.run(
        [sys.executable, "-c", LOADER, str(artifact["path"]), str(weights),
         tokenizer.vocab_path, str(tmp_path / "out.npz")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    out = np.load(tmp_path / "out.npz")
    live = artifact["live"]
    np.testing.assert_allclose(out["text"], live.embed_texts(TEXTS[:2]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["video"], live.embed_frames(clips(3, 3)),
                               rtol=0, atol=1e-6)


def test_artifact_is_tied_to_its_device(artifact, tmp_path):
    cuda_zip = tmp_path / "cuda.zip"
    with zipfile.ZipFile(artifact["path"]) as src, \
            zipfile.ZipFile(cuda_zip, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "manifest.json":
                m = json.loads(data)
                m["device"] = "cuda"
                data = json.dumps(m)
            dst.writestr(name, data)
    sd = artifact["model"].state_dict()
    with pytest.raises(ValueError, match="exported for cuda.*cpu"):
        ExportedEmbedder(str(cuda_zip), sd, device="cpu")
    with pytest.raises(ValueError, match="exported for cpu.*cuda"):
        ExportedEmbedder(str(artifact["path"]), sd, device="cuda")
    bad = dict(sd)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="parameter"):
        ExportedEmbedder(str(artifact["path"]), bad, device="cpu")


def test_port_artifact_matches_jax_artifact(artifact, jax_params, tokenizer,
                                            tmp_path):
    path = str(tmp_path / "jax.zip")
    jax_export_embedder(JaxDualEncoder(jax_cfg()), jax_params, path,
                        num_frames=4, input_res=RES, pre_size=PRE,
                        max_length=8, buckets=BUCKETS)
    ref = JaxExportedEmbedder(path, jax_params, tokenizer)
    aot = artifact["aot"]
    np.testing.assert_allclose(aot.embed_texts(TEXTS), ref.embed_texts(TEXTS),
                               rtol=1e-4, atol=1e-4)
    frames = clips(3, 7)
    np.testing.assert_allclose(aot.embed_frames(frames),
                               ref.embed_frames(frames), rtol=1e-4, atol=1e-4)


def test_cli_exports_and_serves_an_artifact(artifact, jax_params, tokenizer,
                                            tmp_path, monkeypatch):
    """``cli.serve --export-aot`` writes an artifact of the configured
    model and checkpoint; ``--aot`` hands ``serve`` an ExportedEmbedder on
    the checkpoint's weights (``serve`` stubbed: it blocks)."""
    import egovlp_tpu_torch.cli.serve as cli

    ckpt = str(tmp_path / "egovlp.pth")
    save_torch_checkpoint(jax_params, jax_cfg(), ckpt)
    cfg = json.loads((ROOT / "configs/eval/egomcq.json").read_text())
    cfg["arch"]["args"]["video_params"].update(VIDEO64, vit_weights="")
    cfg["arch"]["args"]["text_params"].update(
        TEXT64, vocab=tokenizer.vocab_path, weights="", max_length=8)
    cfg["arch"]["args"]["projection_dim"] = 8
    cfg["arch"]["args"]["precision"] = "fp32"
    cfg["data_loader"]["args"]["video_params"]["input_res"] = RES
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    art = tmp_path / "cli.zip"
    base = ["-c", str(path), "-k", ckpt, "--device", "cpu"]
    cli.main(base + ["--export-aot", str(art)])
    with zipfile.ZipFile(art) as zf:
        manifest = json.loads(zf.read("manifest.json"))
    assert manifest["buckets"] == [1, 4, 16] and manifest["max_length"] == 8
    served = {}
    monkeypatch.setattr(cli, "serve", lambda emb, host, port: served.update(
        emb=emb))
    cli.main(base + ["--aot", str(art)])
    emb = served["emb"]
    assert isinstance(emb, ExportedEmbedder) and emb.buckets == [1, 4, 16]
    np.testing.assert_allclose(emb.embed_texts(TEXTS),
                               artifact["live"].embed_texts(TEXTS), rtol=0,
                               atol=1e-6)
