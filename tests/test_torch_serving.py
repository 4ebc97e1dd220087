"""Port embedding service vs the JAX one (CPU), HTTP API, jax-free import.

Embeddings are compared on the same seeded weights and inputs with
tolerance 1e-4 (float32 through both towers); bucket padding must not
change a real row (1e-5).
"""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from egovlp_tpu.models import DualEncoder as JaxDualEncoder
from egovlp_tpu.serving import Embedder as JaxEmbedder
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.serving import Embedder, serve
from tests.test_torch_models import (  # noqa: F401
    RES,
    jax_config,
    jax_params,
    port_model,
)

PRE = 40
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "cuts",
             "onion", "opens", "door", "##s"] + [str(i) for i in range(10)]
    p = tmp_path_factory.mktemp("tok") / "vocab.txt"
    p.write_text("\n".join(words))
    return WordPieceTokenizer(str(p), max_length=8, backend="python")


@pytest.fixture(scope="module")
def embedders(jax_params, tokenizer):  # noqa: F811
    port = Embedder(port_model(jax_params), tokenizer, num_frames=4,
                    input_res=RES, pre_size=PRE, buckets=BUCKETS)
    ref = JaxEmbedder(JaxDualEncoder(jax_config()), jax_params, tokenizer,
                      num_frames=4, input_res=RES, pre_size=PRE,
                      buckets=BUCKETS)
    return port, ref


TEXTS = ["a person cuts onions", "opens door", "3 doors"]


def clips(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 4, PRE, PRE, 3)).astype(np.uint8)


def test_embedder_matches_jax(embedders):
    port, ref = embedders
    t = port.embed_texts(TEXTS)
    assert t.shape == (3, 8) and t.dtype == np.float32
    np.testing.assert_allclose(t, ref.embed_texts(TEXTS), rtol=1e-4, atol=1e-4)
    frames = clips(3)
    v = port.embed_frames(frames)
    assert v.shape == (3, 8)
    np.testing.assert_allclose(v, ref.embed_frames(frames), rtol=1e-4,
                               atol=1e-4)


def test_buckets_do_not_leak_padding(embedders):
    port, _ = embedders
    np.testing.assert_allclose(port.embed_texts(TEXTS)[:1],
                               port.embed_texts(TEXTS[:1]), atol=1e-5)
    frames = clips(3, seed=1)
    np.testing.assert_allclose(port.embed_frames(frames)[:1],
                               port.embed_frames(frames[:1]), atol=1e-5)
    # past the largest bucket: padded to a multiple of it
    assert port.embed_texts(TEXTS * 2).shape == (6, 8)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def test_http_endpoints(embedders):
    port, _ = embedders
    server = serve(port, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["status"] == "ok"
        status, body = _post(f"{url}/embed_text", {"texts": TEXTS[:2]})
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["embeddings"]),
                                   port.embed_texts(TEXTS[:2]), atol=1e-6)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{url}/embed_text", {})
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_port_imports_no_jax():
    code = ("import sys, egovlp_tpu_torch, egovlp_tpu_torch.serving, "
            "egovlp_tpu_torch.cli.serve, egovlp_tpu_torch.build; "
            "bad = {'jax', 'flax'} & set(sys.modules); "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1],
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_cli_refuses_cuda_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egovlp_tpu_torch.cli.serve import main

    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["-c", "configs/eval/egomcq.json", "--device", "cuda"])


def test_cli_builds_the_embedder_from_a_config(tmp_path, tokenizer,
                                               monkeypatch, jax_params):  # noqa: F811
    """``main`` reads the config, loads a ``.pth`` checkpoint strictly and
    hands a ready Embedder to ``serve`` (stubbed here: it blocks)."""
    import egovlp_tpu_torch.cli.serve as cli
    from egovlp_tpu.models.convert import save_torch_checkpoint
    from tests.test_torch_models import TEXT, VIDEO

    ckpt = str(tmp_path / "egovlp.pth")
    save_torch_checkpoint(jax_params, jax_config(), ckpt)
    cfg = json.loads(Path("configs/eval/egomcq.json").read_text())
    cfg["arch"]["args"]["video_params"].update(VIDEO, vit_weights="")
    cfg["arch"]["args"]["text_params"].update(
        TEXT, vocab=tokenizer.vocab_path, weights="", max_length=8)
    cfg["arch"]["args"]["projection_dim"] = 8
    cfg["data_loader"]["args"]["video_params"]["input_res"] = RES
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    served = {}
    monkeypatch.setattr(cli, "serve", lambda emb, host, port: served.update(
        emb=emb, host=host, port=port))
    cli.main(["-c", str(path), "-k", ckpt, "--device", "cpu", "--port", "0"])
    emb = served["emb"]
    assert served["port"] == 0 and emb.input_res == RES
    want = port_model(jax_params).state_dict()
    for k, v in emb.model.state_dict().items():
        torch.testing.assert_close(v.float(), want[k], rtol=0, atol=0)
    assert emb.embed_texts(TEXTS).shape == (3, 8)
    with pytest.raises(SystemExit, match="not found"):
        cli.main(["-c", str(path), "-k", str(tmp_path / "missing.pth"),
                  "--device", "cpu"])
