"""Batched embedding service.

Counterpart of ``egovlp_tpu/serving.py``.  ``Embedder`` wraps a dual
encoder with fixed batch buckets (text padded with ``""``, video padded by
repeating the last clip, results sliced back), the training tokenizer and
the eval transform on the model's device.  ``serve()`` exposes it over a
minimal stdlib HTTP JSON API:

    POST /embed_text   {"texts": ["a person chops onions", ...]}
    POST /embed_video  {"paths": ["/data/clip.mp4", ...]}  (server-local)
    POST /similarity   {"texts": [...], "paths": [...]}
    GET  /healthz

Run: ``python -m egovlp_tpu_torch.cli.serve --config ... --port 8000``.
"""

from __future__ import annotations

import json
import threading
from typing import Sequence

import numpy as np
import torch

from egovlp_tpu_torch.data.readers import read_frames
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.data.transforms import eval_resize
from egovlp_tpu_torch.models.dual_encoder import DualEncoder, sim_matrix


class Embedder:
    def __init__(self, model: DualEncoder, tokenizer: WordPieceTokenizer,
                 num_frames: int = 4, input_res: int = 224,
                 pre_size: int = 256, buckets: Sequence[int] = (1, 4, 16)):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.input_res = input_res
        self.pre_size = pre_size
        self.buckets = sorted(buckets)
        # one request on the device at a time: the HTTP server is threaded
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return -(-n // self.buckets[-1]) * self.buckets[-1]

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        n = len(texts)
        padded = list(texts) + [""] * (self._bucket(n) - n)
        ids, mask = self.tokenizer(padded)
        ids = torch.from_numpy(ids).long().to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        with self._lock, torch.inference_mode():
            out = self.model.encode_text(ids, mask)
            return out[:n].cpu().numpy()

    def embed_frames(self, frames: np.ndarray) -> np.ndarray:
        """frames: uint8 ``[N, T, pre, pre, 3]``."""
        n = frames.shape[0]
        b = self._bucket(n)
        if b != n:
            pad = np.repeat(frames[-1:], b - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        with self._lock, torch.inference_mode():
            out = self.model.encode_video(eval_resize(x, self.input_res))
            return out[:n].cpu().numpy()

    def embed_videos(self, paths: Sequence[str]) -> np.ndarray:
        clips = [read_frames(p, self.num_frames, sample="uniform",
                             pre_size=self.pre_size)[0] for p in paths]
        return self.embed_frames(np.stack(clips))

    def similarity(self, texts: Sequence[str], paths: Sequence[str]
                   ) -> np.ndarray:
        t = torch.from_numpy(self.embed_texts(texts))
        v = torch.from_numpy(self.embed_videos(paths))
        return sim_matrix(t, v).numpy()


def serve(embedder: Embedder, host: str = "127.0.0.1", port: int = 8000,
          block: bool = True):
    """Minimal stdlib HTTP JSON server around an Embedder."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/embed_text":
                    out = embedder.embed_texts(req["texts"])
                    self._send(200, {"embeddings": out.tolist()})
                elif self.path == "/embed_video":
                    out = embedder.embed_videos(req["paths"])
                    self._send(200, {"embeddings": out.tolist()})
                elif self.path == "/similarity":
                    out = embedder.similarity(req["texts"], req["paths"])
                    self._send(200, {"similarity": out.tolist()})
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001 — report to client
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *a):
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    if block:
        server.serve_forever()
    return server
