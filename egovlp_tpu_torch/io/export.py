"""Ahead-of-time export of the serving embedder (``torch.export``).

Counterpart of ``egovlp_tpu/io/export.py``.  ``export_embedder`` captures
the two embedding functions of a dual encoder, text and video, once per
batch bucket with ``torch.export.export`` and writes them into one zip;
``ExportedEmbedder`` serves that zip with no model code: it imports the
kernels' op registrations (``kernels/ops.py``) and nothing of
``egovlp_tpu_torch.models``.

Artifact layout (zip):

    manifest.json        shapes, buckets, device type, dtype, versions,
                         each parameter's shape and dtype in input order
    text_b{B}.pt2        (params, ids int64 [B, L], mask int32 [B, L])
                         -> [B, P] float32
    video_b{B}.pt2       (params, frames uint8 [B, T, pre, pre, 3])
                         -> [B, P] float32

The inputs are those of the live ``serving.Embedder``; the video program
holds the eval transform (``data/transforms.eval_resize``), whose
interpolation weights are constants of the graph.  The parameters and
buffers are an input of every program (``torch.func.functional_call``),
so the artifact holds no weight and serves any checkpoint of the same
architecture.  The hand-written kernels are nodes of the graph
(``torch.ops.egovlp_torch.*``), launched when the program runs on a CUDA
device.  What the model reads while it is traced (the compute dtype, the
attention route) is frozen into the programs, which are captured from the
model in ``eval()`` under ``torch.no_grad()``.  A program holds the
device it was captured on: an artifact exported on ``cuda`` runs only on
``cuda`` and one exported on ``cpu`` only on ``cpu``.

Usage:

    export_embedder(model, "embedder.zip")
    emb = ExportedEmbedder("embedder.zip", model.state_dict(), tokenizer)
    emb.embed_texts(["a person chops onions"])

CLI: ``python -m egovlp_tpu_torch.cli.serve --config ... --export-aot
out.zip`` exports; ``--aot out.zip`` serves from an artifact.
"""

from __future__ import annotations

import io
import json
import threading
import zipfile
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from egovlp_tpu_torch.data.transforms import eval_resize
# define the K7 and K3 ops and, through cuda_attention, the attention
# kernels' ops: a saved program that calls them loads only after this import
from egovlp_tpu_torch.kernels import bias_gelu, fused_ln  # noqa: F401

MANIFEST = "manifest.json"
FORMAT = "egovlp_tpu_torch.embedder/1"


class _Entry(nn.Module):
    """``fn(model, *inputs)`` as a module whose parameters are the
    model's, under the prefix ``model.``."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(self.model, *inputs)


class _Program(nn.Module):
    """The exported root: it registers no parameter, and runs the entry
    on the parameters it is given as its first input."""

    def __init__(self, entry: _Entry):
        super().__init__()
        self.__dict__["entry"] = entry  # not a submodule

    def forward(self, params: Dict[str, torch.Tensor], *inputs):
        return torch.func.functional_call(
            self.entry, {f"model.{k}": v for k, v in params.items()}, inputs)


def _encode_text(model, ids, mask):
    return model.encode_text(ids, mask)


def _video_fn(input_res: int):
    def encode_video(model, frames):
        return model.encode_video(eval_resize(frames, input_res))

    return encode_video


def _save(program: _Program, args) -> bytes:
    """``program`` captured on ``args`` and serialized; the capture must
    hold no parameter."""
    ep = torch.export.export(program, args)
    if ep.state_dict:
        raise RuntimeError(f"exported program holds parameters: "
                           f"{sorted(ep.state_dict)[:5]}")
    ep.example_inputs = None  # else saved with the program: the weights
    # export asserts the input metadata of every dtype cast (~1 node in 6):
    # host work on each call of a program whose inputs are fixed
    graph = ep.graph_module.graph
    for node in graph.find_nodes(
            op="call_function",
            target=torch.ops.aten._assert_tensor_metadata.default):
        graph.erase_node(node)
    ep.graph_module.recompile()
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_embedder(model: nn.Module, path: str, *, num_frames: int = 4,
                    input_res: int = 224, pre_size: int = 256,
                    max_length: int = 30,
                    buckets: Sequence[int] = (1, 4, 16)) -> dict:
    """Export text and video embedding programs of ``model`` (a
    ``DualEncoder``, put in ``eval()``) for each batch bucket, on the
    device of its parameters, into the zip ``path``; returns the
    manifest."""
    model.eval()
    params = dict(model.state_dict())
    device = next(iter(params.values())).device
    buckets = sorted(set(int(b) for b in buckets))
    text = _Program(_Entry(model, _encode_text))
    video = _Program(_Entry(model, _video_fn(input_res)))
    entries = {}
    with torch.no_grad():
        for b in buckets:
            ids = torch.zeros((b, max_length), dtype=torch.int64,
                              device=device)
            mask = torch.ones((b, max_length), dtype=torch.int32,
                              device=device)
            frames = torch.zeros((b, num_frames, pre_size, pre_size, 3),
                                 dtype=torch.uint8, device=device)
            entries[f"text_b{b}.pt2"] = _save(text, (params, ids, mask))
            entries[f"video_b{b}.pt2"] = _save(video, (params, frames))
    manifest = {
        "format": FORMAT,
        "buckets": buckets,
        "num_frames": num_frames,
        "input_res": input_res,
        "pre_size": pre_size,
        "max_length": max_length,
        "device": device.type,
        "dtype": str(model.video_model.dtype),
        "torch_version": torch.__version__,
        "n_params": int(sum(t.numel() for t in params.values())),
        "params": {k: [list(t.shape), str(t.dtype)]
                   for k, t in params.items()},
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(MANIFEST, json.dumps(manifest, indent=1))
        for name, data in entries.items():
            zf.writestr(name, data)
    return manifest


class ExportedEmbedder:
    """``serving.Embedder``'s contract on an artifact: texts padded with
    ``""`` and clips by repeating the last one up to the bucket, results
    sliced back; a batch above the largest bucket raises (the live
    Embedder grows instead).  ``state_dict`` holds the parameters the
    artifact's architecture names (a ``DualEncoder.state_dict()``)."""

    def __init__(self, path: str, state_dict: Dict[str, torch.Tensor],
                 tokenizer=None, device: "torch.device | str" = "cuda"):
        device = torch.device(device)
        with zipfile.ZipFile(path) as zf:
            self.manifest = json.loads(zf.read(MANIFEST))
            if self.manifest.get("format") != FORMAT:
                raise ValueError(f"{path}: format "
                                 f"{self.manifest.get('format')!r}, "
                                 f"expected {FORMAT!r}")
            if self.manifest["device"] != device.type:
                raise ValueError(
                    f"{path} was exported for {self.manifest['device']} and "
                    f"does not run on {device}: export it again on "
                    f"{device.type}")
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"device {device}: no CUDA device is "
                                   "available")
            self.buckets = sorted(self.manifest["buckets"])
            self._text = {b: self._load(zf, f"text_b{b}.pt2")
                          for b in self.buckets}
            self._video = {b: self._load(zf, f"video_b{b}.pt2")
                           for b in self.buckets}
        self.params = {}
        for k, (shape, dtype) in self.manifest["params"].items():
            t = state_dict.get(k)
            if t is None or list(t.shape) != shape or str(t.dtype) != dtype:
                raise ValueError(
                    f"parameter {k}: the artifact takes {shape} {dtype}, "
                    "the state_dict has "
                    + ("none" if t is None else f"{list(t.shape)} {t.dtype}"))
            self.params[k] = t.to(device)
        self.device = device
        self.tokenizer = tokenizer
        self.num_frames = self.manifest["num_frames"]
        self.pre_size = self.manifest["pre_size"]
        self.input_res = self.manifest["input_res"]
        # one request on the device at a time: the HTTP server is threaded
        self._lock = threading.Lock()

    @staticmethod
    def _load(zf: zipfile.ZipFile, name: str):
        gm = torch.export.load(io.BytesIO(zf.read(name))).module()
        # the parameters are checked against the manifest once, here, and
        # each request's shape and dtype by the embed methods: the module's
        # own check of every input on every call costs more host time than
        # a bucket-1 video call's kernels
        gm.validate_inputs = False
        return gm

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch {n} exceeds the largest exported bucket {self.buckets[-1]}")

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("ExportedEmbedder needs a tokenizer for texts")
        n = len(texts)
        b = self._bucket(n)
        ids, mask = self.tokenizer(list(texts) + [""] * (b - n))
        L = self.manifest["max_length"]
        if ids.shape[1] != L:
            raise ValueError(f"tokenizer length {ids.shape[1]} != exported {L}")
        ids = torch.from_numpy(ids).long().to(self.device)
        mask = torch.from_numpy(mask).to(self.device)
        with self._lock, torch.no_grad():
            return self._text[b](self.params, ids, mask)[:n].cpu().numpy()

    def embed_frames(self, frames: np.ndarray) -> np.ndarray:
        """frames: uint8 ``[N, T, pre, pre, 3]``."""
        clip = (self.num_frames, self.pre_size, self.pre_size, 3)
        if frames.ndim != 5 or frames.shape[1:] != clip:
            raise ValueError(f"frames {frames.shape}: expected [N, *{clip}]")
        n = frames.shape[0]
        b = self._bucket(n)
        if b != n:
            pad = np.repeat(frames[-1:], b - n, axis=0)
            frames = np.concatenate([frames, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(frames, np.uint8))
        with self._lock, torch.no_grad():
            return self._video[b](self.params,
                                  x.to(self.device))[:n].cpu().numpy()

    def embed_videos(self, paths: Sequence[str]) -> np.ndarray:
        from egovlp_tpu_torch.data.readers import read_frames

        clips = [read_frames(p, self.num_frames, sample="uniform",
                             pre_size=self.pre_size)[0] for p in paths]
        return self.embed_frames(np.stack(clips))

    def similarity(self, texts: Sequence[str], paths: Sequence[str]
                   ) -> np.ndarray:
        """Cosine similarities ``[texts, videos]`` with eps-clamped norms
        (``models.dual_encoder.sim_matrix``, not imported here)."""
        t = torch.from_numpy(self.embed_texts(texts)).float()
        v = torch.from_numpy(self.embed_videos(paths)).float()
        t = t / t.norm(dim=1, keepdim=True).clamp_min(1e-8)
        v = v / v.norm(dim=1, keepdim=True).clamp_min(1e-8)
        return (t @ v.T).numpy()
