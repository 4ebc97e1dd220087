#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``egovlp_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which passes or raises (any failure exits non-zero):

1. device: a CUDA device must be present; prints the ``nvidia-smi`` name
   and power limit of the card;
2. build: compiles the hand-written kernels (``kernels/csrc``, nvcc,
   sm_90a) and prints the build time;
3. kernels: each kernel against its plain PyTorch twin, float32 (max abs
   error <= 1e-4) and bf16 (<= 2e-2, unit-normal inputs), at the serving
   shapes and at f 1 / 16 and a ragged n; then kernel and plain median
   times (CUDA events);
4. slice: the full-width dual encoder of ``configs/eval/egomcq.json`` in
   bf16 with seeded random weights (time attention initialised non-zero,
   so the time kernel sees real inputs) behind ``serve()``: ``/healthz``,
   ``/embed_text`` and ``embed_frames`` on seeded uint8 clips for
   N in {1, 3, 16}.  Checks shapes, finiteness, bucket invariance, the
   kernel launch counts of that run (12 space + 12 time per tower pass),
   and the cosine of each embedding against the plain-attention model
   (``attention_impl='xla'``) on the same weights; prints per-bucket
   latencies.

The last three lines are the ``nvidia-smi`` line, a JSON object with one
entry per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "space_attention_fwd": "egovlp_tpu/kernels/pallas_attention.py:751",
    "time_attention_fwd": "egovlp_tpu/kernels/pallas_attention.py:1475",
}
HEADS, DIM = 12, 768
SCALE = (DIM // HEADS) ** -0.5
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "cuts", "an",
         "onion", "opens", "the", "door", "picks", "up", "knife", "##s"]
TEXTS = ["a person cuts an onion", "opens the door", "picks up the knife"]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def grid_inputs(B, f, n, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    return mk(B, f, n, DIM), mk(B, f, n, DIM), mk(B, f, n, DIM), \
        mk(B, 1, DIM), mk(B, 1, DIM)


def phase_kernels(ca, smi: str) -> dict:
    import torch

    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for name in KERNELS:
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        for dtype in (torch.float32, torch.bfloat16):
            for B, f, n in ((4, 4, 196), (4, 1, 196), (4, 16, 196), (4, 4, 61)):
                x = grid_inputs(B, f, n, dtype, seed=f * 1000 + n)
                got = kernel(*x, heads=HEADS, scale=SCALE)
                torch.cuda.synchronize()
                want = plain(*x, heads=HEADS, scale=SCALE)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = err <= tol[dtype] and bool(torch.isfinite(got).all())
                print(f"check {name} {str(dtype)[6:]} B{B} f{f} n{n}: "
                      f"max_abs_err {err:.3e} (tol {tol[dtype]:.0e}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"{name} disagrees with its plain version")

    rows = {}
    for name in KERNELS:
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        for dtype, B in ((torch.bfloat16, 16), (torch.bfloat16, 4),
                         (torch.float32, 4)):
            x = grid_inputs(B, 4, 196, dtype, seed=B)
            t_plain = median_ms(lambda: plain(*x, heads=HEADS, scale=SCALE))
            t_kernel = median_ms(lambda: kernel(*x, heads=HEADS, scale=SCALE))
            err = (kernel(*x, heads=HEADS, scale=SCALE).float()
                   - plain(*x, heads=HEADS, scale=SCALE).float()
                   ).abs().max().item()
            print(f"time {name} {str(dtype)[6:]} B{B} f4 n196: kernel "
                  f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms [{smi}]",
                  flush=True)
            if (dtype, B) == (torch.bfloat16, 16):
                rows[name] = {"ms": t_kernel, "plain_ms": t_plain,
                              "max_abs_err": err, "dtype": "bfloat16",
                              "shape": [B, 4, 196, DIM]}
    return rows


def phase_slice(ca, smi: str) -> tuple:
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.serving import Embedder, serve

    tmp = tempfile.TemporaryDirectory()
    vocab = Path(tmp.name) / "vocab.txt"
    vocab.write_text("\n".join(VOCAB))
    config = load_config(str(ROOT / "configs/eval/egomcq.json"))
    # non-zero time attention: with the reference's zero init every time
    # q/k/v would be zero and the time kernel would be checked on nothing
    config.override("arch.args.video_params.time_init", "random")
    config.override("arch.args.text_params.vocab", str(vocab))
    arch = config["arch"]

    model, cfg = build.build_model(arch, "cuda")
    build.load_pretrained(build.init_params(model, seed=0), arch)
    check(model.video_model.dtype == torch.bfloat16, "compute dtype not bf16")
    check(cfg.video.embed_dim == DIM and cfg.video.depth == 12
          and cfg.text.n_layers == 6 and cfg.projection_dim == 256,
          f"not the full-width model: {cfg}")
    tok = build.build_tokenizer(config, 30)
    emb = Embedder(model, tok, num_frames=4, input_res=224, pre_size=256)
    clips = np.random.default_rng(0).integers(
        0, 256, (16, 4, 256, 256, 3), dtype=np.uint8)
    emb.embed_frames(clips[:1])  # first call: cuBLAS and allocator set-up

    # ---- the main path, counted ------------------------------------------
    ca.reset_launch_counts()
    server = serve(emb, "127.0.0.1", 0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            check(json.loads(r.read()) == {"status": "ok"}, "healthz")
        req = urllib.request.Request(
            f"{url}/embed_text", data=json.dumps({"texts": TEXTS}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            text_emb = np.asarray(json.loads(r.read())["embeddings"])
        outs = {n: emb.embed_frames(clips[:n]) for n in (1, 3, 16)}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    counts = dict(ca.launches)
    # ------------------------------------------------------------------------
    check(not thread.is_alive(), "server thread did not stop")
    print(f"slice launches: {counts}", flush=True)
    passes = len(outs)  # each N <= 16 is one bucket, one video tower pass
    for name in KERNELS:
        check(counts[name] == 12 * passes,
              f"{name}: {counts[name]} launches, expected {12 * passes}")
    check(text_emb.shape == (len(TEXTS), 256)
          and np.isfinite(text_emb).all(), f"text {text_emb.shape}")
    for n, out in outs.items():
        check(out.shape == (n, 256) and np.isfinite(out).all(),
              f"video N={n}: {out.shape}")

    def cos(a, b):
        return float((a * b).sum() / np.linalg.norm(a) / np.linalg.norm(b))

    c_bucket = min(cos(outs[3][0], outs[1][0]), cos(outs[16][0], outs[1][0]))
    print(f"bucket invariance: min cos(row 0) {c_bucket:.6f}", flush=True)
    check(c_bucket >= 0.999, "row 0 changes with the batch bucket")

    xla_config = copy.deepcopy(config)
    xla_config.override("arch.args.video_params.attention_impl", "xla")
    ref_model, _ = build.build_model(xla_config["arch"], "cuda")
    ref_model.load_state_dict(model.state_dict())
    ref = Embedder(ref_model, tok, num_frames=4, input_res=224, pre_size=256)
    ref_out = ref.embed_frames(clips[:16])
    c_ref = min(cos(a, b) for a, b in zip(outs[16], ref_out))
    print(f"kernels vs plain attention, full model: min cos {c_ref:.6f}",
          flush=True)
    check(c_ref >= 0.999, "kernel path disagrees with the plain path")
    del ref, ref_model

    lat = {}
    for n in (1, 4, 16):
        for kind, fn in (("video", lambda: emb.embed_frames(clips[:n])),
                         ("text", lambda: emb.embed_texts((TEXTS * 6)[:n]))):
            fn()
            ts = []
            for _ in range(7):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            lat[f"{kind}_b{n}_ms"] = statistics.median(ts)
    for n in (1, 4, 16):
        v = lat[f"video_b{n}_ms"]
        print(f"latency bucket {n}: embed_frames {v:.2f} ms "
              f"({n / v * 1e3:.1f} clips/s), embed_texts "
              f"{lat[f'text_b{n}_ms']:.2f} ms [{smi}]", flush=True)
    tmp.cleanup()
    return counts, lat


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    if not (ROOT / "egovlp_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: egovlp_tpu_torch/ not found beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi}", flush=True)

    from egovlp_tpu_torch.kernels import cuda_attention as ca
    from egovlp_tpu_torch.kernels._build import load_library

    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)

    rows = phase_kernels(ca, smi)
    counts, _ = phase_slice(ca, smi)

    kernels = [{"name": name, "route": "cuda",
                "source": f"egovlp_tpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": counts[name], **rows[name]}
               for name, replaces in KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
