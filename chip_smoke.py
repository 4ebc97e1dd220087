#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``egovlp_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which passes or raises (any failure exits non-zero):

1. device: a CUDA device must be present; prints the ``nvidia-smi`` name
   and power limit of the card;
2. build: compiles the hand-written kernels (``kernels/csrc``, one nvcc
   per source, sm_90a) and prints the build time;
3. forward kernels: K1-fwd and K2-fwd against their plain PyTorch twins
   on unit-normal inputs, float32 (max abs error <= 1e-4) and bf16
   (<= 2e-2), and every output within a relative L2 error
   ||kernel - plain|| / ||plain|| of 1e-5 (float32) or 1e-2 (bf16), at
   B 4 x (f, n) in {(4, 196), (1, 196), (16, 196), (4, 61)} and at the
   training shape B 32, f 4, n 196; then kernel, plain and library
   (``F.scaled_dot_product_attention`` on inputs already laid out) median
   times (CUDA events, 20 runs) and the bound at B 16, whose outputs are
   held to the same limits;
3b. backward kernels: K1-bwd and K2-bwd likewise, for each of dq, dk, dv,
   dcls_k and dcls_v (max abs error at float32 <= 1e-4; at bf16 <= 1e-2
   for K1-bwd, whose gradients are ~0.1 at these inputs, and <= 5e-2 for
   K2-bwd, whose are ~1-5; the same relative L2 limits); library time =
   ``torch.autograd.grad`` of the SDPA call minus its forward;
4. serving slice: the full-width dual encoder of ``configs/eval/egomcq.json``
   in bf16 with seeded random weights (time attention initialised
   non-zero, so the time kernel sees real inputs) behind ``serve()``:
   ``/healthz``, ``/embed_text`` and ``embed_frames`` on seeded uint8 clips
   for N in {1, 3, 16}.  Checks shapes, finiteness, bucket invariance, the
   kernel launch counts of that run (12 space + 12 time per tower pass),
   and the cosine of each embedding against the plain-attention model
   (``attention_impl='xla'``) on the same weights; prints latencies;
5. training slice: ``configs/pt/egoclip.json`` at full width in bf16 on
   seeded random weights (time attention random), seeded synthetic EgoClip
   batches (16 clips + 16 scene negatives = 32 a step), EgoNCE, AdamW and
   ``Trainer.train`` for 2 epochs of 3 steps with checkpoints.  Checks
   finite losses, the kernel launches of every step (12 of each, but 11 of
   K1-bwd: the last block's space-attention patch outputs reach no loss),
   the first step's loss (within 2e-2) and gradients (cosine >= 0.999 over
   all parameters, >= 0.99 for every block's ``attn.qkv.weight`` and
   ``timeattn.qkv.weight``) against the plain-attention model on the same
   weights and batch, a bit-exact resume into a fresh model and optimizer,
   and a falling loss over 4 steps on one batch; prints, over steps 2-6,
   the median time of the step function alone and the median time from
   one step's end to the next (the batch's copy to the device, the step's
   generator and the loop included) with clips/s, then a
   ``torch.profiler`` breakdown of 3 steps (device busy time by kernel,
   idle share, launches a step).

The last three lines are the ``nvidia-smi`` line, a JSON object with one
entry per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import ctypes
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
    "space_attention_bwd": "egovlp_tpu/kernels/pallas_attention.py:765",
    "time_attention_bwd": "egovlp_tpu/kernels/pallas_attention.py:1496",
}
FWD = ("space_attention_fwd", "time_attention_fwd")
BWD = ("space_attention_bwd", "time_attention_bwd")
HEADS, DIM = 12, 768
SCALE = (DIM // HEADS) ** -0.5
TIMED = (16, 4, 196)  # B, f, n of the timed bf16 calls
# NVIDIA H100 SXM data sheet: HBM bytes/s and dense bf16 tensor FLOP/s
PEAK_BYTES, PEAK_BF16_FLOPS = 3.35e12, 989e12
DEVICE = "cuda"
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


def grid_inputs(B, f, n, dtype, seed, grad=False):
    """q, k, v, cls_k, cls_v (and do when ``grad``), unit normal."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    grid = [mk(B, f, n, DIM) for _ in range(4 if grad else 3)]
    return (*grid[:3], mk(B, 1, DIM), mk(B, 1, DIM), *grid[3:])


def bound_ms(name: str, B: int, f: int, n: int, itemsize: int = 2):
    """``(ms, 'bytes' | 'operations')``: the least time of the kernel's work
    on an H100 at (B, f, n), the larger of the bytes that must move (each
    input read once, each output written once) over HBM bandwidth and its
    FLOPs over the dense bf16 tensor rate."""
    grid = B * f * n * DIM * itemsize
    cls = B * DIM * itemsize
    keys = n + 1 if name.startswith("space") else f + 1
    if name.endswith("fwd"):  # q, k, v in, out out; two products
        nbytes, products = 4 * grid + 2 * cls, 2
    else:  # q, k, v, do in, dq, dk, dv out; CLS in and CLS grads out
        nbytes, products = 7 * grid + 4 * cls, 5
    flops = 2 * products * B * f * n * keys * DIM
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def sdpa_layout(x, axis: str, grad: bool):
    """The kernel's inputs laid out for ``F.scaled_dot_product_attention``:
    space q [B*f, H, n, hd], k/v [B*f, H, n+1, hd]; time q [B*n, H, f, hd],
    k/v [B*n, H, f+1, hd]; CLS first.  (Plus do laid out as q.)"""
    import torch

    q, k, v, ck, cv = x[:5]
    B, f, n, D = q.shape
    hd = D // HEADS
    groups, rows = (B * f, n) if axis == "space" else (B * n, f)

    def heads(t):
        if axis == "time":
            t = t.permute(0, 2, 1, 3)
        return t.reshape(groups, rows, HEADS, hd).transpose(1, 2).contiguous()

    def with_cls(c, t):
        reps = f if axis == "space" else n
        c = c.reshape(B, 1, 1, HEADS, hd).expand(B, reps, 1, HEADS, hd)
        c = c.reshape(groups, 1, HEADS, hd).transpose(1, 2)
        return torch.cat([c, heads(t)], dim=2).contiguous()

    out = [heads(q), with_cls(ck, k), with_cls(cv, v)]
    if grad:
        out = [t.requires_grad_() for t in out] + [heads(x[5])]
    return out


def phase_kernels(ca, smi: str) -> dict:
    import torch
    import torch.nn.functional as F

    # max abs error; the bf16 limits are a few times the error each kernel
    # shows (1-2 bf16 ulps of its outputs), well under the error of a
    # kernel that drops a term of its gradient
    tol = {name: {torch.float32: 1e-4, torch.bfloat16: 2e-2} for name in FWD}
    tol["space_attention_bwd"] = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    tol["time_attention_bwd"] = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    rel_tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

    def check_kernel(name, x, label):
        """Runs the kernel and its plain twin on ``x``, prints and checks
        the max abs and relative L2 error of each output; returns the
        largest max abs error."""
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        got = kernel(*x, heads=HEADS, scale=SCALE)
        torch.cuda.synchronize()
        want = plain(*x, heads=HEADS, scale=SCALE)
        torch.cuda.synchronize()
        got, want = ((got,), (want,)) if name in FWD else (got, want)
        outs = ("out",) if name in FWD else ("dq", "dk", "dv", "dcls_k",
                                             "dcls_v")
        dtype = x[0].dtype
        t, t_rel = tol[name][dtype], rel_tol[dtype]
        ok, errs, detail = True, [], []
        for o, g, w in zip(outs, got, want):
            g, w = g.double(), w.double()
            err = (g - w).abs().max().item()
            rel = ((g - w).norm() / w.norm()).item()
            ok &= bool(torch.isfinite(g).all()) and err <= t and rel <= t_rel
            errs.append(err)
            detail.append(f"{o} {err:.3e}/{rel:.1e}")
        print(f"check {name} {str(dtype)[6:]} {label}: max_abs_err/rel_l2 "
              f"{' '.join(detail)} (tol {t:.0e}/{t_rel:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} disagrees with its plain version")
        return max(errs)

    for name in (*FWD, *BWD):
        for dtype in (torch.float32, torch.bfloat16):
            for B, f, n in ((4, 4, 196), (4, 1, 196), (4, 16, 196),
                            (4, 4, 61), (32, 4, 196)):
                x = grid_inputs(B, f, n, dtype, seed=f * 1000 + n + B,
                                grad=name in BWD)
                check_kernel(name, x, f"B{B} f{f} n{n}")
                del x

    rows = {}
    B, f, n = TIMED
    for name in KERNELS:
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        axis = name.split("_")[0]
        x = grid_inputs(B, f, n, torch.bfloat16, seed=B,
                        grad=name in BWD)
        t_plain = median_ms(lambda: plain(*x, heads=HEADS, scale=SCALE))
        t_kernel = median_ms(lambda: kernel(*x, heads=HEADS, scale=SCALE))
        lay = sdpa_layout(x, axis, grad=name in BWD)

        def sdpa():
            return F.scaled_dot_product_attention(*lay[:3], scale=SCALE)

        t_lib = median_ms(sdpa)
        if name in BWD:
            def sdpa_grad():
                return torch.autograd.grad(sdpa(), lay[:3], lay[3])

            t_lib = median_ms(sdpa_grad) - t_lib
        err = check_kernel(name, x, f"B{B} f{f} n{n} (timed inputs)")
        bound, bound_by = bound_ms(name, B, f, n)
        print(f"time {name} bf16 B{B} f{f} n{n}: kernel {t_kernel:.4f} ms, "
              f"plain {t_plain:.4f} ms, library {t_lib:.4f} ms, bound "
              f"{bound:.4f} ms [{smi}]", flush=True)
        rows[name] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
                      "bound_ms": bound, "bound_by": bound_by,
                      "max_abs_err": err, "dtype": "bfloat16",
                      "shape": [B, f, n, DIM]}
        del x, lay
    for dtype, B in ((torch.bfloat16, 4), (torch.float32, 4)):
        for name in FWD:
            kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
            x = grid_inputs(B, 4, 196, dtype, seed=B)
            t_plain = median_ms(lambda: plain(*x, heads=HEADS, scale=SCALE))
            t_kernel = median_ms(lambda: kernel(*x, heads=HEADS, scale=SCALE))
            print(f"time {name} {str(dtype)[6:]} B{B} f4 n196: kernel "
                  f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms [{smi}]",
                  flush=True)
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
        want = 12 * passes if name in FWD else 0
        check(counts[name] == want,
              f"{name}: {counts[name]} launches, expected {want}")
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


def egoclip_batch(rng, B=16, S=30):
    """A seeded batch shaped as the EgoClip collation (noun dim 582, verb
    dim 118) with scene negatives: uint8 frames, [CLS] words [SEP] ids over
    the 16-word vocabulary, and 0/1 noun/verb vectors drawn from a few
    classes, so that several rows share a verb and a noun."""
    batch = {}
    for suffix in ("", "_neg"):
        batch["frames" + suffix] = rng.integers(
            0, 256, (B, 4, 256, 256, 3), dtype=np.uint8)
        ids = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.int32)
        for i, n in enumerate(rng.integers(3, 12, B)):
            ids[i, :n + 2] = [2, *rng.integers(4, len(VOCAB), n), 3]
            mask[i, :n + 2] = 1
        name = "text_neg" if suffix else "text"
        batch[f"{name}_ids"], batch[f"{name}_mask"] = ids, mask
        for key, dim, classes in (("noun_vec", 582, 4), ("verb_vec", 118, 3)):
            vec = np.zeros((B, dim), np.float32)
            vec[np.arange(B), rng.integers(0, classes, B)] = 1.0
            vec[np.arange(B), rng.integers(0, dim, B)] = 1.0
            batch[key + suffix] = vec
    return batch


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def phase_train(ca, smi: str) -> dict:
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.io.checkpoints import CheckpointManager
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train.recipes import make_train_epoch_fn, to_device
    from egovlp_tpu_torch.train.state import make_optimizer
    from egovlp_tpu_torch.train.steps import make_egoclip_train_step
    from egovlp_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = load_config(str(ROOT / "configs/pt/egoclip.json"))
    # non-zero time attention (see phase_slice)
    config.override("arch.args.video_params.time_init", "random")
    arch = config["arch"]
    steps_per_epoch, epochs = 3, 2
    opt_args = config["optimizer"]["args"]
    sched = dict(base_lr=float(opt_args["lr"]),
                 milestones=tuple(config["trainer"]["lr_milestones"]),
                 steps_per_epoch=steps_per_epoch)
    loss_args = config["loss"]["args"]
    step = make_egoclip_train_step(
        loss_type=config["loss"]["type"],
        input_res=config["data_loader"]["args"]["video_params"]["input_res"],
        temperature=float(loss_args.get("temperature", 0.05)))

    def fresh_model(seed):
        model, cfg = build.build_model(arch, DEVICE)
        build.init_params(model, seed=seed)
        return model, cfg

    model, cfg = fresh_model(0)
    check(model.video_model.dtype == torch.bfloat16, "compute dtype not bf16")
    check(cfg.video.embed_dim == DIM and cfg.video.depth == 12
          and cfg.text.n_layers == 6 and cfg.projection_dim == 256,
          f"not the full-width model: {cfg}")
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    fixed = to_device(egoclip_batch(rng), DEVICE)

    # ---- first-step loss and gradients vs the plain-attention model ----
    class NoUpdate:  # keeps the gradients the step computed
        def __init__(self, m):
            self.m = m

        def zero_grad(self, set_to_none=True):
            self.m.zero_grad(set_to_none=set_to_none)

        def step(self):
            pass

    def loss_and_grads(m):
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        loss = step(m, NoUpdate(m), fixed, gen).item()
        return loss, {k: p.grad.float() for k, p in m.named_parameters()}

    loss_k, grads_k = loss_and_grads(model)
    xla_arch = copy.deepcopy(arch)
    xla_arch["args"]["video_params"]["attention_impl"] = "xla"
    ref, _ = build.build_model(xla_arch, DEVICE)
    ref.load_state_dict(initial)
    loss_x, grads_x = loss_and_grads(ref)
    del ref
    model.zero_grad(set_to_none=True)
    names = sorted(grads_k)
    c_all = cosine(torch.cat([grads_k[k].flatten() for k in names]),
                   torch.cat([grads_x[k].flatten() for k in names]))
    c_qkv = min(cosine(grads_k[k], grads_x[k]) for k in names
                if k.endswith(("attn.qkv.weight", "timeattn.qkv.weight"))
                and k.startswith("video_model.blocks."))
    print(f"first step vs plain attention: loss {loss_k:.6f} vs {loss_x:.6f}, "
          f"grad cosine all {c_all:.6f}, min qkv {c_qkv:.6f}", flush=True)
    check(abs(loss_k - loss_x) <= 2e-2, "loss disagrees with the plain path")
    check(c_all >= 0.999, "gradients disagree with the plain path")
    check(c_qkv >= 0.99, "a block's qkv gradient disagrees with the plain path")
    del grads_k, grads_x

    # ---- the main path: Trainer.train, counted --------------------------
    batches = [egoclip_batch(rng) for _ in range(steps_per_epoch)]
    losses, times, ends = [], [], []

    def timed_step(m, opt, batch, gen):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(m, opt, batch, gen)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        times.append((ends[-1] - t0) * 1e3)
        losses.append(loss)
        return loss

    opt, _ = make_optimizer(model, **sched)
    tmp = tempfile.TemporaryDirectory()
    trainer = Trainer(
        TrainerConfig(epochs=epochs, save_period=1, monitor="min loss_0",
                      save_dir=tmp.name),
        make_train_epoch_fn([batches], timed_step, DEVICE, seed=0))
    ca.reset_launch_counts()
    trainer.train(model, opt)
    counts = dict(ca.launches)
    # ------------------------------------------------------------------------
    n_steps = epochs * steps_per_epoch
    print(f"training launches over {n_steps} steps: {counts}", flush=True)
    # 12 blocks: every block runs both forward kernels and the time
    # backward; the last block's space-attention patch outputs reach no
    # loss (the tower returns the CLS token), so autograd skips that
    # block's space backward: 11 a step
    per_step = {name: 12 for name in KERNELS}
    per_step["space_attention_bwd"] = 11
    for name in KERNELS:
        check(counts[name] == per_step[name] * n_steps,
              f"{name}: {counts[name]} launches, expected "
              f"{per_step[name] * n_steps}")
    values = [float(v) for v in losses]
    print(f"training losses: {[round(v, 5) for v in values]}", flush=True)
    check(len(values) == n_steps and all(np.isfinite(values)),
          "a training loss is not finite")
    step_ms = statistics.median(times[1:6])
    # step i's end to step i+1's end: the epoch function's copy of the batch
    # to the device, the step's generator and the loop; the one interval
    # that holds the epoch boundary (checkpoint) is dropped by the median
    loop_ms = statistics.median(np.diff(ends[:6]) * 1e3)
    print(f"train step (32 clips: 16 + 16 scene negatives), median over "
          f"steps 2-6: step function {step_ms:.2f} ms "
          f"({32 / step_ms * 1e3:.1f} clips/s); loop, end to end "
          f"{loop_ms:.2f} ms ({32 / loop_ms * 1e3:.1f} clips/s) [{smi}]",
          flush=True)

    # ---- resume into a fresh model and optimizer: bit-exact -------------
    fresh, _ = fresh_model(1)
    fresh_opt, _ = make_optimizer(fresh, **sched)
    payload = CheckpointManager(tmp.name).restore(fresh, fresh_opt)
    check(payload["epoch"] == epochs and payload["step"] == n_steps,
          f"resumed epoch {payload['epoch']} step {payload['step']}")
    sd, fsd = model.state_dict(), fresh.state_dict()
    check(all(torch.equal(sd[k], fsd[k]) for k in sd), "resumed weights differ")
    check(fresh_opt.param_groups[0]["count"] == n_steps, "resumed count")
    check(all(torch.equal(opt.state[p][s], fresh_opt.state[q][s])
              for p, q in zip(model.parameters(), fresh.parameters())
              for s in ("mu", "nu")), "resumed optimizer state differs")
    print(f"resume: {len(sd)} tensors and the optimizer state bit-equal",
          flush=True)
    del model, opt
    tmp.cleanup()

    # ---- 4 steps on one batch lower its loss ----------------------------
    same = [step(fresh, fresh_opt, fixed,
                 torch.Generator(device=DEVICE).manual_seed(1)).item()
            for _ in range(4)]
    print(f"4 steps on one batch: losses {[round(v, 5) for v in same]}",
          flush=True)
    check(same[-1] < same[0], "the loss on a repeated batch did not fall")

    profile_steps(fresh, fresh_opt, step, batches, smi)
    return counts


def profile_steps(model, opt, step, batches, smi: str, n: int = 3) -> None:
    """Device busy time by kernel, idle share and launches a step over ``n``
    training steps (``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from egovlp_tpu_torch.train.recipes import step_generator, to_device

    batches = [to_device(b, DEVICE) for b in batches]
    step(model, opt, batches[0], step_generator(DEVICE, 1, 1, 0))  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            step(model, opt, batches[i % len(batches)],
                 step_generator(DEVICE, 1, 2, i))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    # kernels only: spans of annotated host regions (Optimizer.step, ...)
    # also show on the device timeline and would count twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    launches = sum(e.count for e in rows) / n
    print(f"profile: wall {wall:.2f} ms/step, device busy {busy:.2f} ms/step, "
          f"idle share {1 - busy / wall:.3f}, kernels {launches:.0f}/step "
          f"[{smi}]", flush=True)
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:15]:
        print(f"profile kernel {e.self_device_time_total / 1e3 / n:9.3f} "
              f"ms/step {e.count / n:6.0f}x  {e.key[:90]}", flush=True)


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
    lib = load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for f in (1, 4, 16):  # the time kernels' launch configuration
        threads = ctypes.c_int()
        rc = lib.egovlp_time_attention_fwd_threads(
            f, DIM, HEADS, torch.cuda.current_device(), ctypes.byref(threads))
        check(rc == 0, f"time_attention_fwd launch refused at f {f}: {rc}")
        print(f"launch time_attention_fwd f{f} D{DIM} H{HEADS}: "
              f"{threads.value} threads a CTA [{smi}]", flush=True)

    rows = phase_kernels(ca, smi)
    serve_counts, _ = phase_slice(ca, smi)
    torch.cuda.empty_cache()
    train_counts = phase_train(ca, smi)

    kernels = [{"name": name, "route": "cuda",
                "source": f"egovlp_tpu_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": train_counts[name],
                "launches_by_path": {"serving": serve_counts[name],
                                     "training": train_counts[name]},
                **rows[name]}
               for name, replaces in KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
