#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``egovlp_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which passes or raises (any failure exits non-zero):

1. device: a CUDA device must be present; prints the ``nvidia-smi`` name
   and power limit of the card;
2. build: compiles the hand-written kernels (``kernels/csrc``, one nvcc
   per source, sm_90a) and prints the build time; prints the registers a
   thread, local (spill) bytes a thread and shared memory of the bf16
   tensor-core kernels (K1-fwd, K4-fwd, K1-bwd, K4-bwd) at L 196 and 255,
   hd 64, and of the K2 and K5 streaming instantiations (forward and
   backward, bf16 and float32) at f 4 and 16, and fails if an L 196 or a
   bf16 f 4 instantiation (the main path's) spills;
3. forward kernels: K1-fwd and K2-fwd against their plain PyTorch twins
   on unit-normal inputs, float32 (max abs error <= 1e-4) and bf16
   (<= 2e-2), and every output within a relative L2 error
   ||kernel - plain|| / ||plain|| of 1e-5 (float32) or 1e-3 (bf16: the
   tensor-core kernels K1 and K4 round bf16 where their twins do, and K2,
   like its twin, computes in float32 and casts once, so a kernel
   rounding at another point fails), at B 4 x (f, n) in {(4, 196), (1,
   196), (16, 196), (8, 61), (4, 61), (2, 255)} (n 255: the most keys the
   bf16 tensor-core kernels take; forward, and the backward at bf16) and
   at the training shape B 32, f 4, n 196; a bf16 launch of a tensor-core kernel at L 256 (257 keys) must
   raise; then kernel, plain and library
   (``F.scaled_dot_product_attention`` on inputs already laid out) median
   times (CUDA events, 20 runs, the launch path included), the kernel's
   own device time (``torch.profiler``, mean of 20 launches) and the bound
   at B 16, whose outputs are held to the same limits;
3b. backward kernels: K1-bwd and K2-bwd likewise, for each of dq, dk, dv,
   dcls_k and dcls_v (max abs error at float32 <= 1e-4; at bf16 <= 1e-2
   for K1-bwd, whose gradients are ~0.1 at these inputs, and <= 5e-2 for
   K2-bwd, whose are ~1-5; the same relative L2 limits); two K2-bwd
   launches on the timed inputs must give the same bits; library time =
   ``torch.autograd.grad`` of the SDPA call minus its forward;
   then the head-split kernels K4 (``grouped_attention``) and K5
   (``time_attention_hs``), forward and backward, against their plain
   twins on unit-normal inputs with q already scaled by hd ** -0.5, float32
   and bf16: K4 ``[BH, G, L, 64]`` at L in {1, 4, 16, 61, 196} and G from 1
   to 196 (and L 255, forward and bf16 backward), K5 ``[BH, f, n, 64]``
   at f in {1, 4, 8, 16} on its streaming body and f 20 on its scalar
   body (n 196, 197 and 61: ragged blocks of 4 columns), and the
   full-width shapes of phase 6 (BH 384); max
   abs error at float32 <= 1e-4 (forward) and 2e-4 (backward), at bf16
   <= 2e-2 (K4-fwd, as K1-fwd) and 4e-2 (K5-fwd: 2 to 5 keys, so outputs
   up to ~5, where one ulp is 3.1e-2), and 2.5e-1 (backward: their dq is
   not multiplied by the scale, so gradients reach ~30, where one ulp is
   1.25e-1); the same relative L2 limits (1e-3 at bf16 for K5, both
   bodies); timed at ``[192, 4, 196, 64]`` bf16 (B 16 x 12 heads), the
   library call being SDPA with one head a group and scale 1; two K5-bwd
   launches on the timed inputs must give the same bits; each timed K5
   call prints the body it ran on (the streaming body there), and K5's
   scalar body is held and timed at the timed shape with q one element off
   a 16-byte boundary (the same work) and at f 17;
   the times of the kernels redesigned since their first scalar bodies
   (the four tensor-core kernels and the K2 and K5 streaming kernels) are
   printed beside their scalar bodies' times from ``PERF.md``, SDPA and
   the bound;
4. serving slice: the full-width dual encoder of ``configs/eval/egomcq.json``
   in bf16 with seeded random weights (time attention initialised
   non-zero, so the time kernel sees real inputs) behind ``serve()``:
   ``/healthz``, ``/embed_text`` and ``embed_frames`` on seeded uint8 clips
   for N in {1, 3, 16}.  Checks shapes, finiteness, bucket invariance, the
   kernel launch counts of that run (12 space + 12 time per tower pass),
   and the cosine of each embedding against the plain-attention model
   (``attention_impl='xla'``) on the same weights; prints latencies and a
   ``torch.profiler`` breakdown of 3 bucket-16 ``embed_frames`` calls;
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
   idle share, launches a step);
6. head-split op: ``divided_attention(impl='pallas')`` forward and
   backward (``autograd.grad`` of ``sum(out * cos(out))``) at the EgoVLP
   pretraining shape in bf16, B 32, H 12, n 196, hd 64, on the space axis
   at f 4 and the time axis at f 4 and 16 (S 785 and 3137).  Each call
   must launch K4 (space) or K5 (time) forward and backward once each and
   no other kernel, K5 on its streaming body; its output and q/k/v
   gradients are held against ``impl='xla'`` on the same tensors and against
   ``divided_attention_bsd(impl='pallas')``, the K1/K2 route, on the
   un-split ``[B, S, D]`` form of them (max abs error within 4% of the
   largest value, relative L2 within 1e-2); prints each route's median
   forward + backward time;
7. training CLI: a synthetic EgoClip tree in a temporary directory (4
   video uids, each with two 600-s chunk files ``0.mp4`` and ``1.mp4`` of
   150 frames at 320 x 256 written with OpenCV, which the GPU machine has;
   ``egoclip.csv`` of 96 narrations, a third of whose clips cross the
   600-s chunk boundary, so that their frames come from both files;
   ``egomcq.json`` of 16 items of both types; a vocabulary).  Then, in
   this process, through the entry points a user calls:
   ``egovlp_tpu_torch.cli.train.main`` on ``configs/pt/egoclip.json`` at
   full width in bf16 (random time attention, 2 epochs of 48 samples: 3
   steps of 16 clips + 16 scene negatives, the Loader's 16 decode
   threads, strict loading, EgoMCQ validation after each epoch under
   ``max Inter-video``), then ``--resume`` of its epoch-2 checkpoint with
   ``-o trainer.epochs=3``, then ``cli.eval --checkpoint`` on that
   checkpoint, then ``configs/eval/egomcq.json`` (the eval-only preset)
   through ``cli.train`` on the same weights.  Checks: the first run
   launches K1-fwd / K2-fwd / K1-bwd / K2-bwd 12 / 12 / 11 / 12 times a
   training step plus K1-fwd and K2-fwd 12 times a validation tower pass
   (2 a validation: 16 items at 8 a batch), and K4 / K5 never; every loss
   is finite; both accuracies are present and in [0, 100];
   ``checkpoint-epoch{1,2}.pth`` exist; the resumed run trains epoch 3
   only and its optimizer count reaches 9; ``cli.eval`` and the eval-only
   preset give that checkpoint's in-run accuracies, and the preset writes
   no checkpoint.  Prints the loop's median step-end to step-end time (CUDA
   events recorded after each step, so no step waits on the host) over
   the steps after the first and its clips/s through the real Loader, the
   median time the loop waited on the Loader for a batch, and EgoMCQ
   items/s of each validation with the time it waited on its Loader;
8. DDP (``torch.distributed``, one process a GPU):
   (a) world 1 over NCCL in this process: torchrun's environment,
   ``core.dist.init_distributed``, then phase 5's weights and 3 batches
   (32 clips a step) through ``recipes.data_parallel`` (the
   ``DistributedDataParallel`` wrapper ``run_task`` uses) and the epoch
   function.  Checks: the losses and the parameters after step 3 equal
   phase 5's Trainer run bit for bit (DDP at world 1 copies gradients
   through its buckets and divides by 1), every parameter got a
   gradient, launches 12 / 12 / 11 / 12 a step; then 12 more steps each
   of the DDP-wrapped model and an unwrapped copy, in turns, and prints
   both medians (their difference is DDP's own cost at world 1) beside
   phase 5's step function.  (b) world 2 over gloo, two spawned ranks on GPU 0 (NCCL refuses
   two ranks on one device), each ``chip_smoke.py --ddp-worker`` with its
   own time limit and exit code: each rank takes 8 clips of each of phase
   5's batches (16 rows with their negatives; the global batch is phase
   5's 32 rows), 3 steps through DDP, the checkpoint (rank 0 writes, both
   wait), then ``cli.eval`` on its shard of phase 7's tree at a tiny depth
   (2 video blocks, 2 text layers, full width, 4 items a batch).  Checks:
   the two ranks' losses are identical; against one process on the whole
   batch, the first step's loss within 5e-3 (measured 2.7e-4), its
   DDP-averaged gradient at cosine >= 0.999 (measured 0.99977) and norm
   ratio within 1e-2 (measured 0.99907; a 1/N gradient reads 0.5), the
   parameters' update after 3 steps at cosine >= 0.99 (measured 0.99545:
   AdamW's sign-like first steps lift bf16 noise on small gradients); the
   checkpoint loads strictly into a one-process model; both ranks' EgoMCQ
   accuracies equal one process's (every batch has one process's shapes).
   Launches 12 / 12 / 11 / 12 a step on each rank.  Measured on NVIDIA
   H100 80GB HBM3, 700 W; bf16 throughout.

The last three lines are the ``nvidia-smi`` line, a JSON object with one
entry per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import logging
import os
import socket
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
# the head-split kernels (q already scaled), reached by divided_attention
HS_KERNELS = {
    "grouped_attention_fwd": "egovlp_tpu/kernels/pallas_attention.py:112",
    "grouped_attention_bwd": "egovlp_tpu/kernels/pallas_attention.py:130",
    "time_attention_hs_fwd": "egovlp_tpu/kernels/pallas_attention.py:265",
    "time_attention_hs_bwd": "egovlp_tpu/kernels/pallas_attention.py:278",
}
# the bf16 kernels that run on the tensor cores, and the time their scalar
# CUDA-core bodies took at the timed shapes, by this script's median_ms
# (PERF.md section 6: NVIDIA H100 80GB HBM3, 700 W), printed beside the
# new times
TENSOR_CORE = {"space_attention_fwd": 1.1665,
               "grouped_attention_fwd": 1.1826,
               "space_attention_bwd": 2.8054,
               "grouped_attention_bwd": 2.8622}
# the 16-byte streaming bodies (both dtypes) of K2 and K5, and their
# scalar bodies' times, likewise
STREAMING = {"time_attention_fwd": 0.1427, "time_attention_bwd": 0.2867,
             "time_attention_hs_fwd": 0.1536, "time_attention_hs_bwd": 0.3708}
# each kernel's body header beside its .cu (kernels/csrc)
BODIES = {"space_attention_fwd": "attention_fwd_mma.cuh",
          "grouped_attention_fwd": "attention_fwd_mma.cuh",
          "space_attention_bwd": "attention_bwd_mma.cuh",
          "grouped_attention_bwd": "attention_bwd_mma.cuh",
          **dict.fromkeys(STREAMING, "time_attention_stream.cuh")}
REDESIGNED = {**TENSOR_CORE, **STREAMING}
FWD = ("space_attention_fwd", "time_attention_fwd")
BWD = ("space_attention_bwd", "time_attention_bwd")
HEADS, DIM = 12, 768
HD = DIM // HEADS
SCALE = HD ** -0.5
TIMED = (16, 4, 196)  # B, f, n of the timed bf16 calls
# NVIDIA H100 SXM data sheet: HBM bytes/s and dense bf16 tensor FLOP/s
PEAK_BYTES, PEAK_BF16_FLOPS = 3.35e12, 989e12
DEVICE = "cuda"
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "person", "cuts", "an",
         "onion", "opens", "the", "door", "picks", "up", "knife", "##s"]
TEXTS = ["a person cuts an onion", "opens the door", "picks up the knife"]
# phase 7: the synthetic EgoClip tree's vocabulary, verbs and nouns
CLI_VOCAB = VOCAB + ["#", "c", "moves", "holds", "box", "cup", "table"]
CLI_VERBS = ["opens", "cuts", "picks", "moves", "holds"]
CLI_NOUNS = ["door", "onion", "knife", "box", "cup", "table"]


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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The device time of the repository's own kernels that ``fn()``
    launches (``torch.profiler``: kernels in the ``egovlp`` namespace, not
    PyTorch's), per call, mean over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiler session now and then returns no device events (seen once
    # in some 20 sessions on the H100): up to three sessions
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "egovlp" in e.key)
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("three profiler sessions saw no kernel of the "
                       "repository")


def misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    import torch

    flat = torch.empty(t.numel() + 8, device=t.device, dtype=t.dtype)
    out = flat[1:1 + t.numel()].view(t.shape).copy_(t)
    check(out.data_ptr() % 16 != 0, "misaligned copy is aligned")
    return out


@contextlib.contextmanager
def recorded_bodies(ca):
    """The K5 bodies ``ca.time_hs_body`` picks inside the block, in order
    (names: ``'streaming'`` or ``'scalar'``)."""
    route, bodies = ca.time_hs_body, []

    def record(*tensors):
        body = route(*tensors)
        bodies.append(body_name(ca, body))
        return body

    ca.time_hs_body = record
    try:
        yield bodies
    finally:
        ca.time_hs_body = route


def body_name(ca, body: int) -> str:
    return {ca.TIME_HS_STREAM: "streaming", ca.TIME_HS_SCALAR: "scalar"}[body]


def grid_inputs(B, f, n, dtype, seed, grad=False):
    """q, k, v, cls_k, cls_v (and do when ``grad``), unit normal."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    grid = [mk(B, f, n, DIM) for _ in range(4 if grad else 3)]
    return (*grid[:3], mk(B, 1, DIM), mk(B, 1, DIM), *grid[3:])


def hs_inputs(BH, f, n, dtype, seed, grad=False):
    """Head-split q, k, v ``[BH, f, n, hd]`` (q already scaled by
    ``hd ** -0.5``), cls_k, cls_v ``[BH, 1, hd]`` (and do), unit normal."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    grid = [mk(BH, f, n, HD) for _ in range(4 if grad else 3)]
    grid[0] = grid[0] * SCALE
    x = (*grid[:3], mk(BH, 1, HD), mk(BH, 1, HD), *grid[3:])
    return tuple(t.to(dtype) for t in x)


def bound_ms(name: str, B: int, f: int, n: int, D: int = DIM,
             itemsize: int = 2):
    """``(ms, 'bytes' | 'operations')``: the least time of the kernel's work
    on an H100 on ``[B, f, n, D]`` inputs (K4/K5: B = batch x heads, D =
    hd), the larger of the bytes that must move (each input read once, each
    output written once) over HBM bandwidth and its FLOPs over the dense
    bf16 tensor rate."""
    grid = B * f * n * D * itemsize
    cls = B * D * itemsize
    keys = n + 1 if name.startswith(("space", "grouped")) else f + 1
    if name.endswith("fwd"):  # q, k, v in, out out; two products
        nbytes, products = 4 * grid + 2 * cls, 2
    else:  # q, k, v, do in, dq, dk, dv out; CLS in and CLS grads out
        nbytes, products = 7 * grid + 4 * cls, 5
    flops = 2 * products * B * f * n * keys * D
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


def sdpa_hs_layout(name, x, grad: bool):
    """A head-split kernel's inputs laid out for SDPA, one head a group:
    K4 q ``[BH*G, 1, L, hd]``, k/v ``[BH*G, 1, L+1, hd]``; K5 q
    ``[BH*n, 1, f, hd]``, k/v ``[BH*n, 1, f+1, hd]``; CLS first.  (Plus do
    laid out as q.)"""
    import torch

    q, k, v, ck, cv = x[:5]
    BH, a, b, hd = q.shape
    grouped = name.startswith("grouped")
    groups, rows, reps = (BH * a, b, a) if grouped else (BH * b, a, b)

    def lay(t):
        t = t if grouped else t.permute(0, 2, 1, 3)
        return t.reshape(groups, 1, rows, hd).contiguous()

    def with_cls(c, t):
        c = c.reshape(BH, 1, 1, hd).expand(BH, reps, 1, hd)
        return torch.cat([c.reshape(groups, 1, 1, hd), lay(t)], dim=2)

    out = [lay(q), with_cls(ck, k), with_cls(cv, v)]
    if grad:
        out = [t.requires_grad_() for t in out] + [lay(x[5])]
    return out


def phase_kernels(ca, smi: str) -> dict:
    import torch
    import torch.nn.functional as F

    # max abs error; the bf16 limits are a few times the error each kernel
    # shows (1-2 bf16 ulps of its outputs), well under the error of a
    # kernel that drops a term of its gradient.  The head-split kernels
    # take q already scaled, so their logits are as large as K1/K2's but
    # their dq is not multiplied by the scale: their gradients run ~8x
    # larger (up to ~30), and so do their limits.
    tol = {name: {torch.float32: 1e-4, torch.bfloat16: 2e-2} for name in FWD}
    tol["space_attention_bwd"] = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    tol["time_attention_bwd"] = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    tol["grouped_attention_fwd"] = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    tol["time_attention_hs_fwd"] = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
    tol["grouped_attention_bwd"] = {torch.float32: 2e-4, torch.bfloat16: 2.5e-1}
    tol["time_attention_hs_bwd"] = {torch.float32: 2e-4, torch.bfloat16: 2.5e-1}
    rel_tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
    # the tensor-core kernels round bf16 at their twins' points and read
    # ~1e-4 of them; a kernel rounding q * scale and taking exp, as K1 once
    # did, or a K4-bwd taking dV from round(p), reads 2e-3 to 4e-3.  K2
    # computes in float32 and casts once, as its twin does
    rel_tol_rounding = dict.fromkeys(REDESIGNED, 1e-3)

    def call(fn, name, x):
        if name in HS_KERNELS:
            return fn(*x)
        return fn(*x, heads=HEADS, scale=SCALE)

    def check_kernel(name, x, label):
        """Runs the kernel and its plain twin on ``x``, prints and checks
        the max abs and relative L2 error of each output; returns the
        largest max abs error."""
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        got = call(kernel, name, x)
        torch.cuda.synchronize()
        want = call(plain, name, x)
        torch.cuda.synchronize()
        fwd = name.endswith("fwd")
        got, want = ((got,), (want,)) if fwd else (got, want)
        outs = ("out",) if fwd else ("dq", "dk", "dv", "dcls_k", "dcls_v")
        dtype = x[0].dtype
        t, t_rel = tol[name][dtype], rel_tol[dtype]
        if dtype == torch.bfloat16:
            t_rel = rel_tol_rounding.get(name, t_rel)
        ok, errs, detail = True, [], []
        for o, g, w in zip(outs, got, want):
            g, w = g.double(), w.double()
            err = (g - w).abs().max().item()
            rel = ((g - w).norm() / w.norm()).item()
            ok &= bool(torch.isfinite(g).all()) and err <= t and rel <= t_rel
            errs.append(err)
            detail.append(f"{o} {err:.3e}/{rel:.1e}")
        print(f"check {name} {str(dtype)[6:]} {label}: max_abs_err/rel_l2 "
              f"{' '.join(detail)} (tol {t:.2g}/{t_rel:.0e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} disagrees with its plain version")
        return max(errs)

    for name in (*FWD, *BWD):
        shapes = [(4, 4, 196), (4, 1, 196), (4, 16, 196), (4, 8, 61),
                  (4, 4, 61), (32, 4, 196)]
        for dtype in (torch.float32, torch.bfloat16):
            # 256 keys: the most the bf16 tensor-core kernels take (the
            # float32 K1-bwd's buffers pass the shared-memory limit there)
            edge = ([(4, 2, 255)] if name in FWD or dtype == torch.bfloat16
                    else [])
            for B, f, n in shapes + edge:
                x = grid_inputs(B, f, n, dtype, seed=f * 1000 + n + B,
                                grad=name in BWD)
                check_kernel(name, x, f"B{B} f{f} n{n}")
                del x
    # K4 [BH, G, L, hd]: L in {1, 4, 16, 61, 196}, G from 1 to 196 (L 4,
    # G 196 is the time-shaped group); K5 [BH, f, n, hd] at f 1, 4, 8, 16
    # (streaming body; n 197 and 61 leave a ragged block of 4 columns) and
    # f 20 (scalar body); then the full-width shapes of phase 6 (B 32 x 12
    # heads)
    hs_shapes = {"grouped": ((48, 4, 196), (48, 1, 196), (48, 196, 4),
                             (24, 7, 61), (24, 5, 16), (24, 3, 1),
                             (384, 4, 196)),
                 "time": ((48, 1, 196), (48, 4, 196), (48, 16, 196),
                          (24, 4, 61), (24, 8, 197), (24, 20, 61),
                          (384, 4, 196), (384, 16, 196))}
    hs_edge_shapes = {"grouped": ((24, 3, 255),), "time": ()}
    for name in HS_KERNELS:
        kind = name.split("_")[0]
        for dtype in (torch.float32, torch.bfloat16):
            edge = (hs_edge_shapes[kind] if name.endswith("fwd")
                    or dtype == torch.bfloat16 else ())
            for BH, a, b in hs_shapes[kind] + edge:
                x = hs_inputs(BH, a, b, dtype, seed=a * 1000 + b + BH,
                              grad=name.endswith("bwd"))
                body = (f" {body_name(ca, ca.time_hs_body(*x))} body"
                        if kind == "time" else "")
                check_kernel(name, x, f"BH{BH} {a}x{b} hd{HD}{body}")
                del x
    # past 256 keys the bf16 tensor-core kernels refuse the launch
    for name in TENSOR_CORE:
        bwd = name.endswith("bwd")
        x = (hs_inputs(24, 2, 256, torch.bfloat16, seed=256, grad=bwd)
             if name in HS_KERNELS
             else grid_inputs(2, 2, 256, torch.bfloat16, seed=256, grad=bwd))
        try:
            call(getattr(ca, name), name, x)
        except RuntimeError as e:
            print(f"check {name} bf16 L256 (257 keys): raises ({e}) ok",
                  flush=True)
        else:
            raise RuntimeError(f"{name} took L 256 (257 keys) at bf16")
        del x

    rows = {}
    B, f, n = TIMED
    for name in (*KERNELS, *HS_KERNELS):
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        bwd = name.endswith("bwd")
        if name in HS_KERNELS:  # [B * H, f, n, hd]
            x = hs_inputs(B * HEADS, f, n, torch.bfloat16, seed=B, grad=bwd)
            lay = sdpa_hs_layout(name, x, grad=bwd)
            scale, shape, label = 1.0, [B * HEADS, f, n, HD], f"BH{B * HEADS}"
            bound, bound_by = bound_ms(name, B * HEADS, f, n, D=HD)
        else:
            x = grid_inputs(B, f, n, torch.bfloat16, seed=B, grad=bwd)
            lay = sdpa_layout(x, name.split("_")[0], grad=bwd)
            scale, shape, label = SCALE, [B, f, n, DIM], f"B{B}"
            bound, bound_by = bound_ms(name, B, f, n)
        t_plain = median_ms(lambda: call(plain, name, x))
        t_kernel = median_ms(lambda: call(kernel, name, x))
        t_device = device_ms(lambda: call(kernel, name, x))

        def sdpa():
            return F.scaled_dot_product_attention(*lay[:3], scale=scale)

        t_lib = median_ms(sdpa)
        if bwd:
            def sdpa_grad():
                return torch.autograd.grad(sdpa(), lay[:3], lay[3])

            t_lib = median_ms(sdpa_grad) - t_lib
        err = check_kernel(name, x, f"{label} f{f} n{n} (timed inputs)")
        if name in STREAMING and name in HS_KERNELS:
            body = body_name(ca, ca.time_hs_body(*x))
            print(f"body {name} bf16 {label} f{f} n{n}: {body}", flush=True)
            check(body == "streaming", f"{name} timed on the {body} body")
        if name in ("time_attention_bwd", "time_attention_hs_bwd"):
            # fixed summation order, no atomics: the same bits twice
            again = [call(kernel, name, x) for _ in range(2)]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(*again))
            print(f"check {name} bf16 {label} f{f} n{n}: two launches "
                  f"{'give the same bits' if same else 'DIFFER'}", flush=True)
            check(same, f"{name} is not deterministic")
            del again
        print(f"time {name} bf16 {label} f{f} n{n}: kernel {t_kernel:.4f} ms "
              f"(device {t_device:.4f} ms), plain {t_plain:.4f} ms, library "
              f"{t_lib:.4f} ms, bound {bound:.4f} ms [{smi}]", flush=True)
        if name in REDESIGNED:
            print(f"redesigned {name} bf16 {label} f{f} n{n}: "
                  f"{t_kernel:.4f} ms, device {t_device:.4f} ms (scalar "
                  f"body {REDESIGNED[name]:.4f} ms in PERF.md), SDPA "
                  f"{t_lib:.4f} ms ({t_kernel / t_lib:.2f}x SDPA), bound "
                  f"{bound:.4f} ms ({bound / t_kernel:.1%} of the event "
                  f"time, {bound / t_device:.1%} of the device time) "
                  f"[{smi}]", flush=True)
        rows[name] = {"ms": t_kernel, "device_ms": t_device,
                      "plain_ms": t_plain, "library_ms": t_lib,
                      "bound_ms": bound, "bound_by": bound_by,
                      "max_abs_err": err, "dtype": "bfloat16", "shape": shape}
        del x, lay
    # K5's scalar body, the route of the shapes the streaming body does not
    # take: at the timed shape with q one element off a 16-byte boundary
    # (the same work as the streaming rows above), and at f 17
    for name in ("time_attention_hs_fwd", "time_attention_hs_bwd"):
        kernel, bwd = getattr(ca, name), name.endswith("bwd")
        rows[name]["scalar_body"] = []
        for ff, off in ((f, True), (17, False)):
            x = list(hs_inputs(B * HEADS, ff, n, torch.bfloat16, seed=B + ff,
                               grad=bwd))
            if off:
                x[0] = misaligned(x[0])
            body = body_name(ca, ca.time_hs_body(*x))
            label = (f"BH{B * HEADS} f{ff} n{n}"
                     + (" q off 16 bytes" if off else ""))
            check(body == "scalar", f"{name} {label}: {body} body")
            err = check_kernel(name, x, f"{label} {body} body")
            t_kernel = median_ms(lambda: kernel(*x))
            t_device = device_ms(lambda: kernel(*x))
            bound, _ = bound_ms(name, B * HEADS, ff, n, D=HD)
            print(f"time {name} bf16 {label}: {body} body, kernel "
                  f"{t_kernel:.4f} ms (device {t_device:.4f} ms), bound "
                  f"{bound:.4f} ms; the streaming body at f{f}: "
                  f"{rows[name]['ms']:.4f} ms (device "
                  f"{rows[name]['device_ms']:.4f} ms) [{smi}]", flush=True)
            rows[name]["scalar_body"].append({
                "shape": [B * HEADS, ff, n, HD], "q_off_16_bytes": off,
                "ms": t_kernel, "device_ms": t_device, "bound_ms": bound,
                "max_abs_err": err})
            del x
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
    profile_calls("embed_frames bucket 16",
                  lambda i: emb.embed_frames(clips[:16]), smi)
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


class NoUpdate:
    """An optimizer that keeps the gradients the step computed."""

    def __init__(self, m):
        self.m = m

    def zero_grad(self, set_to_none=True):
        self.m.zero_grad(set_to_none=set_to_none)

    def step(self):
        pass


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def train_setup(steps_per_epoch: int = 3):
    """Phase 5's training set-up, shared by phase 8: the architecture of
    ``configs/pt/egoclip.json`` with random time attention, the AdamW
    schedule and the EgoClip step."""
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train.steps import make_egoclip_train_step

    config = load_config(str(ROOT / "configs/pt/egoclip.json"))
    # non-zero time attention (see phase_slice)
    config.override("arch.args.video_params.time_init", "random")
    opt_args = config["optimizer"]["args"]
    sched = dict(base_lr=float(opt_args["lr"]),
                 milestones=tuple(config["trainer"]["lr_milestones"]),
                 steps_per_epoch=steps_per_epoch)
    loss_args = config["loss"]["args"]
    step = make_egoclip_train_step(
        loss_type=config["loss"]["type"],
        input_res=config["data_loader"]["args"]["video_params"]["input_res"],
        temperature=float(loss_args.get("temperature", 0.05)))
    return config["arch"], sched, step


def phase_train(ca, smi: str) -> tuple:
    """Phase 5; returns the kernel launches of the Trainer run and what
    phase 8 holds its DDP runs to."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.io.checkpoints import CheckpointManager
    from egovlp_tpu_torch.train.recipes import make_train_epoch_fn, to_device
    from egovlp_tpu_torch.train.state import make_optimizer
    from egovlp_tpu_torch.train.trainer import Trainer, TrainerConfig

    steps_per_epoch, epochs = 3, 2
    arch, sched, step = train_setup(steps_per_epoch)

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
    # phase 8 holds the DDP runs to this run's first epoch (3 steps)
    ref = {"initial": {k: v.cpu() for k, v in initial.items()},
           "epoch1": torch.load(Path(tmp.name) / "checkpoint-epoch1.pth",
                                map_location="cpu",
                                weights_only=True)["state_dict"],
           "batches": batches, "losses": values[:steps_per_epoch],
           "step_ms": step_ms, "sched": sched}
    del model, opt, initial
    tmp.cleanup()

    # ---- 4 steps on one batch lower its loss ----------------------------
    same = [step(fresh, fresh_opt, fixed,
                 torch.Generator(device=DEVICE).manual_seed(1)).item()
            for _ in range(4)]
    print(f"4 steps on one batch: losses {[round(v, 5) for v in same]}",
          flush=True)
    check(same[-1] < same[0], "the loss on a repeated batch did not fall")

    profile_steps(fresh, fresh_opt, step, batches, smi)
    return counts, ref


def profile_steps(model, opt, step, batches, smi: str) -> None:
    """``profile_calls`` over training steps, after a warm one."""
    import torch

    from egovlp_tpu_torch.train.recipes import step_generator, to_device

    batches = [to_device(b, DEVICE) for b in batches]
    step(model, opt, batches[0], step_generator(DEVICE, 1, 1, 0))  # warm
    torch.cuda.synchronize()
    def one(i):
        step(model, opt, batches[i % len(batches)],
             step_generator(DEVICE, 1, 2, i))

    profile_calls("train step", one, smi)


def profile_calls(label: str, fn, smi: str, n: int = 3) -> None:
    """Device busy time by kernel, idle share and launches a call over ``n``
    calls ``fn(i)`` (``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    # kernels only: spans of annotated host regions (Optimizer.step, ...)
    # also show on the device timeline and would count twice
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / n
    launches = sum(e.count for e in rows) / n
    print(f"profile {label}: wall {wall:.2f} ms/call, device busy "
          f"{busy:.2f} ms/call, idle share {1 - busy / wall:.3f}, kernels "
          f"{launches:.0f}/call [{smi}]", flush=True)
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the 15 largest, then the rest of the repository's own kernels
    for e in rows[:15] + [e for e in rows[15:] if "egovlp" in e.key]:
        print(f"profile {label} kernel "
              f"{e.self_device_time_total / 1e3 / n:9.3f} ms/call "
              f"{e.count / n:6.0f}x  {e.key[:90]}", flush=True)


def phase_head_split(ca, smi: str) -> dict:
    """The head-split op ``divided_attention(impl='pallas')`` forward and
    backward at full width; returns the K4/K5 launches of its runs."""
    import torch

    from egovlp_tpu_torch.kernels import divided_attention
    from egovlp_tpu_torch.kernels.divided_attention import divided_attention_bsd

    B, n = 32, 196
    total = {name: 0 for name in HS_KERNELS}
    for axis, f in (("space", 4), ("time", 4), ("time", 16)):
        S = 1 + f * n
        g = torch.Generator(device="cuda").manual_seed(100 * f + len(axis))
        bsd = [torch.randn(B, S, DIM, device="cuda", generator=g).to(
            torch.bfloat16) for _ in range(3)]

        def split(t):  # [B, S, D] -> [B, H, S, hd]
            return t.reshape(B, S, HEADS, HD).transpose(1, 2).contiguous()

        # the head-split form of the same tensors, q scaled in its dtype
        # as divided_attention_bsd scales it
        hs = [split(bsd[0]) * SCALE, split(bsd[1]), split(bsd[2])]
        routes = {
            "pallas": (hs, lambda *xs: divided_attention(
                *xs, frames=f, patches=n, axis=axis, impl="pallas")),
            "xla": (hs, lambda *xs: divided_attention(
                *xs, frames=f, patches=n, axis=axis, impl="xla")),
            "bsd K1/K2": (bsd, lambda *xs: divided_attention_bsd(
                *xs, heads=HEADS, frames=f, patches=n, axis=axis,
                impl="pallas")),
        }

        def run(route):
            """``[out, dq, dk, dv]`` of ``sum(out * cos(out))``."""
            inputs, op = routes[route]
            xs = [t.detach().requires_grad_() for t in inputs]
            out = op(*xs)
            o = out.float()
            return [out.detach(), *torch.autograd.grad(
                (o * torch.cos(o)).sum(), xs)]

        # ---- the main path, counted --------------------------------------
        ca.reset_launch_counts()
        with recorded_bodies(ca) as bodies:
            got = run("pallas")
        torch.cuda.synchronize()
        counts = dict(ca.launches)
        # --------------------------------------------------------------------
        kernel = "grouped_attention" if axis == "space" else "time_attention_hs"
        print(f"head-split {axis} f{f} launches: {counts}; K5 bodies "
              f"{bodies}", flush=True)
        check(bodies == (["streaming"] * 2 if axis == "time" else []),
              f"head-split {axis} f{f}: K5 bodies {bodies}")
        for name, c in counts.items():
            want = 1 if name in (f"{kernel}_fwd", f"{kernel}_bwd") else 0
            check(c == want, f"{name}: {c} launches in one {axis} op call, "
                             f"expected {want}")
            if name in total:
                total[name] += c
        check(all(t.shape == (B, HEADS, S, HD) and bool(torch.isfinite(t).all())
                  for t in got), f"head-split {axis} f{f}: bad output")
        want_xla = run("xla")
        k12 = run("bsd K1/K2")
        # the K1/K2 route's grads are w.r.t. unscaled q: dq_hs = dq / scale
        k12 = [split(k12[0]), split(k12[1]) / SCALE, split(k12[2]),
               split(k12[3])]
        for route, want in (("xla", want_xla), ("bsd K1/K2", k12)):
            detail, ok = [], True
            for o, a, w in zip(("out", "dq", "dk", "dv"), got, want):
                a, w = a.double(), w.double()
                err = (a - w).abs().max().item()
                rel = ((a - w).norm() / w.norm()).item()
                # max abs within 4% of the largest value (a few bf16 ulps
                # there), relative L2 within 1%
                lim = 4e-2 * w.abs().max().item()
                ok &= err <= lim and rel <= 1e-2
                detail.append(f"{o} {err:.3e}/{rel:.1e} (lim {lim:.1e})")
            print(f"check divided_attention {axis} f{f} B{B} bf16 pallas vs "
                  f"{route}: max_abs_err/rel_l2 {' '.join(detail)} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"divided_attention {axis} f{f}: pallas disagrees "
                      f"with {route}")
        del want_xla, k12, got
        times = {route: median_ms(lambda: run(route), iters=10)
                 for route in routes}
        print(f"time divided_attention {axis} f{f} B{B} bf16, forward + "
              f"backward: " + ", ".join(f"{r} {t:.4f} ms"
                                         for r, t in times.items())
              + f" [{smi}]", flush=True)
        del bsd, hs, routes
        torch.cuda.empty_cache()
    return total


def decode_stack() -> str:
    """What this machine offers the readers: OpenCV, pandas (which the port
    does not need), and the libav libraries the native decoder links."""
    import ctypes.util
    import importlib.metadata
    import importlib.util

    import cv2

    pandas = (importlib.metadata.version("pandas")
              if importlib.util.find_spec("pandas") else "absent")
    libav = {lib: ctypes.util.find_library(lib) or "absent"
             for lib in ("avcodec", "avformat", "swscale")}
    return f"cv2 {cv2.__version__}, pandas {pandas}, libav {libav}"


def write_egoclip_tree(root: Path) -> None:
    """The synthetic EgoClip tree of phase 7 (see the module notes)."""
    import cv2

    rng = np.random.default_rng(7)
    uids = [f"uid{u}" for u in range(4)]
    yy, xx = np.mgrid[0:256, 0:320]
    for u, uid in enumerate(uids):
        (root / uid).mkdir(parents=True)
        for chunk in (0, 1):
            path = str(root / uid / f"{chunk}.mp4")
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (320, 256))
            check(vw.isOpened(), f"cv2 cannot write {path}")
            for i in range(150):
                t = 150 * chunk + i
                vw.write(np.stack([(xx // 2 + yy // 2 + 60 * u + t) % 256,
                                   (yy + 2 * t + 30 * u) % 256,
                                   (xx + 3 * t) % 256], -1).astype(np.uint8))
            vw.release()

    def clip(j):
        """(start, end): in chunk 0, across the 600-s bound, in chunk 1."""
        start = (0.2 + 0.1 * j, 599.0 + 0.02 * j, 600.3 + 0.1 * j)[j % 3]
        return start, start + (1.0, 1.5, 1.0)[j % 3]

    def caption():
        v, n = rng.choice(len(CLI_VERBS)), rng.choice(len(CLI_NOUNS))
        return f"#C C {CLI_VERBS[v]} the {CLI_NOUNS[n]}", v, n

    lines = ["video_uid\tvideo_dur\tnarration_source\tnarration_ind\t"
             "narration_time\tclip_start\tclip_end\tclip_text\ttag_verb\t"
             "tag_noun"]
    for uid in uids:
        for j in range(24):
            start, end = clip(j)
            text, v, n = caption()
            lines.append(f"{uid}\t1200.0\tnarration_pass_1\t{j}\t"
                         f"{(start + end) / 2:.3f}\t{start:.3f}\t{end:.3f}\t"
                         f"{text}\t[{v}]\t[{n}, {10 + n}]")
    (root / "egoclip.csv").write_text("\n".join(lines) + "\n")
    mcq = {}
    for q in range(16):
        # type 1 (intra-video): options from one uid; type 2: from all
        choices = {}
        for o in range(5):
            j = int(rng.integers(0, 24))
            start, end = clip(j)
            uid = uids[q % 4] if q % 2 == 0 else uids[(q + o) % 4]
            choices[str(o)] = {"video_uid": uid, "clip_start": start,
                               "clip_end": end, "clip_text": caption()[0]}
        mcq[str(q)] = {"query": {"clip_text": caption()[0]},
                       "choices": choices, "answer": q % 5,
                       "types": 1 + q % 2}
    (root / "egomcq.json").write_text(json.dumps(mcq))
    (root / "vocab.txt").write_text("\n".join(CLI_VOCAB))


def tree_overrides(data: Path) -> list:
    """``cli`` overrides that read the synthetic EgoClip tree ``data``."""
    return [
        f"data_loader.args.data_dir={json.dumps(str(data))}",
        f"data_loader.args.meta_dir={json.dumps(str(data))}",
        "data_loader.args.num_workers=16",
        # a decode failure raises instead of feeding black frames
        'data_loader.args.video_params.loading="strict"',
        f"arch.args.text_params.vocab={json.dumps(str(data / 'vocab.txt'))}",
    ]


def phase_train_cli(ca, smi: str, root: Path) -> dict:
    """Phase 7 in the directory ``root`` (its EgoClip tree, ``root /
    'data'``, serves phase 8 too); returns the kernel launches of the
    first ``cli.train`` run."""
    import torch

    from egovlp_tpu_torch.cli import eval as cli_eval
    from egovlp_tpu_torch.cli import train as cli_train
    from egovlp_tpu_torch.data import native
    from egovlp_tpu_torch.data.pipeline import Loader
    from egovlp_tpu_torch.train import recipes

    t0 = time.perf_counter()
    write_egoclip_tree(root / "data")
    decoder = "the native decoder" if native.available() else "OpenCV"
    print(f"train_cli: EgoClip tree written in {time.perf_counter() - t0:.1f}"
          f" s; frames decoded by {decoder}; {decode_stack()}", flush=True)
    data = root / "data"
    overrides = tree_overrides(data) + [
        'arch.args.video_params.time_init="random"',
        f"trainer.save_dir={json.dumps(str(root / 'results'))}",
    ]
    ov = [a for o in overrides for a in ("-o", o)]
    pt = str(ROOT / "configs/pt/egoclip.json")
    models = root / "results" / "models" / "EgoClip_4f"

    # instrumentation, this script's only: a CUDA event after each step,
    # the time each batch took to come out of the Loader, and each
    # validation's result and time
    ends, losses, vals = [], [], []
    waits = {"train": [], "val": []}
    make_step, evaluate, epoch_fn = (recipes.make_egoclip_train_step,
                                     recipes.evaluate_egomcq, Loader.epoch)

    def timed_make_step(**kw):
        step = make_step(**kw)

        def timed(model, optimizer, batch, generator):
            loss = step(model, optimizer, batch, generator)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            losses.append(loss)
            return loss
        return timed

    def timed_evaluate(model, loader, input_res=224):
        t0, w0 = time.perf_counter(), len(waits["val"])
        m = evaluate(model, loader, input_res)
        vals.append((m, len(loader.dataset), time.perf_counter() - t0,
                     sum(waits["val"][w0:])))
        return m

    def timed_epoch(self, epoch=0):
        it = epoch_fn(self, epoch)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits["train" if self.dataset.cfg.split == "train" else "val"
                  ].append(time.perf_counter() - t0)
            yield batch

    recipes.make_egoclip_train_step = timed_make_step
    recipes.evaluate_egomcq = timed_evaluate
    Loader.epoch = timed_epoch
    try:
        # ---- the main path, counted -----------------------------------
        ca.reset_launch_counts()
        model, opt = cli_train.main(["--config", pt, *ov,
                                     "-o", "trainer.epochs=2",
                                     "-o", "trainer.max_samples_per_epoch=48"])
        torch.cuda.synchronize()
        counts = dict(ca.launches)
        # ----------------------------------------------------------------
        print(f"train_cli launches: {counts}", flush=True)
        check(model.video_model.dtype == torch.bfloat16
              and model.cfg.video.depth == 12 and model.cfg.video.embed_dim
              == DIM and model.cfg.text.n_layers == 6, "not the full model")
        n_steps, passes = len(ends), 2 * len(vals)
        check(n_steps == 6 and len(vals) == 2 and opt.param_groups[0][
            "count"] == 6, f"{n_steps} steps, {len(vals)} validations")
        per_step = {name: 12 for name in KERNELS}
        per_step["space_attention_bwd"] = 11
        for name, c in counts.items():
            want = (per_step[name] * n_steps if name in KERNELS else 0) + (
                12 * passes if name in FWD else 0)
            check(c == want, f"{name}: {c} launches in cli.train, expected "
                             f"{want}")
        values = [float(v) for v in losses]
        print(f"train_cli losses: {[round(v, 5) for v in values]}",
              flush=True)
        check(all(np.isfinite(values)), "a cli.train loss is not finite")
        for m, *_ in vals:
            check(set(m) == {"Intra-video", "Inter-video"}
                  and all(0.0 <= v <= 100.0 for v in m.values()),
                  f"EgoMCQ metrics {m}")
        (run,) = models.iterdir()
        names = sorted(p.name for p in run.iterdir())
        print(f"train_cli run dir: {names}; validation {[v[0] for v in vals]}",
              flush=True)
        check({"checkpoint-epoch1.pth", "checkpoint-epoch2.pth"} <= set(names),
              "epoch checkpoints missing")
        ckpt2 = str(run / "checkpoint-epoch2.pth")
        in_run = vals[1][0]
        # device timeline: step i's end to step i+1's end, steps 2-6, the
        # epoch boundary's interval (validation, checkpoint) dropped by the
        # median
        torch.cuda.synchronize()
        loop_ms = statistics.median(a.elapsed_time(b)
                                    for a, b in zip(ends[1:], ends[2:]))
        wait_ms = statistics.median(waits["train"]) * 1e3
        print(f"train_cli loop (32 clips a step: 16 + 16 scene negatives, "
              f"decoded by the Loader): median step end to step end over "
              f"steps 2-6 {loop_ms:.2f} ms ({32 / loop_ms * 1e3:.1f} "
              f"clips/s); median wait on the Loader {wait_ms:.2f} ms a "
              f"batch (first batches of the epochs included) [{smi}]",
              flush=True)
        for i, (m, n, sec, wait) in enumerate(vals):
            print(f"train_cli EgoMCQ validation {i + 1}: {n} items in "
                  f"{sec:.3f} s ({n / sec:.1f} items/s), {wait:.3f} s of it "
                  f"waiting on the Loader (5 options x 4 frames an item) "
                  f"[{smi}]", flush=True)
        del model, opt
        torch.cuda.empty_cache()

        # ---- resume at epoch 3 ------------------------------------------
        ends.clear(), vals.clear()
        ca.reset_launch_counts()
        model, opt = cli_train.main(["--config", pt, *ov, "--resume", ckpt2,
                                     "-o", "trainer.epochs=3",
                                     "-o", "trainer.max_samples_per_epoch=48"])
        resumed = dict(ca.launches)
        (run3,) = [d for d in models.iterdir() if d != run]
        names3 = sorted(p.name for p in run3.iterdir())
        print(f"resume: launches {resumed}, run dir {names3}, optimizer "
              f"count {opt.param_groups[0]['count']}", flush=True)
        check(len(ends) == 3 and opt.param_groups[0]["count"] == 9,
              "the resumed run did not take 3 steps to count 9")
        check("checkpoint-epoch3.pth" in names3 and not any(
            n in names3 for n in ("checkpoint-epoch1.pth",
                                  "checkpoint-epoch2.pth")),
              "the resumed run did not start at epoch 3")
        check(resumed["space_attention_bwd"] == 33, "resume launches")
        del model, opt
        torch.cuda.empty_cache()

        # ---- cli.eval and the eval-only preset on the epoch-2 weights -----
        eval_ov = [a for o in tree_overrides(data) for a in ("-o", o)]
        got = cli_eval.main(["--config", pt, "--checkpoint", ckpt2,
                             *eval_ov])
        print(f"cli.eval on epoch 2: {got}, in-run {in_run}", flush=True)
        check(got == in_run, "cli.eval disagrees with the in-run validation")
        vals.clear()
        cli_train.main(["--config", str(ROOT / "configs/eval/egomcq.json"),
                        *ov, "-o",
                        f"arch.args.load_checkpoint={json.dumps(ckpt2)}"])
        preset = root / "results" / "models" / "EgoClip_4f_eval"
        (run_eval,) = preset.iterdir()
        print(f"eval-only preset: {vals[0][0]}, run dir "
              f"{sorted(p.name for p in run_eval.iterdir())}", flush=True)
        check(len(vals) == 1 and vals[0][0] == in_run,
              "the eval-only preset disagrees with the in-run validation")
        check([p.name for p in run_eval.iterdir()] == ["config.json"],
              "the eval-only preset wrote a checkpoint")
    finally:
        recipes.make_egoclip_train_step = make_step
        recipes.evaluate_egomcq = evaluate
        Loader.epoch = epoch_fn
    return counts


# ---- phase 8: DDP ------------------------------------------------------------

DDP_CLIPS = 8        # clips a rank takes in phase 8 (b); + 8 negatives each
DDP_TIMEOUT_S = 420  # each world-2 rank's time limit
# phase 8 (b)'s limits against the one-process run on the concatenated
# batch, bf16 (see the module notes): the first step's loss, its gradient
# (cosine and norm ratio over all parameters) and the parameters' update
# after 3 steps (cosine of p - p0 over all parameters)
DDP_LOSS_TOL = 5e-3
DDP_GRAD_COS, DDP_GRAD_NORM = 0.999, 1e-2
DDP_UPDATE_COS = 0.99


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment of a rank on this host; every rank on GPU 0
    (LOCAL_RANK 0), so that the run needs one card."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def ddp_eval_args(data: Path) -> list:
    """``cli.eval`` on the synthetic tree at full width and a tiny depth
    (2 video blocks, 2 text layers), 4 items a batch: every rank's batches
    are as full as one process's, so each row's products run the same
    kernels on the same shapes."""
    ov = tree_overrides(data) + [
        'arch.args.video_params.time_init="random"',
        "arch.args.video_params.depth=2", "arch.args.text_params.n_layers=2",
        "trainer.val_batch_size=4"]
    return ["--config", str(ROOT / "configs/pt/egoclip.json"),
            *[a for o in ov for a in ("-o", o)]]


def flat_grads(model):
    import torch

    return torch.cat([p.grad.float().flatten() for p in model.parameters()])


def check_launches(counts: dict, n_steps: int, label: str) -> None:
    """12 / 12 / 11 / 12 launches of K1-fwd / K2-fwd / K1-bwd / K2-bwd a
    training step (phase 5), no K4 / K5."""
    for name, c in counts.items():
        per_step = 11 if name == "space_attention_bwd" else 12
        want = per_step * n_steps if name in KERNELS else 0
        check(c == want, f"{label}: {name} {c} launches, expected {want}")


def phase_ddp(ca, smi: str, ref: dict, data: Path) -> dict:
    """Phase 8; returns the kernel launches of the world-1 NCCL run."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli import eval as cli_eval
    from egovlp_tpu_torch.core.dist import init_distributed
    from egovlp_tpu_torch.io.checkpoints import CheckpointManager
    from egovlp_tpu_torch.train.recipes import (
        data_parallel,
        make_train_epoch_fn,
        resolve_device,
        step_generator,
        to_device,
    )
    from egovlp_tpu_torch.train.state import make_optimizer

    arch, sched, step = train_setup()
    n_steps = len(ref["losses"])

    # ---- (a) world 1 over NCCL, in this process --------------------------
    env = ddp_env(0, 1, free_port())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        init_distributed("cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"{dist.get_backend()} group of {dist.get_world_size()}")
        model, _ = build.build_model(arch, DEVICE)
        model.load_state_dict(ref["initial"])
        opt, _ = make_optimizer(model, **sched)
        device = resolve_device(DEVICE)  # run_task's: cuda:{LOCAL_RANK}
        check(device == torch.device("cuda", 0), f"device {device}")
        ddp = data_parallel(model, device)
        check(isinstance(ddp, DistributedDataParallel), "no DDP wrapper")
        losses, times = [], []

        def timed_step(m, o, batch, gen):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(m, o, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            return loss

        # ---- the main path, counted -----------------------------------
        ca.reset_launch_counts()
        make_train_epoch_fn([ref["batches"]], timed_step, DEVICE, seed=0)(
            ddp, opt, 1, logging.getLogger("chip_smoke"))
        torch.cuda.synchronize()
        counts = dict(ca.launches)
        # ----------------------------------------------------------------
        print(f"ddp world 1 (nccl) launches over {n_steps} steps: {counts}",
              flush=True)
        check_launches(counts, n_steps, "ddp world 1")
        missing = [k for k, p in model.named_parameters() if p.grad is None]
        check(not missing, f"parameters without a gradient: {missing}")
        values = [float(v) for v in losses]
        sd = model.state_dict()
        d_param = max((sd[k].cpu() - w).abs().max().item()
                      for k, w in ref["epoch1"].items())
        d_loss = max(abs(a - b) for a, b in zip(values, ref["losses"]))
        print(f"ddp world 1 (nccl) vs the Trainer path: losses {values} vs "
              f"{ref['losses']} (max diff {d_loss:.3e}); parameters after "
              f"step {n_steps}: max diff {d_param:.3e}; every one of "
              f"{len(sd)} parameters got a gradient", flush=True)
        check(d_loss == 0.0 and d_param == 0.0,
              "world-1 DDP differs from the one-process Trainer path")
        # DDP's own cost: the DDP-wrapped model against an unwrapped copy
        # on the same batches, in turns (plain, DDP, DDP, plain, ...) so
        # that the host's drift falls on both; DDP rebuilt its buckets at
        # step 2, before these
        plain, _ = build.build_model(arch, DEVICE)
        plain.load_state_dict(ref["initial"])
        plain_opt, _ = make_optimizer(plain, **sched)
        turns = {"plain": (plain, plain_opt, []), "ddp": (ddp, opt, [])}
        for i in range(12):
            order = ("plain", "ddp") if i % 2 == 0 else ("ddp", "plain")
            for name in order:
                m, o, ts = turns[name]
                batch = to_device(ref["batches"][i % n_steps], DEVICE)
                gen = step_generator(DEVICE, 0, 2, i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(m, o, batch, gen)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
        ddp_ms = statistics.median(turns["ddp"][2])
        plain_ms = statistics.median(turns["plain"][2])
        print(f"ddp world 1 (nccl) step, 32 clips: first 3 steps "
              f"{[round(t, 2) for t in times]} ms; then in turns with an "
              f"unwrapped copy, 12 steps each: DDP {ddp_ms:.2f} ms, "
              f"unwrapped {plain_ms:.2f} ms, DDP's own cost "
              f"{ddp_ms - plain_ms:+.2f} ms; phase 5's step function "
              f"{ref['step_ms']:.2f} ms [{smi}]", flush=True)
        del plain, plain_opt, turns
        del ddp, model, opt
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()

    # ---- (b) world 2 over gloo, both ranks on GPU 0 ----------------------
    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name)
    try:
        torch.save(ref["initial"], out / "initial.pt")
        np.savez(out / "batches.npz", **{
            f"{i}/{k}": v for i, b in enumerate(ref["batches"])
            for k, v in b.items()})
        # the one-process gradient of the first step on the whole batch
        model, _ = build.build_model(arch, DEVICE)
        model.load_state_dict(ref["initial"])
        loss0 = step(model, NoUpdate(model),
                     to_device(ref["batches"][0], DEVICE),
                     step_generator(DEVICE, 0, 1, 0)).item()
        check(loss0 == ref["losses"][0], "the first step is not phase 5's")
        g_ref = flat_grads(model).cpu()
        del model
        torch.cuda.empty_cache()

        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
             str(out), str(data)], env={**os.environ, **ddp_env(r, 2, port)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            # meanwhile, the one-process EgoMCQ validation
            want_mcq = cli_eval.main(ddp_eval_args(data))
            outs = [p.communicate(timeout=DDP_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, o) in enumerate(zip(procs, outs)):
            tail = "\n".join(o.splitlines()[-25:])
            print(f"ddp world 2 rank {r} exit {p.returncode}, output tail:\n"
                  f"{tail}", flush=True)
            check(p.returncode == 0, f"world-2 rank {r} failed")
        res = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(2)]
        for r, x in enumerate(res):
            check_launches(x["launches"], n_steps, f"ddp world 2 rank {r}")
            check(not x["missing"], f"rank {r}: no gradient for "
                                    f"{x['missing']}")
        check(res[0]["losses"] == res[1]["losses"],
              f"the ranks' losses differ: {res[0]['losses']} "
              f"{res[1]['losses']}")
        d_loss = abs(res[0]["losses"][0] - loss0)
        g = torch.load(out / "grads.pt", weights_only=True)
        g_cos = cosine(g, g_ref)
        g_ratio = (g.double().norm() / g_ref.double().norm()).item()
        # the checkpoint rank 0 wrote, strictly into a one-process model
        fresh, _ = build.build_model(arch, "cpu")
        payload = CheckpointManager(str(out / "ckpt")).restore(fresh)
        check(payload["epoch"] == 1 and payload["step"] == n_steps,
              f"checkpoint epoch {payload['epoch']} step {payload['step']}")
        sd = fresh.state_dict()
        upd = torch.cat([(sd[k] - w).flatten() for k, w in
                         ref["initial"].items()])
        upd_ref = torch.cat([(ref["epoch1"][k] - w).flatten() for k, w in
                             ref["initial"].items()])
        u_cos = cosine(upd, upd_ref)
        d_param = (upd - upd_ref).abs().max().item()
        print(f"ddp world 2 (gloo, 2 ranks on GPU 0, {DDP_CLIPS} + "
              f"{DDP_CLIPS} clips a rank) vs one process on the 32-row "
              f"batch: losses {res[0]['losses']} vs {ref['losses']}, first "
              f"step diff {d_loss:.3e} (tol {DDP_LOSS_TOL}); first-step "
              f"gradient cosine {g_cos:.6f} (>= {DDP_GRAD_COS}), norm "
              f"ratio {g_ratio:.6f} (1 +- {DDP_GRAD_NORM}); update after "
              f"step {n_steps}: cosine {u_cos:.6f} (>= {DDP_UPDATE_COS}), "
              f"max abs diff {d_param:.3e}", flush=True)
        check(d_loss <= DDP_LOSS_TOL, "world-2 loss off the one-process one")
        check(g_cos >= DDP_GRAD_COS and abs(g_ratio - 1) <= DDP_GRAD_NORM,
              "world-2 gradient is not the global-batch gradient")
        check(u_cos >= DDP_UPDATE_COS, "world-2 parameters diverge")
        print(f"ddp world 2 step (gloo all-reduce through the host), median "
              f"over steps 2-{n_steps}: rank 0 "
              f"{statistics.median(res[0]['step_ms'][1:]):.2f} ms, rank 1 "
              f"{statistics.median(res[1]['step_ms'][1:]):.2f} ms [{smi}]",
              flush=True)
        got = [x["metrics"] for x in res]
        print(f"ddp world 2 EgoMCQ validation: {got}; one process "
              f"{want_mcq}", flush=True)
        check(got[0] == got[1] == want_mcq,
              "world-2 EgoMCQ accuracies differ from one process's")
    finally:
        tmp.cleanup()
    return counts


def ddp_worker(out: Path, data: Path) -> None:
    """One rank of phase 8 (b) (``chip_smoke.py --ddp-worker OUT DATA``,
    torchrun's environment set by phase 8): gloo on GPU 0, this rank's
    clips of phase 5's 3 batches through the DDP-wrapped model, the
    checkpoint (rank 0 writes), then ``cli.eval`` on its shard of the
    synthetic tree; results to ``OUT/rank{r}.json``."""
    import torch
    import torch.distributed as dist

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli import eval as cli_eval
    from egovlp_tpu_torch.core.dist import init_distributed
    from egovlp_tpu_torch.io.checkpoints import CheckpointManager
    from egovlp_tpu_torch.kernels import cuda_attention as ca
    from egovlp_tpu_torch.train.recipes import (
        data_parallel,
        make_train_epoch_fn,
        resolve_device,
    )
    from egovlp_tpu_torch.train.state import make_optimizer

    rank, world = init_distributed("cuda", backend="gloo")
    device = resolve_device("cuda")
    arch, sched, step = train_setup()
    model, _ = build.build_model(arch, device)
    model.load_state_dict(torch.load(out / "initial.pt", weights_only=True))
    opt, _ = make_optimizer(model, **sched)
    first, update = [], opt.step

    def recorded_update():  # the first step's gradient, DDP-averaged
        if not first:
            first.append(flat_grads(model).cpu())
        update()

    opt.step = recorded_update
    ddp = data_parallel(model, device)
    npz = np.load(out / "batches.npz")
    lo, hi = rank * DDP_CLIPS, (rank + 1) * DDP_CLIPS
    batches = [{k.split("/", 1)[1]: npz[k][lo:hi] for k in npz.files
                if k.startswith(f"{i}/")} for i in range(3)]
    losses, times = [], []

    def timed_step(m, o, batch, gen):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(m, o, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        return loss

    ca.reset_launch_counts()
    make_train_epoch_fn([batches], timed_step, device, seed=0)(
        ddp, opt, 1, logging.getLogger("chip_smoke"))
    torch.cuda.synchronize()
    launches = dict(ca.launches)
    missing = [k for k, p in model.named_parameters() if p.grad is None]
    path = CheckpointManager(str(out / "ckpt")).save_epoch(1, ddp, opt, 0.0)
    check(path.exists(), f"rank {rank}: no checkpoint after the barrier")
    if rank == 0:
        torch.save(first[0], out / "grads.pt")
    del ddp, model, opt, first
    torch.cuda.empty_cache()
    metrics = cli_eval.main(ddp_eval_args(data))
    (out / f"rank{rank}.json").write_text(json.dumps({
        "losses": losses, "step_ms": times, "launches": launches,
        "missing": missing, "metrics": metrics}))
    dist.destroy_process_group()
    print(f"ddp worker rank {rank} of {world}: done", flush=True)


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
    if sys.argv[1:2] == ["--ddp-worker"]:  # a rank of phase 8 (b)
        ddp_worker(Path(sys.argv[2]), Path(sys.argv[3]))
        return

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
    for name in STREAMING:  # K2's and K5's streaming instantiations
        attributes = getattr(lib, f"egovlp_{name}_attributes")
        for dtype, code in (("bfloat16", 1), ("float32", 0)):
            for f in (4, 16):
                regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
                rc = attributes(f, code, ctypes.byref(regs), ctypes.byref(local),
                                ctypes.byref(smem))
                check(rc == 0, f"{name} attributes at f {f}: {rc}")
                print(f"kernel {name} {dtype} f{f}: {regs.value} registers "
                      f"a thread, {local.value} local (spill) bytes a thread, "
                      f"{smem.value} bytes of shared memory a CTA at hd {HD}",
                      flush=True)
                check(f != 4 or dtype != "bfloat16" or local.value == 0,
                      f"{name} bf16 spills to local memory at f 4")
    for name in TENSOR_CORE:  # the tensor-core kernels' resources
        attributes = getattr(lib, f"egovlp_{name}_attributes")
        for L in (196, 255):
            regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            rc = attributes(L, HD, ctypes.byref(regs), ctypes.byref(local),
                            ctypes.byref(smem))
            check(rc == 0, f"{name} attributes at L {L}: {rc}")
            print(f"kernel {name} bf16 L{L} hd{HD}: {regs.value} registers "
                  f"a thread, {local.value} local (spill) bytes a thread, "
                  f"{smem.value} bytes of shared memory a CTA", flush=True)
            check(L != 196 or local.value == 0,
                  f"{name} spills to local memory at L 196, hd {HD}")

    rows = phase_kernels(ca, smi)
    serve_counts, _ = phase_slice(ca, smi)
    torch.cuda.empty_cache()
    train_counts, ref = phase_train(ca, smi)
    torch.cuda.empty_cache()
    hs_counts = phase_head_split(ca, smi)
    torch.cuda.empty_cache()
    tree = tempfile.TemporaryDirectory()
    try:
        cli_counts = phase_train_cli(ca, smi, Path(tree.name))
        torch.cuda.empty_cache()
        ddp_counts = phase_ddp(ca, smi, ref, Path(tree.name) / "data")
    finally:
        tree.cleanup()

    def sources(name):
        return {"source": f"egovlp_tpu_torch/kernels/csrc/{name}.cu",
                "sources": [f"egovlp_tpu_torch/kernels/csrc/{f}"
                            for f in (f"{name}.cu", BODIES.get(name))
                            if f is not None]}

    kernels = [{"name": name, "route": "cuda", **sources(name),
                "replaces": replaces, "launches": train_counts[name],
                "launches_by_path": {"serving": serve_counts[name],
                                     "training": train_counts[name],
                                     "train_cli": cli_counts[name],
                                     "ddp_world1": ddp_counts[name]},
                **rows[name]}
               for name, replaces in KERNELS.items()]
    kernels += [{"name": name, "route": "cuda", **sources(name),
                 "replaces": replaces, "launches": hs_counts[name],
                 "launches_by_path": {"head_split_op": hs_counts[name],
                                      "train_cli": cli_counts[name]},
                 **rows[name]}
                for name, replaces in HS_KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
