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
   backward, bf16 and float32) at f 4 and 16, and of K3-fwd and K3-bwd
   (the LayerNorm kernels) at both dtypes, and fails if an L 196 or a
   bf16 streaming instantiation (f 4: pretraining; f 16: fine-tuning, the
   main path of phase 9) or a bf16 K3 kernel spills (K1/K2 at ViT-L's D
   1024 run the same hd 64 instantiations);
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
   at B 16, f 4, and for K1 and K2 (forward and backward, 3b) also at the
   fine-tune shapes B 16, f 16 (phase 9) and B 4, f 16 (phase 10) and at
   the ViT-L training shape B 32, f 4, D 1024 with 16 heads (phase 11),
   whose outputs are held to the same limits;
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
3c. K3, the LayerNorm kernels (``phase_layer_norm``): forward and
   backward against their plain twins at ``[25088, 1024]`` and ``[32,
   1024]`` (a ViT-L step's patch and CLS rows) and ``[25088, 768]``
   (ViT-B's), float32 and bf16, with the limits in its docstring; two
   K3-bwd launches give the same bits; kernel, device, plain, library
   (``F.layer_norm`` and its autograd backward) times and the bound at
   bf16;
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
   K1-bwd: the last block's space-attention patch outputs reach no loss;
   86 of K3-fwd and 85 of K3-bwd, ``ln_per_step``),
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
   H100 80GB HBM3, 700 W; bf16 throughout.  In (a) and on each rank of
   (b): one DDP step of ``global_sim='ring'`` against one of 'gather' from
   phase 5's weights on (the rank's rows of) phase 5's first batch: the
   losses within (b)'s loss limit and the updates at (b)'s update cosine
   (the ranks' ring losses identical).
9. fine-tuning at 16 frames: a synthetic EPIC-Kitchens MIR tree (two
   ``rgb_frames`` directories of 240 JPEGs at 456 x 256; 64 train and 32
   test clips of 24-80 frames, captions "verb the noun" over 5 verbs and 6
   nouns; one sentence a caption, named by its first clip, and graded
   relevancy pickles: 1 for the same verb and noun, 0.5 for one of them,
   so many sentences have several relevant clips) and a CharadesEgo tree
   (16 mp4s of 90 frames at 320 x 240, 30 fps, written with OpenCV;
   ``metadata_train.csv`` of 48 action segments; the test csv with 0-2
   actions a video; a 157-line ``Charades_v1_classes.txt``), the phase-7
   vocabulary and more words.  First, on the full-width 16-frame model of
   ``configs/ft/epic.json`` in bf16 with random time attention and a batch
   of 16 clips from its train Loader: the first max-margin step's loss
   (within 2e-2) and gradients (cosine >= 0.999 over all parameters, >=
   0.99 for every block's ``attn.qkv.weight`` and
   ``timeattn.qkv.weight``) against the plain-attention model, the peak
   memory of that step, a max-margin loss falling over 4 AdamW steps on
   that batch, and a ``torch.profiler`` breakdown of 3 steps.  Then, in
   this process, through the entry points: ``cli.train`` on
   ``configs/ft/epic.json`` (2 epochs of 3 steps of 16 clips x 16 frames,
   16 decode threads, strict loading, nDCG / mAP on the test split after
   each epoch, checkpoints; counted: 12 / 12 / 11 / 12 launches of K1-fwd /
   K2-fwd / K1-bwd / K2-bwd a step plus 12 K1-fwd and 12 K2-fwd a
   validation tower pass of 16 clips, no K4 / K5), ``--resume`` of its
   epoch-2 checkpoint training epoch 3 alone, ``cli.eval`` of that
   checkpoint on ``configs/eval/epic.json`` (cosine, equal to the in-run
   validation, and ``--dual_softmax``), ``cli.train`` on
   ``configs/ft/epic_adaptive.json`` (1 epoch, dual-softmax validation),
   ``cli.train`` on ``configs/ft/charades.json`` (1 epoch of 3 steps, mAP
   on the 16 test videos) and ``cli.eval`` on ``configs/eval/charades.json``
   equal to it.  Every loss finite, every metric in [0, 100].  Prints the
   loop's median step end to step end and clips/s, the Loader wait, the
   peak memory, and each validation's items/s.
10. Ego4D at full width, bf16, random time attention:
   (a) OSCC and PNR at 16 frames: a synthetic hands-and-objects tree (24
   parent clips of 8 s at 30 fps, 241 JPEGs each at 456 x 256 in
   ``frames_jpeg`` / ``frames_jpeg_neg``; ``fho_oscc-pnr_{train,val}.json``
   of 16 and 8 clips, half state changes with a keyframe inside the
   clip).  For each task, first on its config's model and a batch of 4
   clips from its train Loader: the first step's loss and video-side
   gradients against the plain-attention model within phase 9's limits,
   no gradient on the text tower, 4 AdamW steps on that batch at the
   config's learning rate (printed: from random weights they overshoot)
   and 4 at 1e-6 from the same weights, whose loss must fall, with the
   text tower bit-equal after them (and for OSCC a
   ``torch.profiler`` breakdown of 3 steps); then ``cli.train -c
   configs/ft/{oscc,pnr}.json`` (2 epochs of 3 steps of 4 clips x 16
   frames, 16 decode threads, strict loading, validation on the val split
   after each epoch; counted: 12 / 12 / 11 / 12 launches of K1-fwd /
   K2-fwd / K1-bwd / K2-bwd a step plus 12 K1-fwd and 12 K2-fwd a
   validation batch of up to 4 clips, no K4 / K5), ``--resume`` training
   epoch 3 alone, and ``cli.eval -c configs/eval/{oscc,pnr}.json`` on the
   epoch-2 checkpoint with the default split, equal to the in-run
   validation; accuracy in [0, 100], keyframe distance >= 0.  Prints the
   loop's median step end to step end and clips/s, the Loader wait, the
   peak memory and each validation's items/s.
   (b) NLQ / MQ feature extraction at 4 frames: a 20-s mp4 at 30 fps and
   456 x 256 written with OpenCV, ``nlq_val.json`` / ``moments_val.json``
   with two clips of it and three queries (and an empty one).
   ``cli.extract -c configs/eval/nlq.json`` in video mode (``.npy``;
   counted: 12 K1-fwd and 12 K2-fwd a micro-batch of up to 4 windows, no
   backward, no K4 / K5), each clip ``[n_windows, 256]`` and each window's
   feature at cosine >= 0.999 against the plain-attention model on the
   same windows; text mode, CLS ``[256]`` (``.npy``) and token level
   ``[30, 256]`` (``.pt``), launching no video kernel; then
   ``configs/eval/mq.json`` (``.pt``), equal in cosine to NLQ's features
   of the same clips.  Prints windows a second, with and without the
   decode.
11. ViT-L EgoClip pretraining (``configs/pt/egoclip_vitl_tp.json``: D
   1024, 24 blocks, 16 heads, 4 frames) at full width in bf16 on seeded
   random weights (time attention random), on a seeded batch of 16 clips +
   16 scene negatives: each recompute mode ('block', 'attn', 'attn_out',
   'mlp') against no recompute (which fits at this batch): the first step's
   loss within 1e-5 relative and the gradient of every parameter at cosine
   >= 0.9999; GradCache at ``grad_accum`` 2 and 4 ('attn_out') against the
   monolithic step: loss within 1e-4, cosine >= 0.9995, each step's peak
   memory; every mode's step with AdamW: time, clips/s, peak memory and
   the launches of every kernel a step, checked (``vitl_step_counts``:
   'attn_out' runs K1-fwd / K2-fwd 24 times a step, 'attn' and 'block'
   48); a ``torch.profiler`` breakdown of 3 steps of the config's 'block'
   (K3's share printed); a loss falling over 4 steps at lr 1e-6.  Then
   ``cli.train -c configs/pt/egoclip_vitl_tp.json -o mesh.model=1`` on
   phase 7's tree (1 epoch of 3 steps, EgoMCQ validation, no checkpoint),
   again with ``-o trainer.grad_accum=2`` and with ``-o
   loss.args.global_sim="ring"``: launches counted, finite losses, metrics
   in [0, 100]; prints each run's loop time, clips/s, Loader wait and peak
   memory.

12. AOT serving artifact (``phase_aot``): phase 4's model exported with
   ``io/export.export_embedder`` at buckets 1, 4 and 16 on ``cuda`` (export
   seconds, artifact bytes against the weights' bytes, which it must stay
   under 5% of); a fresh process loads it with ``ExportedEmbedder`` and
   embeds texts and 3 clips, and fails if any ``egovlp_tpu_torch.models``
   module was imported; in this process the artifact's ``embed_texts`` /
   ``embed_frames`` at every bucket and at 3 (padded to 4) must equal the
   live ``Embedder``'s within 1e-6 (the same kernels on the same inputs),
   K1-fwd and K2-fwd launch 12 times a video call, one bucket-16 video
   call launches what the live call does, 17 clips raise naming the
   bucket, and ``cli.serve --aot`` in a subprocess answers ``/embed_text``
   with the live values; prints the artifact's and the live
   ``embed_frames`` median ms per bucket (20 calls each, in turns), a
   ``torch.profiler`` breakdown of 3 bucket-16 calls of each, and the
   host cost of
   the op registration (``op_host_costs``: K3-fwd at ``[32, 1024]`` and
   K1-fwd at ``[16, 4, 196, 768]`` through the registered op, the launcher
   and a ``torch.library.custom_op``).

Phases 3, 3b and 3c also give the library call's own device time
(``torch.profiler`` over all its kernels: ``library_device_ms``).  The
last four lines are a JSON object of phase 12's numbers, the
``nvidia-smi`` line, a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import json
import logging
import os
import pickle
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
# K3, the LayerNorm kernels (the custom VJP of fused_ln.py, plain jnp on
# the TPU: the forward, and its backward _ln_bwd)
LN_KERNELS = {"layer_norm_fwd": "egovlp_tpu/kernels/fused_ln.py:41",
              "layer_norm_bwd": "egovlp_tpu/kernels/fused_ln.py:67"}
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
          **dict.fromkeys(STREAMING, "time_attention_stream.cuh"),
          **dict.fromkeys(LN_KERNELS, "layer_norm.cuh")}
REDESIGNED = {**TENSOR_CORE, **STREAMING}
FWD = ("space_attention_fwd", "time_attention_fwd")
BWD = ("space_attention_bwd", "time_attention_bwd")
HEADS, DIM = 12, 768
VITL_HEADS, VITL_DIM = 16, 1024  # configs/pt/egoclip_vitl_tp.json
HD = DIM // HEADS
SCALE = HD ** -0.5
TIMED = (16, 4, 196)  # B, f, n of the timed bf16 calls
TIMED_F16 = (16, 16, 196)  # and of K1/K2 at the 16-frame fine-tune shape
TIMED_F16_B4 = (4, 16, 196)  # and at the OSCC / PNR batch
TIMED_VITL = (32, 4, 196)  # and at the ViT-L training step (D 1024, 16 heads)
# K3's rows: a ViT-L step's patch rows (32 clips x 4 frames x 196) and CLS
# rows at D 1024, the patch rows at ViT-B's D 768; the first is timed
LN_SHAPES = ((25088, VITL_DIM), (32, VITL_DIM), (25088, DIM))
# NVIDIA H100 SXM data sheet: HBM bytes/s, dense bf16 tensor FLOP/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16_FLOPS, PEAK_F32_FLOPS = 3.35e12, 989e12, 67e12
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


def attention_counts(counts: dict) -> dict:
    """The attention kernels' launches of ``counts`` (K3 left out: its
    launches a pass depend on the towers, see ``ln_per_step``)."""
    return {k: v for k, v in counts.items() if k not in LN_KERNELS}


def ln_per_step(depth: int, text_layers: int, remat: str = "none",
                n_micro: int = 1) -> dict:
    """K3 launches of one EgoClip training step: a video tower pass norms
    6 times a block (norm3, norm1, norm2 on the CLS and patch parts) and
    once at the end, a text tower pass once and twice a layer.  The
    backward skips the last block's patch-part norm2 (it reaches no loss).
    GradCache embeds every micro-batch twice; 'block' recompute runs each
    block's 6 norms again in the backward."""
    one = 6 * depth + 1 + 1 + 2 * text_layers
    fwd = n_micro * one * (2 if n_micro > 1 else 1)
    if remat == "block":
        fwd += n_micro * 6 * depth
    return {"layer_norm_fwd": fwd, "layer_norm_bwd": n_micro * (one - 1)}


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


def interleaved_ms(a, b, iters: int = 20, warmup: int = 3) -> tuple:
    """Median times of ``a()`` and ``b()`` (CUDA events), called in turns
    (a, b, b, a, ...) so that a drift of the host reaches both alike."""
    import torch

    for _ in range(warmup):
        a(), b()
    times = ([], [])
    for i in range(2 * iters):
        k = (i + i // 2) % 2  # 0 1 1 0 0 1 1 0 ...
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        (a, b)[k]()
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def device_ms(fn, iters: int = 20, warmup: int = 3,
              library: bool = False) -> float:
    """The device time of the repository's own kernels that ``fn()``
    launches (``torch.profiler``: kernels in the ``egovlp`` namespace, not
    PyTorch's), per call, mean over ``iters`` calls; with ``library``, of
    every kernel it launches (a PyTorch call's)."""
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
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and (library or "egovlp" in e.key))
        if total > 0:
            return total / 1e3 / iters
    raise RuntimeError("three profiler sessions saw no kernel of "
                       + ("the call" if library else "the repository"))


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


def grid_inputs(B, f, n, dtype, seed, grad=False, D=DIM):
    """q, k, v, cls_k, cls_v (and do when ``grad``), unit normal."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    grid = [mk(B, f, n, D) for _ in range(4 if grad else 3)]
    return (*grid[:3], mk(B, 1, D), mk(B, 1, D), *grid[3:])


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


def sdpa_layout(x, axis: str, grad: bool, H: int = HEADS):
    """The kernel's inputs laid out for ``F.scaled_dot_product_attention``:
    space q [B*f, H, n, hd], k/v [B*f, H, n+1, hd]; time q [B*n, H, f, hd],
    k/v [B*n, H, f+1, hd]; CLS first.  (Plus do laid out as q.)"""
    import torch

    q, k, v, ck, cv = x[:5]
    B, f, n, D = q.shape
    hd = D // H
    groups, rows = (B * f, n) if axis == "space" else (B * n, f)

    def heads(t):
        if axis == "time":
            t = t.permute(0, 2, 1, 3)
        return t.reshape(groups, rows, H, hd).transpose(1, 2).contiguous()

    def with_cls(c, t):
        reps = f if axis == "space" else n
        c = c.reshape(B, 1, 1, H, hd).expand(B, reps, 1, H, hd)
        c = c.reshape(groups, 1, H, hd).transpose(1, 2)
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
        """K4/K5 take q already scaled; K1/K2 the heads of the inputs'
        width (12 at ViT-B's D 768, 16 at ViT-L's 1024: hd 64 both)."""
        if name in HS_KERNELS:
            return fn(*x)
        heads = VITL_HEADS if x[0].shape[-1] == VITL_DIM else HEADS
        return fn(*x, heads=heads, scale=SCALE)

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

    def time_kernel(name, B, f, n, D=DIM) -> dict:
        """Times ``name`` at bf16 ``[B, f, n, D]`` (K4/K5: ``[B * H, f, n,
        hd]``) against its plain twin, SDPA and the bound, and holds it to
        the twin; returns its row."""
        kernel, plain = getattr(ca, name), getattr(ca, f"{name}_plain")
        bwd = name.endswith("bwd")
        if name in HS_KERNELS:  # [B * H, f, n, hd]
            x = hs_inputs(B * HEADS, f, n, torch.bfloat16, seed=B, grad=bwd)
            lay = sdpa_hs_layout(name, x, grad=bwd)
            scale, shape, label = 1.0, [B * HEADS, f, n, HD], f"BH{B * HEADS}"
            bound, bound_by = bound_ms(name, B * HEADS, f, n, D=HD)
        else:
            x = grid_inputs(B, f, n, torch.bfloat16, seed=B + f - 4, grad=bwd,
                            D=D)
            H = VITL_HEADS if D == VITL_DIM else HEADS
            lay = sdpa_layout(x, name.split("_")[0], grad=bwd, H=H)
            scale, shape, label = SCALE, [B, f, n, D], f"B{B} D{D}"
            bound, bound_by = bound_ms(name, B, f, n, D=D)
        t_plain = median_ms(lambda: call(plain, name, x))
        t_kernel = median_ms(lambda: call(kernel, name, x))
        t_device = device_ms(lambda: call(kernel, name, x))

        def sdpa():
            return F.scaled_dot_product_attention(*lay[:3], scale=scale)

        t_lib = median_ms(sdpa)
        t_lib_device = device_ms(sdpa, library=True)
        if bwd:
            def sdpa_grad():
                return torch.autograd.grad(sdpa(), lay[:3], lay[3])

            t_lib = median_ms(sdpa_grad) - t_lib
            t_lib_device = device_ms(sdpa_grad, library=True) - t_lib_device
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
              f"{t_lib:.4f} ms (device {t_lib_device:.4f} ms), bound "
              f"{bound:.4f} ms ({bound_by}) [{smi}]", flush=True)
        if name in REDESIGNED and (B, f, n) == TIMED:
            print(f"redesigned {name} bf16 {label} f{f} n{n}: "
                  f"{t_kernel:.4f} ms, device {t_device:.4f} ms (scalar "
                  f"body {REDESIGNED[name]:.4f} ms in PERF.md), SDPA "
                  f"{t_lib:.4f} ms ({t_kernel / t_lib:.2f}x SDPA), bound "
                  f"{bound:.4f} ms ({bound / t_kernel:.1%} of the event "
                  f"time, {bound / t_device:.1%} of the device time) "
                  f"[{smi}]", flush=True)
        del x, lay
        return {"ms": t_kernel, "device_ms": t_device, "plain_ms": t_plain,
                "library_ms": t_lib, "library_device_ms": t_lib_device,
                "bound_ms": bound, "bound_by": bound_by,
                "max_abs_err": err, "dtype": "bfloat16", "shape": shape}

    rows = {name: time_kernel(name, *TIMED) for name in (*KERNELS,
                                                         *HS_KERNELS)}
    # K1 and K2 at the 16-frame fine-tune shapes (phase 9's main path, and
    # phase 10's OSCC / PNR batch of 4)
    for name in KERNELS:
        rows[name]["f16"] = time_kernel(name, *TIMED_F16)
        rows[name]["f16_b4"] = time_kernel(name, *TIMED_F16_B4)
        # and at the ViT-L training step's width (phase 11's main path)
        rows[name]["vitl"] = time_kernel(name, *TIMED_VITL, D=VITL_DIM)
    B, f, n = TIMED
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


def ln_bound_ms(name: str, rows: int, D: int, itemsize: int = 2):
    """``(ms, 'bytes' | 'operations')``: the least time of K3's work on
    ``[rows, D]`` on an H100: the forward reads x and writes y, the
    backward reads x and dy and writes dx (the float32 parameters and row
    statistics are under 0.1% of it), over HBM bandwidth; against ~8
    (forward) or ~15 (backward) float32 operations an element over the
    float32 rate."""
    elems = rows * D
    fwd = name.endswith("fwd")
    t_bytes = (2 if fwd else 3) * elems * itemsize / PEAK_BYTES
    t_ops = (8 if fwd else 15) * elems / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_layer_norm(smi: str) -> dict:
    """Phase 3c: K3-fwd and K3-bwd against their plain twins at
    ``LN_SHAPES``, float32 and bf16 (relative L2 of y, dx, mu and rstd <=
    1e-5 at float32 and, for y and dx, 2e-3 at bf16: one rounding from
    float32 values that agree to ~1e-6; dscale and dbias, float32 sums, <=
    1e-5 at both); two K3-bwd launches must give the same bits; then, at
    each bf16 shape, kernel, device, plain and library times
    (``F.layer_norm`` with the parameters in the activation dtype, and
    ``autograd.grad`` of it minus its forward) and the bound.  Returns the
    rows, the first shape's at the top."""
    import torch
    import torch.nn.functional as F

    from egovlp_tpu_torch.kernels import fused_ln

    def inputs(rows, D, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = (torch.randn(rows, D, device="cuda", generator=g) * 2 + 0.5)
        dy = torch.randn(rows, D, device="cuda", generator=g)
        scale = 1 + 0.3 * torch.randn(D, device="cuda", generator=g)
        bias = torch.randn(D, device="cuda", generator=g)
        return x.to(dtype), scale, bias, dy.to(dtype)

    def rel(got, want):
        got, want = got.double(), want.double()
        return ((got - want).norm() / want.norm()).item()

    def check_ln(x, scale, bias, dy, label):
        y, mu, rstd = fused_ln.layer_norm_fwd(x, scale, bias, 1e-6)
        grads = fused_ln.layer_norm_bwd(x, scale, mu, rstd, dy)
        torch.cuda.synchronize()
        wy, wmu, wrstd = fused_ln.layer_norm_fwd_plain(x, scale, bias, 1e-6)
        want = fused_ln.layer_norm_bwd_plain(x, scale, wmu, wrstd, dy)
        t = 1e-5 if x.dtype == torch.float32 else 2e-3
        outs = {"y": (y, wy, t), "mu": (mu, wmu, 1e-5),
                "rstd": (rstd, wrstd, 1e-5), "dx": (grads[0], want[0], t),
                "dscale": (grads[1], want[1], 1e-5),
                "dbias": (grads[2], want[2], 1e-5)}
        errs = {k: (rel(g, w), (g.double() - w.double()).abs().max().item())
                for k, (g, w, _) in outs.items()}
        ok = all(errs[k][0] <= lim and bool(torch.isfinite(g).all())
                 for k, (g, _, lim) in outs.items())
        print(f"check layer_norm {str(x.dtype)[6:]} {label}: rel_l2/max_abs "
              + " ".join(f"{k} {r:.1e}/{a:.2e}" for k, (r, a) in errs.items())
              + f" (tol {t:.0e}, dscale/dbias 1e-5) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, "K3 disagrees with its plain version")
        return (max(errs[k][1] for k in ("y", "mu", "rstd")),
                max(errs[k][1] for k in ("dx", "dscale", "dbias")))

    for rows, D in LN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            check_ln(*inputs(rows, D, dtype, rows + D), f"[{rows}, {D}]")
    out = {}
    for rows, D in LN_SHAPES:
        x, scale, bias, dy = inputs(rows, D, torch.bfloat16, D)
        err_f, err_b = check_ln(x, scale, bias, dy,
                                f"[{rows}, {D}] (timed inputs)")
        _, mu, rstd = fused_ln.layer_norm_fwd(x, scale, bias, 1e-6)
        again = [fused_ln.layer_norm_bwd(x, scale, mu, rstd, dy)
                 for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*again))
        print(f"check layer_norm_bwd bf16 [{rows}, {D}]: two launches "
              f"{'give the same bits' if same else 'DIFFER'}", flush=True)
        check(same, "layer_norm_bwd is not deterministic")
        sc, bi = scale.to(x.dtype), bias.to(x.dtype)
        leaves = [t.clone().requires_grad_() for t in (x, sc, bi)]

        def lib_fwd():
            return F.layer_norm(x, (D,), sc, bi, 1e-6)

        def lib_grad():
            return torch.autograd.grad(
                F.layer_norm(leaves[0], (D,), *leaves[1:], 1e-6), leaves, dy)

        lib_f, lib_f_device = median_ms(lib_fwd), device_ms(lib_fwd,
                                                             library=True)
        lib_b = median_ms(lib_grad) - lib_f
        lib_b_device = device_ms(lib_grad, library=True) - lib_f_device
        calls = {
            "layer_norm_fwd": (
                lambda: fused_ln.layer_norm_fwd(x, scale, bias, 1e-6),
                lambda: fused_ln.layer_norm_fwd_plain(x, scale, bias, 1e-6),
                lib_f, lib_f_device, err_f),
            "layer_norm_bwd": (
                lambda: fused_ln.layer_norm_bwd(x, scale, mu, rstd, dy),
                lambda: fused_ln.layer_norm_bwd_plain(x, scale, mu, rstd, dy),
                lib_b, lib_b_device, err_b)}
        for name, (kernel, plain, t_lib, t_lib_device, err) in calls.items():
            t_plain = median_ms(plain)
            t_kernel = median_ms(kernel)
            t_device = device_ms(kernel)
            bound, bound_by = ln_bound_ms(name, rows, D)
            print(f"time {name} bf16 [{rows}, {D}]: kernel {t_kernel:.4f} ms "
                  f"(device {t_device:.4f} ms), plain {t_plain:.4f} ms, "
                  f"library {t_lib:.4f} ms (device {t_lib_device:.4f} ms), "
                  f"bound {bound:.4f} ms ({bound_by}) [{smi}]", flush=True)
            row = {"ms": t_kernel, "device_ms": t_device, "plain_ms": t_plain,
                   "library_ms": t_lib, "library_device_ms": t_lib_device,
                   "bound_ms": bound, "bound_by": bound_by,
                   "max_abs_err": err, "dtype": "bfloat16",
                   "shape": [rows, D]}
            if name in out:
                out[name].setdefault("other_shapes", []).append(row)
            else:
                out[name] = row
        del x, scale, bias, dy, mu, rstd, again, leaves
    return out


def serving_setup(tmp: Path) -> tuple:
    """The serving model of phases 4 and 12: ``configs/eval/egomcq.json`` at
    full width in bf16 on seeded random weights, with a vocabulary in
    ``tmp``; returns ``(config, model, tokenizer)``."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.io.config import load_config

    vocab = tmp / "vocab.txt"
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
    return config, model, build.build_tokenizer(config, 30)


def phase_slice(ca, smi: str) -> tuple:
    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.serving import Embedder, serve

    tmp = tempfile.TemporaryDirectory()
    config, model, tok = serving_setup(Path(tmp.name))
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
    check(counts["layer_norm_fwd"] > 0 and counts["layer_norm_bwd"] == 0,
          "serving: K3-fwd never launched, or K3-bwd launched")
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


def train_setup(steps_per_epoch: int = 3, global_sim: str = "gather"):
    """Phase 5's training set-up, shared by phase 8: the architecture of
    ``configs/pt/egoclip.json`` with random time attention, the AdamW
    schedule and the EgoClip step (``global_sim``: its similarity)."""
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
        temperature=float(loss_args.get("temperature", 0.05)),
        global_sim=global_sim)
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
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    trainer.train(model, opt)
    counts = dict(ca.launches)
    # ------------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    n_steps = epochs * steps_per_epoch
    print(f"training launches over {n_steps} steps: {counts}", flush=True)
    # 12 blocks: every block runs both forward kernels and the time
    # backward; the last block's space-attention patch outputs reach no
    # loss (the tower returns the CLS token), so autograd skips that
    # block's space backward: 11 a step
    per_step = {name: 12 for name in KERNELS}
    per_step["space_attention_bwd"] = 11
    per_step.update(ln_per_step(cfg.video.depth, cfg.text.n_layers))
    for name in (*KERNELS, *LN_KERNELS):
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
          f"{loop_ms:.2f} ms ({32 / loop_ms * 1e3:.1f} clips/s); peak "
          f"memory of the run {peak / 2**30:.2f} GiB [{smi}]", flush=True)

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
    k3 = [e for e in rows if "k3::" in e.key]
    k3_ms = sum(e.self_device_time_total for e in k3) / 1e3 / n
    print(f"profile {label}: K3 (LayerNorm kernels) {k3_ms:.3f} ms/call, "
          f"{sum(e.count for e in k3) / n:.0f} launches/call, "
          f"{k3_ms / busy if busy else 0.0:.1%} of the device busy time "
          f"[{smi}]", flush=True)


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


def timed_step_maker(make, ends: list, losses: list):
    """The step factory ``make`` wrapped so that every step it makes
    records a CUDA event after the step in ``ends`` and its loss in
    ``losses`` (this script's instrumentation)."""
    import torch

    def maker(**kw):
        step = make(**kw)

        def timed(model, optimizer, batch, generator):
            loss = step(model, optimizer, batch, generator)
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            losses.append(loss)
            return loss
        return timed
    return maker


@contextlib.contextmanager
def loader_waits():
    """Within the block, every ``Loader`` records the time each batch took
    to come out of it, by its dataset's split: yields ``{split: [seconds,
    ...]}``."""
    from egovlp_tpu_torch.data.pipeline import Loader

    epoch_fn, waits = Loader.epoch, {}

    def timed_epoch(self, epoch=0):
        it = epoch_fn(self, epoch)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.setdefault(self.dataset.cfg.split, []).append(
                time.perf_counter() - t0)
            yield batch

    Loader.epoch = timed_epoch
    try:
        yield waits
    finally:
        Loader.epoch = epoch_fn


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
    make_step, evaluate = (recipes.make_egoclip_train_step,
                           recipes.evaluate_egomcq)
    stack = contextlib.ExitStack()
    waits = stack.enter_context(loader_waits())

    def timed_evaluate(model, loader, input_res=224):
        t0, w0 = time.perf_counter(), len(waits.setdefault("val", []))
        m = evaluate(model, loader, input_res)
        vals.append((m, len(loader.dataset), time.perf_counter() - t0,
                     sum(waits["val"][w0:])))
        return m

    recipes.make_egoclip_train_step = timed_step_maker(make_step, ends,
                                                       losses)
    recipes.evaluate_egomcq = timed_evaluate
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
        for name, c in attention_counts(counts).items():
            want = (per_step[name] * n_steps if name in KERNELS else 0) + (
                12 * passes if name in FWD else 0)
            check(c == want, f"{name}: {c} launches in cli.train, expected "
                             f"{want}")
        for name, c in ln_per_step(12, 6).items():  # and the validations'
            check(counts[name] >= c * n_steps, f"{name}: {counts[name]} "
                  f"launches in cli.train, fewer than the steps' {c * n_steps}")
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
        stack.close()
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
    training step (phase 5), no K4 / K5, and phase 5's K3 launches."""
    for name, c in ln_per_step(12, 6).items():
        check(counts[name] == c * n_steps,
              f"{label}: {name} {counts[name]} launches, expected "
              f"{c * n_steps}")
    for name, c in attention_counts(counts).items():
        per_step = 11 if name == "space_attention_bwd" else 12
        want = per_step * n_steps if name in KERNELS else 0
        check(c == want, f"{label}: {name} {c} launches, expected {want}")


def ring_vs_gather(arch, sched, initial: dict, batch: dict, device) -> dict:
    """One DDP step each of the gather and the ring EgoClip step (phase 5's
    architecture, AdamW) from ``initial`` on this rank's ``batch``, in the
    current process group: the losses, and the cosine and largest
    difference of the two parameter updates."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.train.recipes import data_parallel, step_generator
    from egovlp_tpu_torch.train.state import make_optimizer

    losses, updates = {}, {}
    for sim in ("gather", "ring"):
        _, _, step = train_setup(global_sim=sim)
        model, _ = build.build_model(arch, device)
        model.load_state_dict(initial)
        opt, _ = make_optimizer(model, **sched)
        losses[sim] = float(step(data_parallel(model, device), opt, batch,
                                 step_generator(DEVICE, 0, 1, 0)))
        updates[sim] = torch.cat([(p.detach().cpu() - initial[k]).flatten()
                                  for k, p in model.state_dict().items()])
        del model, opt
        torch.cuda.empty_cache()
    u_cos = cosine(updates["ring"], updates["gather"])
    d_param = (updates["ring"] - updates["gather"]).abs().max().item()
    d_loss = abs(losses["ring"] - losses["gather"])
    return {"losses": losses, "update_cos": u_cos, "d_loss": d_loss,
            "text": f"losses {losses} (diff {d_loss:.3e}, tol "
                    f"{DDP_LOSS_TOL}); update cosine {u_cos:.6f} (>= "
                    f"{DDP_UPDATE_COS}), max abs diff {d_param:.3e}"}


def check_ring(ring: dict, label: str) -> None:
    """Phase 8's limits on ``ring_vs_gather``."""
    check(ring["d_loss"] <= DDP_LOSS_TOL
          and ring["update_cos"] >= DDP_UPDATE_COS,
          f"{label}: the ring step is not the gather step")


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
        torch.cuda.empty_cache()
        ring = ring_vs_gather(arch, sched, ref["initial"],
                              to_device(ref["batches"][0], DEVICE), device)
        print(f"ddp world 1 (nccl) ring vs gather, one step on phase 5's "
              f"first batch: {ring['text']}", flush=True)
        check_ring(ring, "ddp world 1")
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
        for r, x in enumerate(res):
            print(f"ddp world 2 rank {r} ring vs gather, one step on its "
                  f"rows of phase 5's first batch: {x['ring']['text']}",
                  flush=True)
            check_ring(x["ring"], f"ddp world 2 rank {r}")
        check(res[0]["ring"]["losses"] == res[1]["ring"]["losses"],
              "the ranks' ring losses differ")
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
        to_device,
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
    initial = torch.load(out / "initial.pt", weights_only=True)
    ring = ring_vs_gather(arch, sched, initial,
                          to_device(batches[0], device), device)
    del initial
    torch.cuda.empty_cache()
    metrics = cli_eval.main(ddp_eval_args(data))
    (out / f"rank{rank}.json").write_text(json.dumps({
        "losses": losses, "step_ms": times, "launches": launches,
        "missing": missing, "metrics": metrics, "ring": ring}))
    dist.destroy_process_group()
    print(f"ddp worker rank {rank} of {world}: done", flush=True)


# ---- phase 9: fine-tuning at 16 frames ---------------------------------------

FT_VERBS = ["wash", "cut", "open", "take", "put"]
FT_NOUNS = ["cup", "onion", "door", "knife", "pan", "lid"]
FT_VOCAB = CLI_VOCAB + ["wash", "cut", "open", "take", "put", "onion", "pan",
                        "lid", "someone", "is", "sitting", "holding",
                        "drinking", "from", "chair", "phone"]
FT_CLIPS = {"train": 64, "test": 32}  # EPIC clips a split
FT_FRAMES = 240                       # JPEGs in each EPIC frame directory
CH_VIDEOS = 16                        # CharadesEgo videos (90 frames, 30 fps)
CH_CLASSES = ["someone is holding a cup", "someone is opening a door",
              "someone is sitting in a chair", "someone is drinking from "
              "a cup", "someone is holding a phone"]
# phase 9's limits against the plain-attention model on the first EPIC
# step (bf16, 16 frames; PERF.md section 6 holds the predictions)
FT_LOSS_TOL, FT_GRAD_COS, FT_QKV_COS = 2e-2, 0.999, 0.99


def write_epic_tree(root: Path) -> None:
    """Phase 9's synthetic EPIC-Kitchens MIR tree (see the module notes)."""
    import cv2

    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[0:256, 0:456]
    vids = ["P01_01", "P02_03"]
    for v, vid in enumerate(vids):
        d = root / vid[:3] / "rgb_frames" / vid
        d.mkdir(parents=True)
        for i in range(1, FT_FRAMES + 1):
            img = np.stack([(xx // 2 + yy // 2 + 50 * v + i) % 256,
                            (yy + 2 * i + 40 * v) % 256,
                            (xx + 3 * i) % 256], -1).astype(np.uint8)
            check(cv2.imwrite(str(d / f"frame_{i:010d}.jpg"), img),
                  f"cv2 cannot write a JPEG in {d}")
    (root / "relevancy").mkdir()
    for split, n in FT_CLIPS.items():
        lines = ["narration_id,participant_id,video_id,narration_timestamp,"
                 "start_timestamp,stop_timestamp,start_frame,stop_frame,"
                 "narration,verb_class,noun_class"]
        caps = []
        for i in range(n):
            vid = vids[i % 2]
            start = int(rng.integers(1, FT_FRAMES - 80))
            stop = start + int(rng.integers(24, 80))
            verb, noun = int(rng.integers(5)), int(rng.integers(6))
            caps.append((verb, noun, f"{vid}_{split}{i}"))
            lines.append(f"{vid}_{split}{i},{vid[:3]},{vid[:3]}/rgb_frames/"
                         f"{vid},00:00:01.00,00:00:01.00,00:00:02.00,"
                         f"{start},{stop},{FT_VERBS[verb]} the "
                         f"{FT_NOUNS[noun]},{verb},{noun}")
        (root / f"EPIC_100_retrieval_{split}.csv").write_text(
            "\n".join(lines) + "\n")
        # one sentence a caption, named by its first clip; graded relevancy
        # 1 (same verb and noun), 0.5 (one of them), 0
        sentences = {}
        for verb, noun, nid in caps:
            sentences.setdefault((verb, noun), nid)
        (root / f"EPIC_100_retrieval_{split}_sentence.csv").write_text(
            "narration_id,narration\n" + "".join(
                f"{nid},{FT_VERBS[v]} the {FT_NOUNS[o]}\n"
                for (v, o), nid in sentences.items()))
        rel = np.array([[0.5 * (v == sv) + 0.5 * (o == so)
                         for sv, so in sentences] for v, o, _ in caps])
        with open(root / "relevancy" /
                  f"caption_relevancy_EPIC_100_retrieval_{split}.pkl",
                  "wb") as f:
            pickle.dump(rel, f)
    (root / "vocab.txt").write_text("\n".join(FT_VOCAB))


def write_charades_tree(root: Path) -> None:
    """Phase 9's synthetic CharadesEgo tree (see the module notes)."""
    import cv2

    rng = np.random.default_rng(10)
    root.mkdir(parents=True)
    ids = [f"CH{v:02d}EGO" for v in range(CH_VIDEOS)]
    yy, xx = np.mgrid[0:240, 0:320]
    for v, vid in enumerate(ids):
        path = str(root / f"{vid}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (320, 240))
        check(vw.isOpened(), f"cv2 cannot write {path}")
        for t in range(90):
            vw.write(np.stack([(xx + 7 * v + 2 * t) % 256,
                               (yy + 3 * t) % 256,
                               (xx // 2 + yy // 2 + 20 * v) % 256],
                              -1).astype(np.uint8))
        vw.release()
    lines = ["id\tnarration\tcls\tt_start\tt_end"]
    for i in range(3 * CH_VIDEOS):
        c = int(rng.integers(len(CH_CLASSES)))
        start = round(float(rng.uniform(0.0, 1.5)), 2)
        lines.append(f"{ids[i % CH_VIDEOS]}\t{CH_CLASSES[c]}\tc{c:03d}\t"
                     f"{start}\t{start + 1.2:.2f}")
    (root / "metadata_train.csv").write_text("\n".join(lines) + "\n")
    lines = ["id,subject,scene,quality,relevance,verified,descriptions,"
             "actions,length"]
    for v, vid in enumerate(ids):
        acts = ";".join(f"c{int(c):03d} 0.0 2.0" for c in rng.choice(
            len(CH_CLASSES), size=v % 3, replace=False))
        lines.append(f"{vid},s{v},kitchen,5,5,Yes,someone is sitting,"
                     f"{acts},3.0")
    (root / "CharadesEgo_v1_test_only1st.csv").write_text(
        "\n".join(lines) + "\n")
    (root / "Charades_v1_classes.txt").write_text("\n".join(
        f"c{i:03d} {CH_CLASSES[i % len(CH_CLASSES)]}" for i in range(157)))


def ft_overrides(data: Path, results: Path, vocab: Path, *extra) -> list:
    """``-o`` arguments that point a fine-tune or eval config at a
    synthetic tree: strict loading, 16 decode threads, random time
    attention (see phase_slice)."""
    ov = [f"data_loader.args.data_dir={json.dumps(str(data))}",
          f"data_loader.args.meta_dir={json.dumps(str(data))}",
          "data_loader.args.num_workers=16",
          'data_loader.args.video_params.loading="strict"',
          f"arch.args.text_params.vocab={json.dumps(str(vocab))}",
          'arch.args.video_params.time_init="random"',
          f"trainer.save_dir={json.dumps(str(results))}", *extra]
    return [a for o in ov for a in ("-o", o)]


def rounded(metrics: dict) -> dict:
    return {k: round(float(v), 4) for k, v in metrics.items()}


def ft_batches(config_path: str, ov: list, n: int) -> list:
    """The first ``n`` collated batches of the config's train Loader."""
    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli.train import parse_overrides
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train.recipes import _dl_args

    config = load_config(config_path)
    parse_overrides(config, ov[1::2])
    loader = build.build_loader(_dl_args(config), "train",
                                build.build_tokenizer(config, 30))
    try:
        return [b for _, b in zip(range(n), loader.epoch(1))]
    finally:
        loader.close()


def phase_finetune(ca, smi: str, root: Path) -> dict:
    """Phase 9 in the directory ``root``; returns the kernel launches of
    the first ``cli.train`` run on ``configs/ft/epic.json``."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli import eval as cli_eval
    from egovlp_tpu_torch.cli import train as cli_train
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train import recipes
    from egovlp_tpu_torch.train.state import make_optimizer
    from egovlp_tpu_torch.train.steps import make_epic_train_step

    t0 = time.perf_counter()
    epic, charades = root / "epic", root / "charades"
    write_epic_tree(epic)
    write_charades_tree(charades)
    vocab = epic / "vocab.txt"
    print(f"finetune: EPIC tree ({sum(FT_CLIPS.values())} clips, 2 x "
          f"{FT_FRAMES} JPEGs at 456 x 256) and CharadesEgo tree "
          f"({CH_VIDEOS} mp4s) written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = {n: str(ROOT / f"configs/{n}.json") for n in (
        "ft/epic", "ft/epic_adaptive", "ft/charades", "eval/epic",
        "eval/charades")}
    ov_epic = ft_overrides(epic, root / "results", vocab)
    ov_ch = ft_overrides(charades, root / "results", vocab,
                         "charades_classes=" + json.dumps(
                             str(charades / "Charades_v1_classes.txt")))

    # ---- the first EPIC step against the plain-attention model ---------
    config = load_config(cfg["ft/epic"])
    config.override("arch.args.video_params.time_init", "random")
    arch, bs = config["arch"], config["data_loader"]["args"]["batch_size"]
    batches = ft_batches(cfg["ft/epic"], ov_epic, 3)
    check(batches[0]["frames"].shape == (bs, 16, 256, 256, 3),
          f"EPIC batch {batches[0]['frames'].shape}")
    fixed = recipes.to_device(batches[0], DEVICE)
    step = make_epic_train_step(input_res=224, margin=0.2)
    model, mcfg = build.build_model(arch, DEVICE)
    build.init_params(model, seed=0)
    check(model.video_model.dtype == torch.bfloat16 and mcfg.video.depth == 12
          and mcfg.video.embed_dim == DIM and mcfg.video.num_frames == 16
          and mcfg.text.n_layers == 6 and mcfg.projection_dim == 256,
          f"not the full-width 16-frame model: {mcfg}")
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads(m):
        loss = step(m, NoUpdate(m), fixed,
                    torch.Generator(device=DEVICE).manual_seed(1)).item()
        return loss, {k: p.grad.float() for k, p in m.named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = loss_and_grads(model)
    step_peak = torch.cuda.max_memory_allocated()
    xla_arch = copy.deepcopy(arch)
    xla_arch["args"]["video_params"]["attention_impl"] = "xla"
    ref, _ = build.build_model(xla_arch, DEVICE)
    ref.load_state_dict(initial)
    loss_x, grads_x = loss_and_grads(ref)
    del ref, initial
    model.zero_grad(set_to_none=True)
    names = sorted(grads_k)
    c_all = cosine(torch.cat([grads_k[k].flatten() for k in names]),
                   torch.cat([grads_x[k].flatten() for k in names]))
    c_qkv = min(cosine(grads_k[k], grads_x[k]) for k in names
                if k.endswith(("attn.qkv.weight", "timeattn.qkv.weight"))
                and k.startswith("video_model.blocks."))
    print(f"finetune first EPIC step (16 clips x 16 frames) vs plain "
          f"attention: loss {loss_k:.6f} vs {loss_x:.6f} (tol "
          f"{FT_LOSS_TOL}), grad cosine all {c_all:.6f} (>= {FT_GRAD_COS}), "
          f"min qkv {c_qkv:.6f} (>= {FT_QKV_COS}); peak memory of the step "
          f"{step_peak / 2**30:.2f} GiB [{smi}]", flush=True)
    check(abs(loss_k - loss_x) <= FT_LOSS_TOL,
          "the EPIC loss disagrees with the plain path")
    check(c_all >= FT_GRAD_COS, "EPIC gradients disagree with the plain path")
    check(c_qkv >= FT_QKV_COS,
          "a block's qkv gradient disagrees with the plain path")
    del grads_k, grads_x
    torch.cuda.empty_cache()

    # ---- 4 steps on one batch lower the max-margin loss; the profile ---
    opt_args = config["optimizer"]["args"]
    opt, _ = make_optimizer(
        model, base_lr=float(opt_args["lr"]),
        milestones=tuple(config["trainer"]["lr_milestones"]),
        steps_per_epoch=3, mu_dtype=opt_args.get("mu_dtype"))
    same = [step(model, opt, fixed,
                 torch.Generator(device=DEVICE).manual_seed(1)).item()
            for _ in range(4)]
    print(f"finetune 4 EPIC steps on one batch: losses "
          f"{[round(v, 5) for v in same]}", flush=True)
    check(all(np.isfinite(same)) and same[-1] < same[0],
          "the max-margin loss on a repeated batch did not fall")
    profile_steps(model, opt, step, batches, smi)
    del model, opt, fixed, batches
    torch.cuda.empty_cache()

    # instrumentation, this script's only: a CUDA event after each step,
    # each batch's time out of the Loader, and each validation's result,
    # items and time
    ends, losses, vals, embeds = [], [], [], []
    saved = {n: getattr(recipes, n) for n in (
        "make_epic_train_step", "make_charades_train_step",
        "evaluate_epic_mir", "embed_dataset", "evaluate_charades")}
    stack = contextlib.ExitStack()
    waits = stack.enter_context(loader_waits())

    def timed_eval(fn, clock):
        def run(*a, **kw):
            t, w = time.perf_counter(), len(waits.setdefault("test", []))
            out = fn(*a, **kw)
            clock.append((out, time.perf_counter() - t,
                          sum(waits["test"][w:])))
            return out
        return run

    for name in ("make_epic_train_step", "make_charades_train_step"):
        setattr(recipes, name, timed_step_maker(saved[name], ends, losses))
    recipes.embed_dataset = timed_eval(saved["embed_dataset"], embeds)
    recipes.evaluate_epic_mir = timed_eval(saved["evaluate_epic_mir"], vals)
    recipes.evaluate_charades = timed_eval(saved["evaluate_charades"], vals)
    try:
        # ---- the main path, counted -----------------------------------
        torch.cuda.reset_peak_memory_stats()
        ca.reset_launch_counts()
        model, opt = cli_train.main(["--config", cfg["ft/epic"], *ov_epic,
                                     "-o", "trainer.epochs=2",
                                     "-o", "trainer.max_samples_per_epoch=48"])
        torch.cuda.synchronize()
        counts = dict(ca.launches)
        # ----------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        print(f"finetune cli.train epic launches: {counts}", flush=True)
        check(model.video_model.dtype == torch.bfloat16
              and model.cfg.video.num_frames == 16
              and model.cfg.video.depth == 12, "not the 16-frame full model")
        n_steps = len(ends)
        passes = sum(-(-FT_CLIPS["test"] // bs) for _ in embeds)
        check(n_steps == 6 and len(vals) == 2 and opt.param_groups[0][
            "count"] == 6, f"{n_steps} steps, {len(vals)} validations")
        for name, c in attention_counts(counts).items():
            want = ((11 if name == "space_attention_bwd" else 12) * n_steps
                    if name in KERNELS else 0) + (
                12 * passes if name in FWD else 0)
            check(c == want, f"{name}: {c} launches in the EPIC cli.train, "
                             f"expected {want}")
        values = [float(v) for v in losses]
        print(f"finetune cli.train epic losses: "
              f"{[round(v, 5) for v in values]}", flush=True)
        check(all(np.isfinite(values)), "an EPIC loss is not finite")
        mir = {"nDCG_V2T", "nDCG_T2V", "nDCG_AVG", "mAP_V2T", "mAP_T2V",
               "mAP_AVG"}
        for m, *_ in vals:
            check(set(m) == mir and all(0.0 <= v <= 100.0
                                        for v in m.values()),
                  f"EPIC metrics {m}")
        models = root / "results" / "models"
        (run,) = (models / "EPIC_MIR_16f").iterdir()
        names = sorted(p.name for p in run.iterdir())
        check({"checkpoint-epoch1.pth", "checkpoint-epoch2.pth"} <= set(names),
              "EPIC epoch checkpoints missing")
        ckpt2, in_run = str(run / "checkpoint-epoch2.pth"), vals[1][0]
        torch.cuda.synchronize()
        loop_ms = statistics.median(a.elapsed_time(b)
                                    for a, b in zip(ends[1:], ends[2:]))
        print(f"finetune cli.train epic ({bs} clips x 16 frames a step, "
              f"decoded by the Loader): median step end to step end over "
              f"steps 2-6 {loop_ms:.2f} ms ({bs / loop_ms * 1e3:.2f} "
              f"clips/s); median wait on the Loader "
              f"{statistics.median(waits['train']) * 1e3:.2f} ms a batch; "
              f"peak memory {peak / 2**30:.2f} GiB; run dir {names} [{smi}]",
              flush=True)
        for i, ((m, sec, _), (_, esec, wait)) in enumerate(zip(vals, embeds)):
            n = FT_CLIPS["test"]
            print(f"finetune EPIC validation {i + 1}: {n} clips embedded in "
                  f"{esec:.3f} s ({n / esec:.1f} items/s, {wait:.3f} s "
                  f"waiting on the Loader), scored in {sec:.3f} s: "
                  f"{rounded(m)} [{smi}]",
                  flush=True)
        del model, opt
        torch.cuda.empty_cache()

        # ---- resume at epoch 3 --------------------------------------------
        ends.clear(), vals.clear(), embeds.clear()
        ca.reset_launch_counts()
        model, opt = cli_train.main(["--config", cfg["ft/epic"], *ov_epic,
                                     "--resume", ckpt2,
                                     "-o", "trainer.epochs=3",
                                     "-o", "trainer.max_samples_per_epoch=48"])
        (run3,) = [d for d in (models / "EPIC_MIR_16f").iterdir()
                   if d != run]
        names3 = sorted(p.name for p in run3.iterdir())
        print(f"finetune resume: launches {dict(ca.launches)}, run dir "
              f"{names3}, optimizer count {opt.param_groups[0]['count']}",
              flush=True)
        check(len(ends) == 3 and opt.param_groups[0]["count"] == 9
              and "checkpoint-epoch3.pth" in names3
              and "checkpoint-epoch2.pth" not in names3,
              "the resumed EPIC run did not train epoch 3 alone")
        del model, opt
        torch.cuda.empty_cache()

        # ---- cli.eval on the epoch-2 checkpoint -----------------------------
        got = cli_eval.main(["--config", cfg["eval/epic"], "--checkpoint",
                             ckpt2, *ov_epic])
        dual = cli_eval.main(["--config", cfg["eval/epic"], "--checkpoint",
                              ckpt2, "--dual_softmax", *ov_epic])
        print(f"finetune cli.eval epic on epoch 2: cosine {rounded(got)}; "
              f"dual-softmax {rounded(dual)}; in-run (cosine) "
              f"{rounded(in_run)}; equal: {got == in_run}", flush=True)
        check(got == in_run, "cli.eval disagrees with the in-run validation")
        check(set(dual) == mir and all(0.0 <= v <= 100.0
                                       for v in dual.values()),
              f"dual-softmax metrics {dual}")

        # ---- the adaptive loss with dual-softmax validation -----------------
        vals.clear(), ends.clear(), losses.clear()
        cli_train.main(["--config", cfg["ft/epic_adaptive"], *ov_epic,
                        "-o", "trainer.epochs=1",
                        "-o", "trainer.max_samples_per_epoch=48"])
        print(f"finetune cli.train epic_adaptive: losses "
              f"{[round(float(v), 5) for v in losses]}, dual-softmax "
              f"validation {rounded(vals[0][0])}", flush=True)
        check(len(losses) == 3 and all(np.isfinite([float(v) for v in
                                                     losses])),
              "adaptive EPIC losses")
        check(set(vals[0][0]) == mir and all(
            0.0 <= v <= 100.0 for v in vals[0][0].values()),
              "adaptive EPIC metrics")

        # ---- CharadesEgo: train one epoch, validate, cli.eval ---------------
        vals.clear(), ends.clear(), losses.clear()
        cli_train.main(["--config", cfg["ft/charades"], *ov_ch,
                        "-o", "trainer.epochs=1",
                        "-o", "trainer.max_samples_per_epoch=48"])
        (m, sec, wait), = vals
        print(f"finetune cli.train charades: losses "
              f"{[round(float(v), 5) for v in losses]}; validation {m}: "
              f"{CH_VIDEOS} videos in {sec:.3f} s ({CH_VIDEOS / sec:.1f} "
              f"items/s, {wait:.3f} s waiting on the Loader) [{smi}]",
              flush=True)
        check(len(losses) == 3 and all(np.isfinite([float(v) for v in
                                                     losses])),
              "Charades losses")
        check(set(m) == {"mAP"} and 0.0 <= m["mAP"] <= 100.0,
              f"Charades metrics {m}")
        (ch_run,) = (models / "CharadesEgo_16f").iterdir()
        got = cli_eval.main(["--config", cfg["eval/charades"], "--checkpoint",
                             str(ch_run / "checkpoint-epoch1.pth"), *ov_ch])
        print(f"finetune cli.eval charades on epoch 1: {got}, in-run {m}",
              flush=True)
        check(got == m, "Charades cli.eval disagrees with the in-run "
                        "validation")
    finally:
        for n, fn in saved.items():
            setattr(recipes, n, fn)
        stack.close()
    return counts


# ---- phase 10: Ego4D OSCC / PNR at 16 frames, NLQ / MQ features ---------------

SC_CLIPS = {"train": 16, "val": 8}  # OSCC clips a split, half state changes
SC_W, SC_H = 456, 256               # Ego4D's ego4d_256 frames
EM_SEC, EM_FPS = 20, 30             # the NLQ / MQ video: 20 s at 30 fps
EM_CLIPS = [("clip_em0", 0.0, 12.0, ["where did i put the knife", "",
                                     "who opened the door"]),
            ("clip_em1", 6.5, 20.0, ["when did i take the cup"])]
EM_VOCAB = FT_VOCAB + ["where", "did", "i", "who", "opened", "when", "knife"]
EM_COS = 0.999  # each window's cosine against the plain-attention model
SC_DESCENT_LR = 1e-6  # phase 10's falling-loss check (see sc_first_steps)


def write_fho_tree(root: Path) -> list:
    """Phase 10's synthetic Ego4D hands-and-objects tree: every clip an 8-s
    parent clip at 30 fps, 241 JPEGs at 456 x 256 named by the parent
    frame; ``fho_oscc-pnr_{train,val}.json`` as Ego4D ships them, half of
    each split state changes with a keyframe inside the clip.  Returns the
    clips' records."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:SC_H, 0:SC_W]
    clips, jobs = {}, []
    for split, n in SC_CLIPS.items():
        clips[split] = []
        for i in range(n):
            c = len(jobs)
            state = i % 2 == 0
            start_sec = 10.0 * c + 2.0
            start_f = int(start_sec * 30)
            pnr = start_f + int(rng.integers(20, 220)) if state else None
            uid = f"{split}_{i:02d}"
            d = root / ("frames_jpeg" if state else "frames_jpeg_neg") / uid
            d.mkdir(parents=True)
            jobs.append((d, c, start_f))
            clips[split].append({
                "unique_id": uid, "video_uid": f"v{c // 4}", "clip_id": c,
                "state_change": state, "clip_pnr_frame": pnr and pnr - start_f,
                "parent_pnr_frame": pnr, "clip_start_sec": 0.0,
                "clip_end_sec": 8.0, "parent_start_sec": start_sec,
                "parent_end_sec": start_sec + 8.0, "clip_start_frame": 0,
                "clip_end_frame": 240, "parent_start_frame": start_f,
                "parent_end_frame": start_f + 240})
        (root / f"fho_oscc-pnr_{split}.json").write_text(json.dumps(
            {"version": "1", "clips": clips[split]}))

    def write(job):
        d, c, start_f = job
        for fn in range(start_f, start_f + 241):
            img = np.stack([(xx // 2 + yy // 2 + 30 * c + fn) % 256,
                            (yy + 2 * fn + 20 * c) % 256,
                            (xx + 3 * fn) % 256], -1).astype(np.uint8)
            check(cv2.imwrite(str(d / f"{fn}.jpeg"), img),
                  f"cv2 cannot write a JPEG in {d}")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))
    (root / "vocab.txt").write_text("\n".join(FT_VOCAB))
    return clips["train"] + clips["val"]


def write_em_tree(root: Path) -> None:
    """Phase 10's synthetic Ego4D episodic-memory tree: one 20-s mp4 at 30
    fps and 456 x 256 written with OpenCV, and ``nlq_val.json`` /
    ``moments_val.json`` with two clips of it and three queries (and an
    empty one, which the dataset drops)."""
    import cv2

    root.mkdir(parents=True)
    path = str(root / "vid_em.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), EM_FPS,
                         (SC_W, SC_H))
    check(vw.isOpened(), f"cv2 cannot write {path}")
    yy, xx = np.mgrid[0:SC_H, 0:SC_W]
    for t in range(EM_SEC * EM_FPS):
        vw.write(np.stack([(xx + 2 * t) % 256, (yy + 3 * t) % 256,
                           (xx // 2 + yy // 2 + t) % 256],
                          -1).astype(np.uint8))
    vw.release()
    anno = {"version": "1", "videos": [{"video_uid": "vid_em", "clips": [
        {"clip_uid": uid, "video_start_sec": s0, "video_end_sec": s1,
         "annotations": [{"language_queries": [{"query": q}
                                               for q in queries]}]}
        for uid, s0, s1, queries in EM_CLIPS]}]}
    for name in ("nlq_val.json", "moments_val.json"):
        (root / name).write_text(json.dumps(anno))
    (root / "vocab.txt").write_text("\n".join(EM_VOCAB))


def sc_first_steps(task: str, cfg_path: str, ov: list, smi: str) -> None:
    """The first step of ``task`` at full width (batch 4 x 16 frames from
    its train Loader) against the plain-attention model, the text tower
    bit-equal after AdamW steps, and a loss falling over 4 steps on that
    batch; a profile of 3 OSCC steps."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train import recipes
    from egovlp_tpu_torch.train.state import make_optimizer
    from egovlp_tpu_torch.train.steps import (
        make_oscc_train_step,
        make_pnr_train_step,
    )

    config = load_config(cfg_path)
    config.override("arch.args.video_params.time_init", "random")
    arch, bs = config["arch"], config["data_loader"]["args"]["batch_size"]
    batches = ft_batches(cfg_path, ov, 3)
    check(batches[0]["frames"].shape == (bs, 16, 256, 256, 3),
          f"{task} batch {batches[0]['frames'].shape}")
    fixed = recipes.to_device(batches[0], DEVICE)
    make = make_oscc_train_step if task == "oscc" else make_pnr_train_step
    step = make(input_res=224)
    model, mcfg = build.build_model(arch, DEVICE)
    build.init_params(model, seed=0)
    heads = 2 if task == "oscc" else 16
    check(model.video_model.dtype == torch.bfloat16 and mcfg.video.depth == 12
          and mcfg.video.embed_dim == DIM and mcfg.video.num_frames == 16
          and mcfg.projection_dim == heads,
          f"not the full-width 16-frame {task} model: {mcfg}")
    initial = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads(m):
        loss = step(m, NoUpdate(m), fixed,
                    torch.Generator(device=DEVICE).manual_seed(1)).item()
        return loss, {k: p.grad.float() for k, p in m.named_parameters()
                      if p.grad is not None}

    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = loss_and_grads(model)
    step_peak = torch.cuda.max_memory_allocated()
    text = [k for k, _ in model.named_parameters()
            if k.startswith(("text_model.", "txt_proj."))]
    check(text and not set(text) & set(grads_k),
          f"{task}: the text tower got a gradient")
    xla_arch = copy.deepcopy(arch)
    xla_arch["args"]["video_params"]["attention_impl"] = "xla"
    ref, _ = build.build_model(xla_arch, DEVICE)
    ref.load_state_dict(initial)
    loss_x, grads_x = loss_and_grads(ref)
    del ref
    model.zero_grad(set_to_none=True)
    names = sorted(grads_k)
    check(names == sorted(grads_x), f"{task}: other parameters got gradients")
    c_all = cosine(torch.cat([grads_k[k].flatten() for k in names]),
                   torch.cat([grads_x[k].flatten() for k in names]))
    c_qkv = min(cosine(grads_k[k], grads_x[k]) for k in names
                if k.endswith(("attn.qkv.weight", "timeattn.qkv.weight"))
                and k.startswith("video_model.blocks."))
    print(f"oscc_pnr first {task} step ({bs} clips x 16 frames) vs plain "
          f"attention: loss {loss_k:.6f} vs {loss_x:.6f} (tol "
          f"{FT_LOSS_TOL}), grad cosine all {c_all:.6f} (>= {FT_GRAD_COS}), "
          f"min qkv {c_qkv:.6f} (>= {FT_QKV_COS}); {len(names)} parameters "
          f"with a gradient, {len(text)} text ones without; peak memory of "
          f"the step {step_peak / 2**30:.2f} GiB [{smi}]", flush=True)
    check(abs(loss_k - loss_x) <= FT_LOSS_TOL,
          f"the {task} loss disagrees with the plain path")
    check(c_all >= FT_GRAD_COS,
          f"{task} gradients disagree with the plain path")
    check(c_qkv >= FT_QKV_COS,
          f"a block's qkv gradient disagrees with the plain path ({task})")
    del grads_k, grads_x

    opt_args = config["optimizer"]["args"]

    def four_steps(lr):
        model.load_state_dict(initial)
        opt, _ = make_optimizer(
            model, base_lr=lr,
            milestones=tuple(config["trainer"]["lr_milestones"]),
            steps_per_epoch=3, mu_dtype=opt_args.get("mu_dtype"))
        return opt, [step(model, opt, fixed,
                          torch.Generator(device=DEVICE).manual_seed(1))
                     .item() for _ in range(4)]

    # at the config's 3e-5 AdamW's sign-like first steps overshoot on
    # random weights (the loss of a repeated batch rose and fell again,
    # PERF.md section 6); at SC_DESCENT_LR the steps are small enough for
    # the loss to descend
    _, at_config = four_steps(float(opt_args["lr"]))
    opt, same = four_steps(SC_DESCENT_LR)
    moved = [k for k in text if not torch.equal(
        model.get_parameter(k).detach(), initial[k])]
    print(f"oscc_pnr 4 {task} steps on one batch: losses at lr "
          f"{opt_args['lr']} {[round(v, 5) for v in at_config]}, at lr "
          f"{SC_DESCENT_LR} {[round(v, 5) for v in same]}; text parameters "
          f"moved: {len(moved)} of {len(text)}", flush=True)
    check(all(np.isfinite(at_config + same)), f"a {task} loss is not finite")
    check(same[-1] < same[0],
          f"the {task} loss on a repeated batch did not fall")
    check(not moved, f"{task} steps moved the text tower: {moved[:3]}")
    if task == "oscc":
        profile_steps(model, opt, step, batches, smi)
    del model, opt, fixed, batches, initial
    torch.cuda.empty_cache()


def phase_oscc_pnr(ca, smi: str, root: Path) -> dict:
    """Phase 10 (a) in the directory ``root``; returns the kernel launches
    of the two counted ``cli.train`` runs (OSCC and PNR), summed."""
    import torch

    from egovlp_tpu_torch.cli import eval as cli_eval
    from egovlp_tpu_torch.cli import train as cli_train
    from egovlp_tpu_torch.train import recipes

    t0 = time.perf_counter()
    data = root / "fho"
    clips = write_fho_tree(data)
    print(f"oscc_pnr: Ego4D hands-and-objects tree ({len(clips)} clips x "
          f"241 JPEGs at {SC_W} x {SC_H}) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_val = {"oscc": SC_CLIPS["val"], "pnr": SC_CLIPS["val"] // 2}
    total = dict.fromkeys(ca.launches, 0)
    ends, losses, vals = [], [], []
    saved = {n: getattr(recipes, n) for n in (
        "make_oscc_train_step", "make_pnr_train_step", "evaluate_oscc",
        "evaluate_pnr")}
    stack = contextlib.ExitStack()
    waits = stack.enter_context(loader_waits())

    def timed_eval(fn):
        def run(*a, **kw):
            t, w = time.perf_counter(), len(waits.setdefault("val", []))
            out = fn(*a, **kw)
            vals.append((out, time.perf_counter() - t,
                         sum(waits["val"][w:])))
            return out
        return run

    for name in ("make_oscc_train_step", "make_pnr_train_step"):
        setattr(recipes, name, timed_step_maker(saved[name], ends, losses))
    for name in ("evaluate_oscc", "evaluate_pnr"):
        setattr(recipes, name, timed_eval(saved[name]))
    try:
        for task in ("oscc", "pnr"):
            cfg = {k: str(ROOT / f"configs/{k}/{task}.json")
                   for k in ("ft", "eval")}
            ov = ft_overrides(data, root / "results", data / "vocab.txt")
            sc_first_steps(task, cfg["ft"], ov, smi)
            key = "accuracy" if task == "oscc" else "keyframe_distance"
            # 12 samples an epoch: 3 steps (PNR's 8 state-change clips
            # cycle, as the reference's inf_loop stretches an epoch)
            steps_per_epoch = 3
            # ---- the main path, counted ----------------------------------
            ends.clear(), losses.clear(), vals.clear()
            waits.clear()
            torch.cuda.reset_peak_memory_stats()
            ca.reset_launch_counts()
            model, opt = cli_train.main([
                "--config", cfg["ft"], *ov, "-o", "trainer.epochs=2",
                "-o", "trainer.max_samples_per_epoch=12"])
            torch.cuda.synchronize()
            counts = dict(ca.launches)
            # --------------------------------------------------------------
            peak = torch.cuda.max_memory_allocated()
            print(f"oscc_pnr cli.train {task} launches: {counts}",
                  flush=True)
            check(model.video_model.dtype == torch.bfloat16
                  and model.cfg.video.num_frames == 16
                  and model.cfg.video.depth == 12,
                  "not the 16-frame full model")
            n_steps, passes = len(ends), 2 * -(-n_val[task] // 4)
            check(n_steps == 2 * steps_per_epoch and len(vals) == 2
                  and opt.param_groups[0]["count"] == n_steps,
                  f"{task}: {n_steps} steps, {len(vals)} validations")
            for name, c in attention_counts(counts).items():
                want = ((11 if name == "space_attention_bwd" else 12)
                        * n_steps if name in KERNELS else 0) + (
                    12 * passes if name in FWD else 0)
                check(c == want, f"{name}: {c} launches in the {task} "
                                 f"cli.train, expected {want}")
            # video only: 73 norms a tower pass, 72 in its backward
            check(counts["layer_norm_fwd"] >= 73 * n_steps
                  and counts["layer_norm_bwd"] == 72 * n_steps,
                  f"{task}: K3 launches {counts}")
            for name, c in counts.items():
                total[name] += c
            values = [float(v) for v in losses]
            print(f"oscc_pnr cli.train {task} losses: "
                  f"{[round(v, 5) for v in values]}", flush=True)
            check(all(np.isfinite(values)), f"a {task} loss is not finite")
            for m, *_ in vals:
                check(set(m) == {key} and m[key] >= 0.0 and (
                    key != "accuracy" or m[key] <= 100.0),
                      f"{task} metrics {m}")
            models = root / "results" / "models"
            run_name = "OSCC" if task == "oscc" else "PNR"
            (run,) = (models / run_name).iterdir()
            names = sorted(p.name for p in run.iterdir())
            check({"checkpoint-epoch1.pth", "checkpoint-epoch2.pth"}
                  <= set(names), f"{task} epoch checkpoints missing")
            ckpt2, in_run = str(run / "checkpoint-epoch2.pth"), vals[1][0]
            loop_ms = statistics.median(
                a.elapsed_time(b) for a, b in zip(ends[1:], ends[2:]))
            print(f"oscc_pnr cli.train {task} (4 clips x 16 frames a step, "
                  f"decoded by the Loader): median step end to step end "
                  f"over steps 2-{n_steps} {loop_ms:.2f} ms "
                  f"({4 / loop_ms * 1e3:.2f} clips/s); median wait on the "
                  f"Loader {statistics.median(waits['train']) * 1e3:.2f} ms "
                  f"a batch; peak memory {peak / 2**30:.2f} GiB; run dir "
                  f"{names} [{smi}]", flush=True)
            for i, (m, sec, wait) in enumerate(vals):
                print(f"oscc_pnr {task} validation {i + 1}: {n_val[task]} "
                      f"clips in {sec:.3f} s ({n_val[task] / sec:.1f} "
                      f"items/s, {wait:.3f} s waiting on the Loader): "
                      f"{rounded(m)} [{smi}]", flush=True)
            del model, opt
            torch.cuda.empty_cache()

            # ---- resume at epoch 3 ----------------------------------------
            ends.clear(), vals.clear()
            model, opt = cli_train.main([
                "--config", cfg["ft"], *ov, "--resume", ckpt2,
                "-o", "trainer.epochs=3",
                "-o", "trainer.max_samples_per_epoch=12"])
            (run3,) = [d for d in (models / run_name).iterdir() if d != run]
            names3 = sorted(p.name for p in run3.iterdir())
            print(f"oscc_pnr resume {task}: run dir {names3}, optimizer "
                  f"count {opt.param_groups[0]['count']}", flush=True)
            check(len(ends) == steps_per_epoch
                  and opt.param_groups[0]["count"] == 3 * steps_per_epoch
                  and "checkpoint-epoch3.pth" in names3
                  and "checkpoint-epoch2.pth" not in names3,
                  f"the resumed {task} run did not train epoch 3 alone")
            del model, opt
            torch.cuda.empty_cache()

            # ---- cli.eval on the epoch-2 checkpoint, the default split ----
            got = cli_eval.main(["--config", cfg["eval"], "--checkpoint",
                                 ckpt2, *ov])
            print(f"oscc_pnr cli.eval {task} on epoch 2 (default split): "
                  f"{got}; in-run {in_run}; equal: {got == in_run}",
                  flush=True)
            check(got == in_run, f"{task} cli.eval disagrees with the "
                                 "in-run validation")
    finally:
        for n, fn in saved.items():
            setattr(recipes, n, fn)
        stack.close()
    return total


def phase_extract(ca, smi: str, root: Path) -> dict:
    """Phase 10 (b) in the directory ``root``; returns the kernel launches
    of the counted video-mode ``cli.extract`` run."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli import extract as cli_extract
    from egovlp_tpu_torch.cli.train import parse_overrides
    from egovlp_tpu_torch.data.datasets.nlq_mq import FEATURE_FPS
    from egovlp_tpu_torch.evals import features
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train.recipes import _dl_args
    from egovlp_tpu_torch.train.steps import embed_video

    t0 = time.perf_counter()
    data = root / "em"
    write_em_tree(data)
    print(f"extract: a {EM_SEC}-s mp4 at {EM_FPS} fps, {SC_W} x {SC_H}, and "
          f"the NLQ / MQ val json written in {time.perf_counter() - t0:.1f} s",
          flush=True)
    cfg = {t: str(ROOT / f"configs/eval/{t}.json") for t in ("nlq", "mq")}
    ov = ["-o", f"data_loader.args.data_dir={json.dumps(str(data))}",
          "-o", f"data_loader.args.meta_dir={json.dumps(str(data))}",
          "-o", f"arch.args.text_params.vocab="
                f"{json.dumps(str(data / 'vocab.txt'))}",
          "-o", 'arch.args.video_params.time_init="random"']
    windows = {uid: int((s1 - s0) * FEATURE_FPS * 4) // 4
               for uid, s0, s1, _ in EM_CLIPS}
    micro = sum(-(-n // 4) for n in windows.values())
    embeds = []

    def timed_embed(model, frames, input_res=224):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = embed_video(model, frames, input_res)
        torch.cuda.synchronize()
        embeds.append((len(frames), time.perf_counter() - t))
        return out

    features.embed_video = timed_embed
    try:
        out = root / "features"
        # ---- the main path, counted --------------------------------------
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        cli_extract.main(["-c", cfg["nlq"], "--out", str(out / "video"),
                          *ov])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ca.launches)
        # ------------------------------------------------------------------
    finally:
        features.embed_video = embed_video
    n_win = sum(windows.values())
    embed_s = sum(t for _, t in embeds)
    print(f"extract cli.extract nlq video launches: {counts}; {len(embeds)} "
          f"micro-batches of up to 4 windows x 4 frames", flush=True)
    check(len(embeds) == micro, f"{len(embeds)} micro-batches, expected "
                                f"{micro}")
    for name, c in attention_counts(counts).items():
        want = 12 * micro if name in FWD else 0
        check(c == want, f"{name}: {c} launches in cli.extract, expected "
                         f"{want}")
    check(counts["layer_norm_fwd"] == 73 * micro
          and counts["layer_norm_bwd"] == 0, f"cli.extract K3 {counts}")
    print(f"extract cli.extract nlq video: {n_win} windows of 4 frames in "
          f"{wall:.3f} s ({n_win / wall:.1f} windows/s with decode and "
          f"model set-up), embedding {embed_s:.3f} s ({n_win / embed_s:.1f} "
          f"windows/s) [{smi}]", flush=True)
    feats = {uid: np.load(out / "video" / f"{uid}.npy") for uid in windows}
    for uid, n in windows.items():
        check(feats[uid].shape == (n, 256)
              and np.isfinite(feats[uid]).all(),
              f"{uid} features {feats[uid].shape}")

    # each window against the plain-attention model on the same windows
    config = load_config(cfg["nlq"])
    parse_overrides(config, ov[1::2])
    arch = copy.deepcopy(config["arch"])
    arch["args"]["video_params"]["attention_impl"] = "xla"
    ref, mcfg = build.build_model(arch, DEVICE)
    build.init_params(ref, seed=0)
    check(ref.video_model.dtype == torch.bfloat16 and mcfg.video.depth == 12
          and mcfg.video.embed_dim == DIM and mcfg.video.num_frames == 4
          and mcfg.projection_dim == 256, f"not the full-width model: {mcfg}")
    dataset = build.build_dataset(_dl_args(config), "val")
    worst = 1.0
    for i in range(len(dataset)):
        item = dataset.get(i, np.random.default_rng(0))
        uid, frames = item["meta"]["clip_uid"], item["frames"]
        n = windows[uid] * 4
        w = frames[:n].reshape(-1, 4, *frames.shape[1:])
        want = np.concatenate([embed_video(ref, w[j:j + 4]).cpu().numpy()
                               for j in range(0, len(w), 4)])
        got = feats[uid]
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        worst = min(worst, float(cos.min()))
    del ref
    torch.cuda.empty_cache()
    print(f"extract windows vs plain attention: min cosine {worst:.6f} "
          f"(>= {EM_COS})", flush=True)
    check(worst >= EM_COS, "extracted features disagree with the plain path")

    # text mode: CLS (.npy) and token level (.pt); then MQ
    ca.reset_launch_counts()
    cli_extract.main(["-c", cfg["nlq"], "--out", str(out / "text"),
                      "--subsample", "text", *ov])
    cli_extract.main(["-c", cfg["nlq"], "--out", str(out / "tokens"),
                      "--subsample", "text", "--token_level",
                      "--save_format", "pt", *ov])
    text_counts = dict(ca.launches)
    queries = [(uid, k) for uid, _, _, qs in EM_CLIPS
               for k, _ in enumerate([q for q in qs if q])]
    for uid, k in queries:
        cls = np.load(out / "text" / f"{uid}_sentence_{k}.npy")
        tok = torch.load(out / "tokens" / f"{uid}_sentence_{k}.pt",
                         weights_only=True)
        check(cls.shape == (256,) and tuple(tok.shape) == (30, 256)
              and np.isfinite(cls).all() and bool(tok.isfinite().all()),
              f"text features {cls.shape}, {tuple(tok.shape)}")
    check(not any(attention_counts(text_counts).values()),
          f"text extraction launched video kernels: {text_counts}")
    cli_extract.main(["-c", cfg["mq"], "--out", str(out / "mq"),
                      "--save_format", "pt", *ov])
    mq_cos = 1.0
    for uid, n in windows.items():
        mq = torch.load(out / "mq" / f"{uid}.pt", weights_only=True).numpy()
        check(mq.shape == (n, 256), f"MQ {uid} features {mq.shape}")
        a = feats[uid]
        mq_cos = min(mq_cos, float(((a * mq).sum(1) / (
            np.linalg.norm(a, axis=1) * np.linalg.norm(mq, axis=1))).min()))
    print(f"extract text: {len(queries)} queries, CLS [256] and tokens "
          f"[30, 256]; MQ video features vs NLQ's on the same clips: min "
          f"cosine {mq_cos:.6f}", flush=True)
    check(mq_cos >= 0.9999, "MQ features disagree with NLQ's")
    return counts


# ---- phase 11: ViT-L EgoClip pretraining ----------------------------------------

VITL_CONFIG = "configs/pt/egoclip_vitl_tp.json"
VITL_MODES = ("block", "attn", "attn_out", "mlp")
# phase 11's limits on the first step at 16 + 16 clips (all parameters'
# gradients): each recompute mode against no recompute (the same ops on the
# same inputs, so float32 sums in another order at most), and GradCache
# against the monolithic step (each micro-batch's backward sums its part)
VITL_LOSS_REL, VITL_GRAD_COS = 1e-5, 0.9999
GC_LOSS_REL, GC_GRAD_COS = 1e-4, 0.9995
VITL_DESCENT_LR = 1e-6  # the falling-loss check (as phase 10's)


def vitl_arch(remat) -> dict:
    """The architecture of the ViT-L config with random time attention and
    the recompute mode ``remat``."""
    from egovlp_tpu_torch.io.config import load_config

    config = load_config(str(ROOT / VITL_CONFIG))
    config.override("arch.args.video_params.time_init", "random")
    config.override("arch.args.video_params.remat", remat)
    return config["arch"]


def vitl_step_counts(remat, n_micro: int = 1) -> dict:
    """The kernel launches of one ViT-L EgoClip step (24 blocks, 6 text
    layers): each micro-batch's forward with grad runs K1-fwd / K2-fwd once
    a block, and again in the backward under 'attn' or 'block'; GradCache
    first embeds every micro-batch without grad; the backward runs K2-bwd
    once a block and K1-bwd in all but the last block."""
    mode = {True: "block", False: "none"}.get(remat, remat)
    per = 24 * (2 if mode in ("attn", "block") else 1)
    fwd = n_micro * per + (n_micro * 24 if n_micro > 1 else 0)
    return {"space_attention_fwd": fwd, "time_attention_fwd": fwd,
            "space_attention_bwd": 23 * n_micro,
            "time_attention_bwd": 24 * n_micro,
            **ln_per_step(24, 6, mode, n_micro)}


def big_cosine(a, b, chunk: int = 1 << 26) -> float:
    """``cosine`` in float64 chunks (a ViT-L gradient is 470M values)."""
    dot = na = nb = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
        dot, na, nb = dot + float(x @ y), na + float(x @ x), nb + float(y @ y)
    return dot / (na * nb) ** 0.5


def phase_vitl(ca, smi: str, root: Path) -> dict:
    """Phase 11 on phase 7's tree (``root / 'data'``); returns the kernel
    launches of the first ``cli.train`` run."""
    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli import train as cli_train
    from egovlp_tpu_torch.train import recipes
    from egovlp_tpu_torch.train.recipes import to_device
    from egovlp_tpu_torch.train.state import make_optimizer
    from egovlp_tpu_torch.train.steps import make_egoclip_train_step

    batch = to_device(egoclip_batch(np.random.default_rng(11)), DEVICE)
    clips = 2 * len(batch["frames"])  # 16 + 16 scene negatives

    def fresh(remat):
        """The ViT-L model with the same seeded weights for every mode."""
        model, cfg = build.build_model(vitl_arch(remat), DEVICE)
        build.init_params(model, seed=0)
        return model, cfg

    def gen(i=0):
        return torch.Generator(device=DEVICE).manual_seed(1 + i)

    def first_step(model, n_micro=1):
        """The first step's loss and gradient, and the step's peak memory
        above what was resident before it (activations and gradients)."""
        step = make_egoclip_train_step(n_micro=n_micro)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = step(model, NoUpdate(model), batch, gen()).item()
        peak = (torch.cuda.max_memory_allocated() - before) / 2**30
        return loss, flat_grads(model), peak

    # ---- each recompute mode against no recompute, at 16 + 16 clips -------
    model, cfg = fresh(False)
    check(model.video_model.dtype == torch.bfloat16
          and (cfg.video.embed_dim, cfg.video.depth, cfg.video.num_heads)
          == (VITL_DIM, 24, VITL_HEADS) and cfg.text.n_layers == 6
          and cfg.projection_dim == 256, f"not the full-width ViT-L: {cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    ref_loss, ref_g, ref_peak = first_step(model)
    print(f"vitl model: {n_params / 1e6:.1f}M parameters; no recompute, "
          f"{clips} clips: first-step loss {ref_loss:.6f}, the step's peak "
          f"above the weights {ref_peak:.2f} GiB [{smi}]", flush=True)
    del model
    torch.cuda.empty_cache()
    kept = {}
    for mode in VITL_MODES:
        model, _ = fresh(mode)
        loss, g, peak = first_step(model)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        cos = big_cosine(g, ref_g)
        print(f"vitl remat={mode!r} vs no recompute: loss {loss:.6f} "
              f"(rel diff {rel:.2e}, tol {VITL_LOSS_REL:.0e}), gradient "
              f"cosine {cos:.7f} (>= {VITL_GRAD_COS}); the step's peak above "
              f"the weights {peak:.2f} GiB (no recompute {ref_peak:.2f}) "
              f"[{smi}]", flush=True)
        check(rel <= VITL_LOSS_REL and cos >= VITL_GRAD_COS,
              f"remat={mode!r} differs from no recompute")
        if mode == "attn_out":
            kept = {"loss": loss, "g": g, "peak": peak}
        del model, g
        torch.cuda.empty_cache()
    del ref_g

    # ---- GradCache against the monolithic step (remat 'attn_out') --------
    for k in (2, 4):
        model, _ = fresh("attn_out")
        loss, g, peak = first_step(model, n_micro=k)
        rel = abs(loss - kept["loss"]) / abs(kept["loss"])
        cos = big_cosine(g, kept["g"])
        print(f"vitl grad_accum={k} (remat 'attn_out') vs the monolithic "
              f"step: loss {loss:.6f} vs {kept['loss']:.6f} (rel diff "
              f"{rel:.2e}, tol {GC_LOSS_REL:.0e}), gradient cosine "
              f"{cos:.7f} (>= {GC_GRAD_COS}); the step's peak above the "
              f"weights {peak:.2f} GiB, monolithic {kept['peak']:.2f} GiB "
              f"[{smi}]", flush=True)
        check(rel <= GC_LOSS_REL and cos >= GC_GRAD_COS,
              f"grad_accum={k} differs from the monolithic step")
        del model, g
        torch.cuda.empty_cache()
    del kept

    # ---- each mode's step at 16 + 16 clips with AdamW: time, memory,
    # launches --------------------------------------------------------------
    opt_args = dict(base_lr=3e-5, milestones=(60, 80), steps_per_epoch=3)
    for mode in (False, *VITL_MODES):
        model, _ = fresh(mode)
        opt, _ = make_optimizer(model, **opt_args)
        step = make_egoclip_train_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(model, opt, batch, gen())  # warm: AdamW's state appears
        ca.reset_launch_counts()
        times = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(model, opt, batch, gen(i + 1))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        counts = dict(ca.launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = statistics.median(times)
        print(f"vitl step remat={mode!r}, {clips} clips, AdamW: median of 3 "
              f"{ms:.2f} ms ({clips / ms * 1e3:.1f} clips/s), peak memory "
              f"{peak:.2f} GiB (weights, AdamW state and the step); "
              f"launches a step {({k: v // 3 for k, v in counts.items()})} "
              f"[{smi}]", flush=True)
        want = vitl_step_counts(mode)
        for name, c in counts.items():
            check(c == 3 * want.get(name, 0), f"vitl remat={mode!r}: {name} "
                  f"{c} launches in 3 steps, expected {3 * want.get(name, 0)}")
        if mode == "block":  # the config's own mode
            profile_calls("vitl train step (remat 'block')",
                          lambda i: step(model, opt, batch, gen(10 + i)), smi)
        del model, opt
        torch.cuda.empty_cache()

    # ---- 4 steps on one batch lower its loss -----------------------------
    model, _ = fresh("attn_out")
    opt, _ = make_optimizer(model, **{**opt_args, "base_lr": VITL_DESCENT_LR})
    step = make_egoclip_train_step()
    same = [step(model, opt, batch, gen()).item() for _ in range(4)]
    print(f"vitl 4 steps on one batch at lr {VITL_DESCENT_LR}: losses "
          f"{[round(v, 5) for v in same]}", flush=True)
    check(all(np.isfinite(same)) and same[-1] < same[0],
          "the ViT-L loss on a repeated batch did not fall")
    del model, opt, batch
    torch.cuda.empty_cache()

    # ---- cli.train on the config, as shipped but for mesh.model ----------
    data = root / "data"
    ov = [a for o in tree_overrides(data) + [
        'arch.args.video_params.time_init="random"',
        f"trainer.save_dir={json.dumps(str(root / 'vitl_results'))}",
        "mesh.model=1", "trainer.epochs=1",
        "trainer.max_samples_per_epoch=48",
        # no checkpoint: 5.7 GB of weights and AdamW state each
        "trainer.save_period=100", 'trainer.monitor="off"']
        for a in ("-o", o)]
    ends, losses, vals = [], [], []
    make_step, evaluate = (recipes.make_egoclip_train_step,
                           recipes.evaluate_egomcq)
    stack = contextlib.ExitStack()
    waits = stack.enter_context(loader_waits())

    def timed_evaluate(model, loader, input_res=224):
        vals.append(evaluate(model, loader, input_res))
        return vals[-1]

    recipes.make_egoclip_train_step = timed_step_maker(make_step, ends,
                                                       losses)
    recipes.evaluate_egomcq = timed_evaluate
    runs = (("as shipped", [], 1),
            ("grad_accum 2", ["-o", "trainer.grad_accum=2"], 2),
            ("ring", ["-o", 'loss.args.global_sim="ring"'], 1))
    first = None
    try:
        for label, extra, n_micro in runs:
            ends.clear(), losses.clear(), vals.clear()
            waits.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the main path, counted (the first run) -----------------
            ca.reset_launch_counts()
            model, opt = cli_train.main(["--config", str(ROOT / VITL_CONFIG),
                                         *ov, *extra])
            torch.cuda.synchronize()
            counts = dict(ca.launches)
            # ------------------------------------------------------------
            peak = torch.cuda.max_memory_allocated() / 2**30
            first = first or counts
            check(model.cfg.video.embed_dim == VITL_DIM
                  and model.cfg.video.depth == 24
                  and model.cfg.video.remat_mode == "block",
                  "not the ViT-L config")
            n_steps, passes = len(ends), 2 * len(vals)
            check(n_steps == 3 and len(vals) == 1
                  and opt.param_groups[0]["count"] == 3,
                  f"{label}: {n_steps} steps, {len(vals)} validations")
            want = vitl_step_counts("block", n_micro)
            for name, c in attention_counts(counts).items():
                w = want.get(name, 0) * n_steps + (24 * passes
                                                   if name in FWD else 0)
                check(c == w, f"vitl cli.train {label}: {name} {c} launches,"
                              f" expected {w}")
            for name in LN_KERNELS:
                check(counts[name] >= want[name] * n_steps,
                      f"vitl cli.train {label}: {name} {counts[name]}")
            values = [float(v) for v in losses]
            check(all(np.isfinite(values)), f"{label}: a loss is not finite")
            check(set(vals[0]) == {"Intra-video", "Inter-video"}
                  and all(0.0 <= v <= 100.0 for v in vals[0].values()),
                  f"{label}: EgoMCQ metrics {vals[0]}")
            torch.cuda.synchronize()
            loop_ms = statistics.median(a.elapsed_time(b)
                                        for a, b in zip(ends, ends[1:]))
            wait_ms = statistics.median(waits["train"]) * 1e3
            print(f"vitl cli.train ({label}): losses "
                  f"{[round(v, 5) for v in values]}; EgoMCQ {vals[0]}; "
                  f"launches {counts}; loop median step end to step end "
                  f"{loop_ms:.2f} ms ({clips / loop_ms * 1e3:.1f} clips/s), "
                  f"median Loader wait {wait_ms:.2f} ms a batch, peak memory "
                  f"{peak:.2f} GiB [{smi}]", flush=True)
            del model, opt
            torch.cuda.empty_cache()
    finally:
        recipes.make_egoclip_train_step = make_step
        recipes.evaluate_egomcq = evaluate
        stack.close()
    return first


# ---- phase 12: the AOT serving artifact -------------------------------------

AOT_BUCKETS = (1, 4, 16)
AOT_TOL = 1e-6  # artifact vs live Embedder: the same kernels, same inputs
# the fresh process of phase 12: loads the artifact with no model code,
# embeds phase 12's texts and clips, and fails if any module of
# egovlp_tpu_torch.models was imported
AOT_LOADER = """
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from egovlp_tpu_torch.data.text import WordPieceTokenizer
from egovlp_tpu_torch.io.export import ExportedEmbedder
art, weights, vocab, clips, out = sys.argv[2:7]
emb = ExportedEmbedder(art, torch.load(weights, weights_only=True),
                       WordPieceTokenizer(vocab, max_length=30), device="cuda")
np.savez(out, text=emb.embed_texts(json.loads(sys.argv[7])),
         video=emb.embed_frames(np.load(clips)))
models = sorted(m for m in sys.modules
                if m.startswith("egovlp_tpu_torch.models"))
print("aot loader: egovlp_tpu_torch.models modules", models, flush=True)
sys.exit(1 if models else 0)
"""


def op_host_costs(smi: str) -> dict:
    """Phase 12's host cost of the op registration: K3-fwd at ``[32,
    1024]`` and K1-fwd at ``[16, 4, 196, 768]``, bf16, each called through
    its registered op (``torch.ops.egovlp_torch``, the route of the
    wrappers and the autograd Functions), through its launcher directly,
    and through a ``torch.library.custom_op`` over the same launcher (the
    registration not kept): event ms (median of 20) and host us a call
    (mean of 200 calls enqueued back to back)."""
    import torch

    from egovlp_tpu_torch.kernels import cuda_attention as ca
    from egovlp_tpu_torch.kernels import fused_ln

    g = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn(32, VITL_DIM, device="cuda", generator=g).bfloat16()
    scale = torch.randn(VITL_DIM, device="cuda", generator=g)
    bias = torch.randn(VITL_DIM, device="cuda", generator=g)
    att = grid_inputs(*TIMED, torch.bfloat16, seed=12)

    # the schemas written out: this module's postponed annotations are
    # strings that custom_op cannot resolve inside a function
    ln_custom = torch.library.custom_op(
        "egovlp_smoke::layer_norm_fwd", fused_ln._fwd_cuda, mutates_args=(),
        schema="(Tensor x, Tensor scale, Tensor bias, float eps) -> "
               "(Tensor, Tensor)")
    ln_custom.register_fake(fused_ln._fwd_fake)
    k1_custom = torch.library.custom_op(
        "egovlp_smoke::space_attention_fwd",
        lambda *a: ca._fwd_cuda("space_attention_fwd", *a), mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, Tensor cls_k, Tensor cls_v, "
               "int heads, float scale) -> Tensor")
    k1_custom.register_fake(lambda q, *a: torch.empty_like(q))

    routes = {
        "layer_norm_fwd [32, 1024]": {
            "op": lambda: fused_ln.layer_norm_fwd(x, scale, bias, 1e-6),
            "launcher": lambda: fused_ln._fwd_cuda(x, scale, bias, 1e-6),
            "custom_op": lambda: ln_custom(x, scale, bias, 1e-6)},
        "space_attention_fwd [16, 4, 196, 768]": {
            "op": lambda: ca.space_attention_fwd(*att, heads=HEADS,
                                                 scale=SCALE),
            "launcher": lambda: ca._fwd_cuda("space_attention_fwd", *att,
                                             HEADS, SCALE),
            "custom_op": lambda: k1_custom(*att, HEADS, SCALE)}}
    out = {}
    for label, fns in routes.items():
        want = fns["launcher"]()
        for route, fn in fns.items():
            got = fn()
            got, ref = ((got[0], want[0]) if isinstance(got, tuple)
                        else (got, want))
            check(torch.equal(got, ref),
                  f"{label} {route}: not the launcher's bits")
        # 7 rounds of 200 calls a route, the routes' order reversed every
        # other round; the median round of each
        host = {route: [] for route in fns}
        for rnd in range(7):
            for route in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fns[route]()
                host[route].append((time.perf_counter() - t0) / 200 * 1e6)
                torch.cuda.synchronize()
        row = {route: {"ms": median_ms(fn),
                       "host_us": statistics.median(host[route])}
               for route, fn in fns.items()}
        out[label] = row
        over = {r: row[r]["host_us"] - row["launcher"]["host_us"]
                for r in ("op", "custom_op")}
        print(f"op cost {label} bf16: " + ", ".join(
            f"{r} {v['ms']:.4f} ms / {v['host_us']:.1f} us host"
            for r, v in row.items())
            + f"; op - launcher {over['op']:+.1f} us host, custom_op - "
            f"launcher {over['custom_op']:+.1f} us host [{smi}]", flush=True)
    return out


def phase_aot(ca, smi: str) -> dict:
    """Phase 12: the serving model of phase 4 exported at buckets 1, 4 and
    16 (``io/export.export_embedder``), loaded in a fresh process without
    the model code, held to the live ``Embedder``, served by ``cli.serve
    --aot``; returns the kernel launches of the artifact's requests."""
    import torch

    from egovlp_tpu_torch.io.export import ExportedEmbedder, export_embedder
    from egovlp_tpu_torch.serving import Embedder

    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    config, model, tok = serving_setup(root)
    live = Embedder(model, tok, num_frames=4, input_res=224, pre_size=256,
                    buckets=AOT_BUCKETS)
    clips = np.random.default_rng(12).integers(
        0, 256, (17, 4, 256, 256, 3), dtype=np.uint8)
    texts = {n: (TEXTS * 6)[:n] for n in (*AOT_BUCKETS, 3)}

    art = root / "embedder.zip"
    t0 = time.perf_counter()
    manifest = export_embedder(model, str(art), num_frames=4, input_res=224,
                               pre_size=256, max_length=30,
                               buckets=AOT_BUCKETS)
    export_s = time.perf_counter() - t0
    sd = model.state_dict()
    weight_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    art_bytes = art.stat().st_size
    print(f"aot export: buckets {manifest['buckets']} on "
          f"{manifest['device']} ({manifest['dtype']}) in {export_s:.1f} s; "
          f"artifact {art_bytes} bytes, weights {weight_bytes} bytes "
          f"({art_bytes / weight_bytes:.2%}) [{smi}]", flush=True)
    check(manifest["device"] == "cuda" and art_bytes < 0.05 * weight_bytes,
          "the artifact holds weights, or was not exported for cuda")

    # ---- a fresh process loads and calls it without the model code -------
    weights, vocab = root / "weights.pt", root / "vocab.txt"
    torch.save(sd, weights)
    np.save(root / "clips.npy", clips[:3])
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", AOT_LOADER, str(ROOT), str(art), str(weights),
         str(vocab), str(root / "clips.npy"), str(root / "fresh.npz"),
         json.dumps(texts[3])],
        capture_output=True, text=True, timeout=300, cwd=root)
    print(res.stdout.strip(), f"({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(res.returncode == 0, f"the fresh process failed or imported the "
          f"model code ({res.returncode}):\n{res.stderr[-3000:]}")
    fresh = np.load(root / "fresh.npz")

    aot = ExportedEmbedder(str(art), sd, tok, device="cuda")
    aot.embed_frames(clips[:1])  # first call: cuBLAS and allocator set-up
    ref = {("video", n): live.embed_frames(clips[:n]) for n in texts}
    ref.update({("text", n): live.embed_texts(texts[n]) for n in texts})
    ca.reset_launch_counts()
    live.embed_frames(clips[:16])
    live_counts = dict(ca.launches)

    # ---- the main path, counted ------------------------------------------
    ca.reset_launch_counts()
    got = {("video", n): aot.embed_frames(clips[:n]) for n in texts}
    got.update({("text", n): aot.embed_texts(texts[n]) for n in texts})
    counts = dict(ca.launches)
    # ------------------------------------------------------------------------
    print(f"aot launches: {counts}", flush=True)
    errs = {}
    for key, want in ref.items():
        g = got[key]
        check(g.shape == want.shape and np.isfinite(g).all(),
              f"aot {key}: {g.shape}, live {want.shape}")
        errs[f"{key[0]}_b{key[1]}"] = float(np.abs(g - want).max())
    errs["fresh_text_b3"] = float(np.abs(fresh["text"] - ref["text", 3]).max())
    errs["fresh_video_b3"] = float(np.abs(fresh["video"]
                                          - ref["video", 3]).max())
    print(f"aot vs live Embedder: max abs {errs} (tol {AOT_TOL:g}) [{smi}]",
          flush=True)
    check(max(errs.values()) <= AOT_TOL, "the artifact disagrees with the "
          "live Embedder")
    video_calls = len(texts)  # one video program call a request
    for name in FWD:
        check(counts[name] == 12 * video_calls,
              f"aot {name}: {counts[name]} launches, expected "
              f"{12 * video_calls}")
    check(not any(counts[name] for name in (*BWD, *HS_KERNELS,
                                            "layer_norm_bwd")),
          f"aot launched a backward or head-split kernel: {counts}")
    ca.reset_launch_counts()
    aot.embed_frames(clips[:16])
    one = dict(ca.launches)
    print(f"aot one bucket-16 video call: {attention_counts(one)}, K3-fwd "
          f"{one['layer_norm_fwd']} (live {live_counts['layer_norm_fwd']})",
          flush=True)
    check(one["space_attention_fwd"] == 12 and one["time_attention_fwd"] == 12
          and one == live_counts, f"one bucket-16 call: {one}, the live "
          f"call's {live_counts}")
    try:
        aot.embed_frames(clips[:17])
    except ValueError as e:
        check("bucket" in str(e), f"the refusal names no bucket: {e}")
        print(f"aot 17 clips: raises ({e}) ok", flush=True)
    else:
        raise RuntimeError("the artifact took 17 clips past bucket 16")

    # ---- cli.serve --aot answers over HTTP --------------------------------
    cfg_path, ckpt = root / "serve.json", root / "serve.pth"
    cfg_path.write_text(json.dumps(dict(config)))
    torch.save({"state_dict": sd}, ckpt)
    port, log = free_port(), root / "serve.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "egovlp_tpu_torch.cli.serve", "-c",
             str(cfg_path), "--checkpoint", str(ckpt), "--aot", str(art),
             "--port", str(port), "--device", "cuda"],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        t0 = time.perf_counter()
        while True:
            check(proc.poll() is None, "cli.serve --aot exited early:\n"
                  + log.read_text()[-3000:])
            check(time.perf_counter() - t0 < 240, "cli.serve --aot did not "
                  "answer in 240 s")
            try:
                with urllib.request.urlopen(f"{url}/healthz", timeout=5) as r:
                    if json.loads(r.read()) == {"status": "ok"}:
                        break
            except OSError:
                time.sleep(1)
        up_s = time.perf_counter() - t0
        req = urllib.request.Request(
            f"{url}/embed_text",
            data=json.dumps({"texts": texts[3]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            served = np.asarray(json.loads(r.read())["embeddings"])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    err = float(np.abs(served - ref["text", 3]).max())
    print(f"aot cli.serve --aot: up in {up_s:.1f} s, /embed_text max abs "
          f"{err:.2e} against the live Embedder", flush=True)
    # JSON carries the float32 values as shortest decimal strings: exact
    check(served.shape == (3, 256) and err <= AOT_TOL,
          "cli.serve --aot /embed_text disagrees with the live Embedder")

    lat = {}
    for n in AOT_BUCKETS:
        t_live, t_aot = interleaved_ms(lambda: live.embed_frames(clips[:n]),
                                       lambda: aot.embed_frames(clips[:n]))
        lat[n] = {"artifact_ms": t_aot, "live_ms": t_live}
        print(f"aot latency bucket {n}: embed_frames artifact {t_aot:.2f} ms, "
              f"live {t_live:.2f} ms ({t_aot / t_live - 1:+.1%}) [{smi}]",
              flush=True)
    profile_calls("aot embed_frames bucket 16",
                  lambda i: aot.embed_frames(clips[:16]), smi)
    profile_calls("live embed_frames bucket 16",
                  lambda i: live.embed_frames(clips[:16]), smi)
    costs = op_host_costs(smi)
    del aot, live, model
    tmp.cleanup()
    return counts, {"export_s": export_s, "artifact_bytes": art_bytes,
                    "weight_bytes": weight_bytes, "max_abs_err": errs,
                    "latency": lat, "op_cost": costs}


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
                check(dtype != "bfloat16" or local.value == 0,
                      f"{name} bf16 spills to local memory at f {f}")
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

    for name in LN_KERNELS:  # K3's resources
        attributes = getattr(lib, f"egovlp_{name}_attributes")
        for dtype, code in (("bfloat16", 1), ("float32", 0)):
            regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            rc = attributes(code, ctypes.byref(regs), ctypes.byref(local),
                            ctypes.byref(smem))
            check(rc == 0, f"{name} attributes: {rc}")
            print(f"kernel {name} {dtype}: {regs.value} registers a thread, "
                  f"{local.value} local (spill) bytes a thread, {smem.value} "
                  f"bytes of shared memory a CTA", flush=True)
            check(dtype != "bfloat16" or local.value == 0,
                  f"{name} bf16 spills to local memory")
    print(f"kernel K1/K2 at ViT-L's width (D {VITL_DIM}, {VITL_HEADS} heads "
          f"of {VITL_DIM // VITL_HEADS}) run the hd {HD} instantiations above",
          flush=True)

    rows = phase_kernels(ca, smi)
    rows.update(phase_layer_norm(smi))
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
        torch.cuda.empty_cache()
        ft_counts = phase_finetune(ca, smi, Path(tree.name) / "finetune")
        torch.cuda.empty_cache()
        sc_counts = phase_oscc_pnr(ca, smi, Path(tree.name) / "ego4d")
        torch.cuda.empty_cache()
        em_counts = phase_extract(ca, smi, Path(tree.name) / "ego4d")
        torch.cuda.empty_cache()
        vitl_counts = phase_vitl(ca, smi, Path(tree.name))
    finally:
        tree.cleanup()
    torch.cuda.empty_cache()
    aot_counts, aot = phase_aot(ca, smi)

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
                                     "ddp_world1": ddp_counts[name],
                                     "finetune16": ft_counts[name],
                                     "oscc_pnr16": sc_counts[name],
                                     "extract": em_counts[name],
                                     "vitl_cli": vitl_counts[name],
                                     "aot_serving": aot_counts[name]},
                **rows[name]}
               for name, replaces in {**KERNELS, **LN_KERNELS}.items()]
    kernels += [{"name": name, "route": "cuda", **sources(name),
                 "replaces": replaces, "launches": hs_counts[name],
                 "launches_by_path": {"head_split_op": hs_counts[name],
                                      "train_cli": cli_counts[name],
                                      "finetune16": ft_counts[name],
                                      "oscc_pnr16": sc_counts[name],
                                      "extract": em_counts[name],
                                      "vitl_cli": vitl_counts[name],
                                      "aot_serving": aot_counts[name]},
                 **rows[name]}
                for name, replaces in HS_KERNELS.items()]
    print(json.dumps({"aot": aot}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
