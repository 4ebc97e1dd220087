"""The training traffic kind: seeded collated batches, fed to the port's own
epoch loop, and the comparison of its first steps with the reference.

A traffic file of this kind (``gpubench/traffic/<name>.json``) gives:
``task`` ('egoclip' or 'epic'), ``batch_size``, ``num_frames``,
``pre_size`` (the decoded frames' side) and ``input_res`` (the crop's),
``negatives`` (EgoClip's scene negatives double the clips of a step),
``text_tokens`` (``[shortest, longest]`` words of a caption, padded to
``max_length``), ``noun_vec`` / ``verb_vec`` (``[dim, shared]``: the
multi-hot width and the few classes every row draws one of, so that
rows share actions; absent: no vectors), ``pool`` (distinct host batches),
``loss`` and ``optimizer`` (the task config's sections).  How many steps
the reference follows and how many are traced is the harness's own
(``FIRST_STEPS``, ``TRACE_STEPS``), the same for every mix.

A run (``TrainCell``):

* set-up: the weights drawn on the device from the seed (one normal draw,
  ``reference.model.draw_weights``) and loaded into the port's model
  (``build.build_model``), the port's AdamW (``train.state
  .make_optimizer``) and task step (``train.steps``), the epoch function
  (``train.recipes.make_train_epoch_fn``, which feeds through
  ``data.pipeline.device_prefetch``), and a pool of host batches in the
  collated numpy layout.  The first ``FIRST_STEPS`` steps run as one
  epoch (1) of that same epoch function over the first pool batches, which
  all differ, so ``device_prefetch`` copies batch i + 1 while step i runs,
  as in the window: they warm up every shape, and the port's loss of each
  step, the step-1 embeddings its model returned, its gradient norm of
  every leaf at step 1 (from AdamW's second moment after one step:
  ``sqrt(sum(nu) / (1 - b2))``, summed on the device between the calls)
  and every leaf's change after the last step are kept.
* window: one epoch (2) of the same function over the pool, round and
  round, until the clock passes the end; no step is synchronised inside
  it but the loop's own first-step loss read; it ends with one
  synchronise.
* trace: ``TRACE_STEPS`` more steps (epoch 3) under the profiler.
* judge: the program freed, the reference follows the first steps from
  the same weights and batches in float32 and the numbers are compared
  (``compare``).
"""

from __future__ import annotations

import contextlib
import gc
import logging
import math
import statistics
import time

import numpy as np
import torch

from gpubench import tracing
from gpubench.reference import model as ref_model
from gpubench.reference import train as ref_train

CLS_ID, SEP_ID, FIRST_WORD = 101, 102, 1000
# what a compared number reads when it is not finite: far above any limit,
# and a number the result line's JSON can carry
NOT_A_NUMBER = 1e9
# the steps the reference follows, run as one epoch at set-up; the steps
# a traced run profiles after the window
FIRST_STEPS = 3
TRACE_STEPS = 3
FIRST_EPOCH, WINDOW_EPOCH, TRACE_EPOCH = 1, 2, 3


def make_batch(rng: np.random.Generator, t: dict, vocab: int,
               max_length: int) -> dict:
    """One collated batch: uint8 frames ``[B, T, pre, pre, 3]``, int32 ids
    and mask ``[B, max_length]`` ([CLS] words [SEP], padded), float32
    multi-hot noun and verb vectors; the ``_neg`` twins with negatives."""
    B, T, pre = t["batch_size"], t["num_frames"], t["pre_size"]
    batch = {}
    for suffix in (("", "_neg") if t["negatives"] else ("",)):
        batch["frames" + suffix] = rng.integers(0, 256, (B, T, pre, pre, 3),
                                                dtype=np.uint8)
        ids = np.zeros((B, max_length), np.int32)
        mask = np.zeros((B, max_length), np.int32)
        lo, hi = t["text_tokens"]
        for i, n in enumerate(rng.integers(lo, hi + 1, B)):
            ids[i, :n + 2] = [CLS_ID, *rng.integers(FIRST_WORD, vocab, n),
                              SEP_ID]
            mask[i, :n + 2] = 1
        name = "text_neg" if suffix else "text"
        batch[f"{name}_ids"], batch[f"{name}_mask"] = ids, mask
        for key in ("noun_vec", "verb_vec"):
            if key not in t:
                continue
            dim, shared = t[key]
            vec = np.zeros((B, dim), np.float32)
            vec[np.arange(B), rng.integers(0, shared, B)] = 1.0
            vec[np.arange(B), rng.integers(0, dim, B)] = 1.0
            batch[key + suffix] = vec
    return batch


class Feed:
    """The loader the epoch function pulls from: ``epoch(e)`` yields the
    batches planned for that call, a list or the pool round and round until
    a deadline on the host clock."""

    def __init__(self, pool: list):
        self.pool = pool
        self.batches, self.deadline = None, None

    def plan(self, batches=None, deadline=None):
        self.batches, self.deadline = batches, deadline

    def __len__(self):
        return len(self.batches) if self.batches is not None else len(self.pool)

    def epoch(self, epoch: int):
        if self.batches is not None:
            yield from self.batches
            return
        i = 0
        while time.perf_counter() < self.deadline:
            yield self.pool[i % len(self.pool)]
            i += 1


def shape_of(d: dict, t: dict, max_length: int, remat: str) -> dict:
    """The step's shapes for ``roofline``."""
    clips = t["batch_size"] * (2 if t["negatives"] else 1)
    return {"clips": clips, "frames": t["num_frames"],
            "patches": (d["img"] // d["patch"]) ** 2, "depth": d["depth"],
            "dim": d["dim"], "remat": remat, "patch_size": d["patch"],
            "mlp_ratio": d["mlp"] / d["dim"], "proj_dim": d["proj"],
            "texts": clips, "tokens": max_length,
            "text_layers": d["tlayers"], "text_dim": d["tdim"],
            "text_hidden": d["thidden"]}


def seeds(seed: int) -> dict:
    """Independent seeds for the weights and the batches."""
    s = np.random.SeedSequence(seed).generate_state(2)
    return {"weights": int(s[0]), "batches": int(s[1])}


def weight_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seeds(seed)["weights"])


class TrainCell:
    """One training cell's run on ``device`` (see the module notes).
    ``fault``: a context manager factory from ``gpubench.faults`` planted
    under the timed path (tests and readings only)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.traffic, self.seed = traffic, seed
        self.device = torch.device(device)
        arch = dict(config["arch"])
        args = dict(arch["args"])
        args["video_params"] = dict(args["video_params"],
                                    num_frames=traffic["num_frames"])
        arch["args"] = args
        self.arch = arch
        self.dims = ref_model.dims(arch, traffic["num_frames"])
        self.max_length = int(args["text_params"].get("max_length", 30))
        remat = args["video_params"].get("remat", False)
        self.shape = shape_of(self.dims, traffic, self.max_length,
                              "block" if remat in (True, "block") else "none")
        self.fault = fault
        self.samples_per_step = traffic["batch_size"]
        self.calls: list = []
        self.phases: dict = {}  # set-up seconds by part
        self.log = logging.getLogger("gpubench.train")
        self.log.setLevel(logging.WARNING)

    # set-up -----------------------------------------------------------
    def setup(self) -> None:
        from egovlp_tpu_torch import build
        from egovlp_tpu_torch.kernels import cuda_attention
        from egovlp_tpu_torch.train.recipes import make_train_epoch_fn
        from egovlp_tpu_torch.train.state import make_optimizer
        from egovlp_tpu_torch.train.steps import (
            make_egoclip_train_step,
            make_epic_train_step,
        )

        t = self.traffic
        clock = time.perf_counter()

        def phase(name):
            nonlocal clock
            now = time.perf_counter()
            self.phases[name] = now - clock
            clock = now

        self.counter = cuda_attention.launches
        self.pool = self.make_pool()
        phase("batches")
        spec = ref_model.param_spec(self.dims)
        weights = ref_model.draw_weights(spec, weight_generator(self.seed,
                                                                self.device))
        self._sync()
        phase("weights")
        self.model, _ = build.build_model(self.arch, self.device)
        phase("build")
        self.model.load_state_dict(weights, strict=True)
        del weights
        self._sync()
        phase("load")
        opt = t["optimizer"]
        self.optimizer, _ = make_optimizer(
            self.model, base_lr=float(opt["lr"]), milestones=(),
            weight_decay=float(opt.get("weight_decay", 0.0)),
            mu_dtype=opt.get("mu_dtype"))
        loss = t["loss"]
        if t["task"] == "egoclip":
            step = make_egoclip_train_step(
                loss_type=loss["type"], input_res=t["input_res"],
                temperature=float(loss.get("args", {}).get("temperature",
                                                           0.05)))
        elif t["task"] == "epic":
            step = make_epic_train_step(
                loss_type=loss["type"], input_res=t["input_res"],
                margin=float(loss.get("args", {}).get("margin", 0.2)))
        else:
            raise ValueError(f"training task {t['task']!r}")

        def timed(model, optimizer, batch, generator):
            start = time.perf_counter()
            out = step(model, optimizer, batch, generator)
            self.calls.append((start, time.perf_counter()))
            if self.reading:  # set-up's first steps: keep what is compared
                self.step_losses.append(out.detach())
                if len(self.step_losses) == 1:
                    self.hook.remove()
                    self.nu_sums = self._nu_sums()
            return out

        self.feed = Feed(self.pool)
        self.epoch_fn = make_train_epoch_fn(
            [self.feed], timed, self.device, max_samples=0,
            log_step=2 ** 62, seed=self.seed)
        self.params = dict(self.model.named_parameters())
        self.feed.plan(batches=self.pool[:FIRST_STEPS])
        self.hook = self.model.register_forward_hook(self._keep_embeddings)
        self.reading, self.embeddings, self.step_losses = True, None, []
        with self._planted():
            self.epoch_fn(self.model, self.optimizer, FIRST_EPOCH, self.log)
        self.reading = False
        phase("first_steps")
        self.losses = [float(loss) for loss in self.step_losses]
        self.grad_norms = self._grad_norms(self.nu_sums)
        self.embeddings = tuple(x.cpu() for x in self.embeddings)
        self.change = self._change(spec)
        self._sync()
        phase("snapshots")

    def make_pool(self) -> list:
        """The run's distinct host batches, drawn from the seed."""
        rng = np.random.default_rng(seeds(self.seed)["batches"])
        return [make_batch(rng, self.traffic, self.dims["vocab"],
                           self.max_length)
                for _ in range(self.traffic["pool"])]

    def _planted(self):
        return self.fault(self) if self.fault else contextlib.nullcontext()

    def _keep_embeddings(self, module, args, out):
        """The forward hook of step 1 (removed when its call returns): the
        text and video embeddings the port's model returns, copied on the
        device (a copy to the host would synchronise the loop)."""
        if self.embeddings is None:
            self.embeddings = tuple(x.detach().to(torch.float32, copy=True)
                                    for x in out)

    def _nu_sums(self) -> torch.Tensor:
        """Each leaf's sum of AdamW's second moment, on the device, queued
        after the step that made it and before the next; 0 for a leaf with
        no state."""
        return torch.stack([
            self.optimizer.state[p]["nu"].sum(dtype=torch.float64)
            if "nu" in self.optimizer.state.get(p, {})
            else torch.zeros((), dtype=torch.float64, device=p.device)
            for p in self.params.values()])

    def _grad_norms(self, nu_sums: torch.Tensor) -> dict:
        """Each leaf's norm of the gradient AdamW took at step 1, from its
        second moment after that step (nu = (1 - b2) g^2)."""
        from egovlp_tpu_torch.train.state import B2

        return dict(zip(self.params, nu_sums.div(1.0 - B2).sqrt().tolist()))

    @torch.no_grad()
    def _change(self, spec) -> dict:
        """Each leaf's change from the drawn weights, drawn again."""
        init = ref_model.draw_weights(spec, weight_generator(self.seed,
                                                             self.device))
        norms = torch.stack([(p.double() - init[k].double()).norm()
                             for k, p in self.params.items()]).tolist()
        del init
        return dict(zip(self.params, norms))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # the measured window -----------------------------------------------
    def window(self, seconds: float) -> dict:
        self.calls = []
        self._sync()
        t0 = time.perf_counter()
        self.feed.plan(deadline=t0 + seconds)
        with self._planted():
            self.epoch_fn(self.model, self.optimizer, WINDOW_EPOCH, self.log)
        self._sync()
        t1 = time.perf_counter()
        starts = [a for a, _ in self.calls]
        ends = [b for _, b in self.calls]
        gaps = [b - a for a, b in zip(ends[:-1], starts[1:])]
        return {"steps": len(self.calls), "seconds": t1 - t0,
                "samples": len(self.calls) * self.samples_per_step,
                "host_ms": [(b - a) * 1e3 for a, b in self.calls],
                "gap_ms": [g * 1e3 for g in gaps]}

    # the traced steps ---------------------------------------------------
    def trace(self, attempts: int = 3) -> dict:
        """``TRACE_STEPS`` steps under the profiler, traced again (up to
        ``attempts`` times) while the trace holds fewer attention and
        LayerNorm kernels than the port's launch counter counted."""
        k = TRACE_STEPS
        out = None
        for _ in range(attempts):
            self.feed.plan(batches=[self.pool[i % len(self.pool)]
                                    for i in range(k)])
            before = dict(self.counter)
            events = tracing.capture(
                lambda: self.epoch_fn(self.model, self.optimizer,
                                      TRACE_EPOCH, self.log),
                self.device)
            counted = {name: self.counter[name] - before[name]
                       for name in self.counter}
            out = tracing.read(events, k)
            out["counted"] = counted
            if tracing.complete(out, counted):
                break
        return out

    # the comparison -------------------------------------------------------
    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("model", "optimizer", "epoch_fn", "feed", "params",
                     "hook", "step_losses", "nu_sums"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def program_readings(self) -> dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change": self.change, "embeddings": self.embeddings}

    def reference_readings(self, quant: str = "none") -> dict:
        """The reference's readings (``quant='fp8'``: the control's)."""
        if getattr(self, "pool", None) is None:
            self.pool = self.make_pool()
        weights = ref_model.draw_weights(
            ref_model.param_spec(self.dims),
            weight_generator(self.seed, self.device))
        return ref_train.follow(self.dims, weights, self.pool[:FIRST_STEPS],
                                self.traffic, self.seed,
                                [(FIRST_EPOCH, i) for i in range(FIRST_STEPS)],
                                self.device, quant=quant)


def leaf_gaps(program: dict, reference: dict) -> tuple:
    """Each leaf's gap of gradient norms at step 1 and, over the leaves
    whose reference gradient is at least a thousandth of the median leaf's
    (a gradient that is nought to rounding, as a key bias's under softmax,
    moves under Adam by round-off alone), its gap of changes after the last
    step: the gap between the program's and the reference's norm, over the
    larger of the reference's norm of that leaf and of the median leaf.
    Returns the two dicts, leaf -> gap."""
    gr, cr = reference["grad_norms"], reference["change"]
    g_med = statistics.median(gr.values())
    kept = [k for k in gr if gr[k] >= 1e-3 * g_med]
    c_med = statistics.median(cr[k] for k in kept)
    grad = {k: abs(program["grad_norms"][k] - gr[k]) / max(gr[k], g_med)
            for k in gr}
    change = {k: abs(program["change"][k] - cr[k]) / max(cr[k], c_med)
              for k in kept}
    return grad, change


def compare(program: dict, reference: dict) -> dict:
    """The numbers that may decide ``correct`` (a cell's limits file names
    the ones it compares):

    * ``embed_gap``: over the text and video embeddings of step 1 (the
      model's outputs before any update), the largest gap of a row, over
      the reference row's norm; ``NOT_A_NUMBER`` where the rows differ in
      number (as for any number that comes out infinite or NaN);
    * ``loss_gap``: the largest relative gap of a step's loss;
    * ``grad_gap``, ``change_gap``: the worst leaf's gap (``leaf_gaps``)."""
    embed_gap = 0.0
    for p, r in zip(program["embeddings"], reference["embeddings"]):
        if p.shape != r.shape:
            embed_gap = math.inf
            break
        rows = (p.double() - r.double()).norm(dim=1) / r.double().norm(dim=1)
        embed_gap = max(embed_gap, float(rows.max()))
    lp, lr = program["losses"], reference["losses"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    grad, change = leaf_gaps(program, reference)
    out = {"embed_gap": embed_gap, "loss_gap": loss_gap,
           "grad_gap": max(grad.values()), "change_gap": max(change.values())}
    return {k: (v if math.isfinite(v) else NOT_A_NUMBER)
            for k, v in out.items()}

Cell = TrainCell


def end_to_end(cell: TrainCell, window: dict, peak_bytes: int,
               setup_s: float) -> dict:
    """``samples_per_s``: dataset samples (a clip with its caption; with
    scene negatives, its negative rides along uncounted, as the reference's
    ``max_samples_per_epoch`` counts) trained over the whole window;
    ``peak_gib``: the allocator's peak from before the model was built;
    ``setup_s``: process start to the first timed step."""
    return {"samples_per_s": window["samples"] / window["seconds"],
            "peak_gib": peak_bytes / 2 ** 30, "setup_s": setup_s}


def worst_leaves(program: dict, reference: dict) -> dict:
    """The leaves behind ``compare``'s gradient and change gaps, with the
    two norms of each (a diagnostic for the readings)."""
    grad, change = leaf_gaps(program, reference)
    g, c = max(grad, key=grad.get), max(change, key=change.get)
    return {"grad": [g, program["grad_norms"][g], reference["grad_norms"][g]],
            "change": [c, program["change"][c], reference["change"][c]],
            "left_out": sorted(set(grad) - set(change))}
