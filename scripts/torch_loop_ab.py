"""The training loop's host -> device edge on one CUDA device, in turns:
the epoch function as it runs (``train/recipes.make_train_epoch_fn``,
each loader through ``data.pipeline.device_prefetch``) against the same
function with ``device_prefetch`` swapped for an in-line copy
(``inline_copy``: each batch copied by ``to_device`` on the loop's thread
and stream when the loop asks for it, as the epoch function did before
the prefetch).

    python3 scripts/torch_loop_ab.py [--pairs 10] [--cells fixed,loader,ft16]

Cells, at full width in bf16 with random time attention, as
``chip_smoke.py`` runs them:

* ``fixed`` (phase 5): ``configs/pt/egoclip.json``, 16 clips + 16 scene
  negatives, 3 seeded host batches in a list, each step between two
  ``torch.cuda.synchronize()`` calls (``chip_smoke.SyncedClock``);
* ``loader`` (phase 7): the same model on ``chip_smoke``'s synthetic
  EgoClip tree through the train ``Loader`` that ``cli.train`` builds
  (16 decode threads), a whole epoch of 6 steps, each step's end a CUDA
  event;
* ``ft16`` (phase 9): ``configs/ft/epic.json``, 16 clips of 16 frames on
  ``chip_smoke``'s synthetic EPIC tree, a whole epoch of 4 steps, timed
  as ``loader``.

Each cell runs one epoch of each loop to warm up, then ``--pairs`` pairs
of epochs in turns (A B, B A, A B, ...; A the in-line copy, B the
prefetch) on one model and optimizer, then one epoch of each traced
(``chip_smoke.trace_events`` / ``edge_numbers``).  For each loop it
prints the median over its epochs of an epoch's median step end to step
end (ms, and clips/s) with the quartiles, the median time the loop waited for a batch (the in-line
copy's host time, or the wait on the prefetch queue), the paired
difference B - A (median, quartiles, the pairs in which B was slower),
and the traced epoch's device busy ms a step, its batch copies (number,
kind, stream, GB/s, overlap with kernels, the device's idle time before
each) and the host time the loop's thread spent in ``cudaMemcpy*``.
The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def inline_copy(iterator, device, depth=2):
    """``device_prefetch``'s stand-in for the in-line loop: each batch
    copied by ``to_device`` when the loop asks for it (``depth``
    unused)."""
    from egovlp_tpu_torch.train.recipes import to_device

    for batch in iterator:
        yield to_device(batch, device)


def idle_before_copies(events: list) -> dict:
    """The device's idle time before each batch copy (``Memcpy HtoD`` of
    at least 1 MiB): from the end of the last kernel that started before
    it to its start; the median, in ms."""
    import bisect

    union = cs.merged([(e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "kernel"])
    starts = [a for a, _ in union]
    idle = []
    for e in events:
        if (e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]
                and e["args"].get("bytes", 0) >= 2**20):
            i = bisect.bisect_right(starts, e["ts"]) - 1
            idle.append(max(0.0, e["ts"] - union[i][1]) if i >= 0 else 0.0)
    return {"idle_before_copy_ms": statistics.median(idle) / 1e3
            if idle else None}


def quartiles(xs: list) -> str:
    q = np.percentile(xs, [25, 50, 75])
    return f"median {q[1]:.2f} ms (quartiles {q[0]:.2f}-{q[2]:.2f})"


class Arm:
    """One loop of a cell: its copy function, each epoch's median step
    end to step end, and each batch's wait."""

    def __init__(self, name, copy):
        self.name, self.copy, self.loop_ms, self.waits = name, copy, [], []

    def timed_copy(self):
        copy, waits = self.copy, self.waits

        def timed(iterator, device, depth=2):
            it = copy(iterator, device, depth)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    waits.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()
        return timed


def run_cell(name, loaders, model, opt, step, synced, clips, pairs, smi):
    import torch

    from egovlp_tpu_torch.data.pipeline import device_prefetch
    from egovlp_tpu_torch.train import recipes

    log = logging.getLogger("torch_loop_ab")
    arms = {"A": Arm("in-line", inline_copy),
            "B": Arm("prefetch", device_prefetch)}
    epoch = [0]

    def one_epoch(arm, record=True):
        """One epoch of ``arm``'s loop; its median step end to step end."""
        ends = []
        if synced:
            clock = cs.SyncedClock()
            timed_step = clock.wrap(step)
        else:
            def timed_step(m, o, batch, gen):
                loss = step(m, o, batch, gen)
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
                return loss
        recipes.device_prefetch = arm.timed_copy() if record else arm.copy
        epoch[0] += 1
        try:
            recipes.make_train_epoch_fn(loaders, timed_step, cs.DEVICE,
                                        seed=0)(model, opt, epoch[0], log)
        finally:
            recipes.device_prefetch = device_prefetch
        torch.cuda.synchronize()
        if synced:
            return statistics.median(np.diff(clock.ends) * 1e3)
        return statistics.median(a.elapsed_time(b)
                                 for a, b in zip(ends, ends[1:]))

    for arm in arms.values():
        one_epoch(arm, record=False)
    diffs = []
    for k in range(pairs):
        order = "AB" if k % 2 == 0 else "BA"
        got = {a: one_epoch(arms[a]) for a in order}
        for a, ms in got.items():
            arms[a].loop_ms.append(ms)
        diffs.append(got["B"] - got["A"])
    for arm in arms.values():
        n = len(loaders[0])
        events, wall, made = cs.trace_events(
            lambda: one_epoch(arm, record=False))
        trace = {"wall_ms": wall / n, "prefetch_copies": made,
                 **cs.edge_numbers(events, n), **idle_before_copies(events)}
        print(f"loop trace {name} {arm.name}: {json.dumps(trace)} [{smi}]",
              flush=True)
        loop = statistics.median(arm.loop_ms)
        print(f"{name} {arm.name}: loop {quartiles(arm.loop_ms)} a step "
              f"over {len(arm.loop_ms)} epochs ({clips / loop * 1e3:.1f} "
              f"clips/s); median wait for a batch "
              f"{statistics.median(arm.waits) * 1e3:.3f} ms; traced epoch: "
              f"device busy {trace['busy_ms']:.2f} ms a step, loop - busy "
              f"{loop - trace['busy_ms']:.2f} ms; {trace['copies']} batch "
              f"copies {trace['copy_kinds']} on streams "
              f"{trace['copy_streams']} (compute {trace['compute_stream']}),"
              f" H2D {trace['h2d_gbps']:.2f} GB/s; the loop's thread in "
              f"cudaMemcpy {trace['loop_thread_memcpy_ms']:.2f} ms a step "
              f"[{smi}]", flush=True)
    print(f"{name} prefetch - in-line, {pairs} pairs in turns: "
          f"{quartiles(diffs)}; prefetch slower in "
          f"{sum(d > 0 for d in diffs)} of {pairs} pairs; each pair "
          f"{[round(d, 2) for d in diffs]} [{smi}]", flush=True)


def loaders_of(config_path, overrides):
    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.cli.train import parse_overrides
    from egovlp_tpu_torch.io.config import load_config
    from egovlp_tpu_torch.train.recipes import _all_dl_args

    config = load_config(str(config_path))
    parse_overrides(config, overrides)
    tok_len = int(config.get_path("arch.args.text_params.max_length", 30))
    tokenizer = build.build_tokenizer(config, tok_len)
    return config, [build.build_loader(
        dict(a), "train", tokenizer, batch_size=int(a.get("batch_size", 16)))
        for a in _all_dl_args(config)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--cells", default="fixed,loader,ft16")
    args = ap.parse_args()

    import torch

    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.train.state import make_optimizer
    from egovlp_tpu_torch.train.steps import make_epic_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    cells = args.cells.split(",")
    arch, sched, step = cs.train_setup(3)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        for cell in cells:
            if cell == "ft16":
                cs.write_epic_tree(root / "epic")
                ov = cs.ft_overrides(root / "epic", root / "results",
                                     root / "epic" / "vocab.txt")
                config, loaders = loaders_of(ROOT / "configs/ft/epic.json",
                                             ov[1::2])
                model, _ = build.build_model(config["arch"], cs.DEVICE)
                cell_step, clips = (
                    make_epic_train_step(input_res=224, margin=0.2), 16)
            else:
                model, _ = build.build_model(arch, cs.DEVICE)
                cell_step, clips = step, 32
                if cell == "fixed":
                    rng = np.random.default_rng(0)
                    loaders = [[cs.egoclip_batch(rng) for _ in range(3)]]
                else:
                    cs.write_egoclip_tree(root / "data")
                    _, loaders = loaders_of(
                        ROOT / "configs/pt/egoclip.json",
                        cs.tree_overrides(root / "data"))
            build.init_params(model, seed=0)
            opt, _ = make_optimizer(model, **{
                **sched, "steps_per_epoch": len(loaders[0])})
            t0 = time.perf_counter()
            run_cell(cell, loaders, model, opt, cell_step, cell == "fixed",
                     clips, args.pairs, smi)
            print(f"{cell}: {time.perf_counter() - t0:.1f} s", flush=True)
            del model, opt, loaders
            torch.cuda.empty_cache()
    print(json.dumps({"device": smi}))


if __name__ == "__main__":
    main()
