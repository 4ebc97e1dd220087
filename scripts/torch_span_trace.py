"""The port's spans on the card for one benchmark cell: what recording
them costs, and a three-step ``Profiler`` trace read by ``idle_by_span``.

    python3 scripts/torch_span_trace.py --workload vitb-pt4f-egoclip \
        [--seed 1] [--pairs 3] [--out chiprun_out/spans]

It builds the cell as ``gpubench/run.py`` does (``gpubench.traffic.train
.TrainCell``: weights from the seed, the port's model, AdamW, step and
epoch loop, the set-up's first steps warming every shape), then

* cost: ``--pairs`` pairs of three-step epochs with ``recording()`` off
  and on in turns (off on, on off, ...), no profiler open, each between
  two synchronises: the host ms a step of each;
* a ``Profiler`` trace (CUDA activity alone) of one three-step epoch,
  after a synchronised kernel and a 50-ms pause, written under ``--out``:
  its device window, busy time and idle share (``gpubench.tracing.read``),
  ``idle_by_span``'s table of the device operations from the epoch's
  start on, and the share of the epoch's kernel launches
  (every thread's ``cuda*Launch*`` calls) that fall inside a ``loop.step``
  span on the trace's clock;
* the six span metrics of that epoch (``gpubench/spans.py``) and the sum
  of the three phases and the waits between steps over the steps,
  against the trace's device window.

It prints one JSON line, the card's name and power limit in it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

STEPS = 3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", default="chiprun_out/spans")
    p.add_argument("--device", default="cuda",
                   help="'cpu' tries the script on a tiny checkout")
    args = p.parse_args(argv)

    import torch

    from egovlp_tpu_torch.io import logging as port_logging
    from gpubench import harness, run, spans, tracing
    from gpubench.traffic import train

    cuda = args.device == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.config(bench, cell["config"])
    traffic = harness.traffic(cell["traffic"])
    c = train.TrainCell(config, traffic, args.seed, device)
    c.setup()
    epoch = [10]

    def one_epoch():
        c.feed.plan(batches=[c.pool[i % len(c.pool)] for i in range(STEPS)])
        c.epoch_fn(c.model, c.optimizer, epoch[0], c.log)
        epoch[0] += 1

    def timed(on: bool) -> float:
        sync()
        start = time.perf_counter()
        if on:
            with port_logging.recording():
                one_epoch()
        else:
            one_epoch()
        sync()
        return (time.perf_counter() - start) * 1e3 / STEPS

    cost = {"off": [], "on": []}
    for i in range(args.pairs):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            cost["on" if on else "off"].append(timed(on))

    out_dir = pathlib.Path(args.out) / args.workload
    prof = port_logging.Profiler(str(out_dir), start=0, stop=1, device=device)
    prof.step(0)
    torch.ones(1, device=device).add_(1).item()
    time.sleep(tracing.PAUSE_S)
    one_epoch()
    prof.step(1)
    (path,) = out_dir.glob("trace_steps0-1.json")
    events = json.loads(path.read_text())["traceEvents"]
    window = tracing.read(events, STEPS)

    marks = [e for e in events if e.get("cat") == "port_span"]
    (loop_epoch,) = [e for e in marks if e["name"] == "loop.epoch"]
    steps = [e for e in marks if e["name"] == "loop.step"]

    def within(e, s):
        return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]

    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e["name"] and within(e, loop_epoch)]
    in_steps = sum(any(within(e, s) for s in steps) for e in launches)
    # the gaps from the epoch's first device operation on (not the pause)
    in_epoch = [e for e in events if e.get("cat") not in tracing.DEVICE_CATS
                or e["ts"] >= loop_epoch["ts"]]
    metrics = {m: harness.reader(m)({}) for m in (
        "fwd_ms.train", "bwd_ms.train", "opt_ms.train", "between_ms.train",
        "feed_wait_ms", "h2d_gbps")}
    phases = sum(metrics[m] for m in ("fwd_ms.train", "bwd_ms.train",
                                      "opt_ms.train", "between_ms.train"))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e["name"]]
    copy_bytes = sum(e["args"].get("bytes", 0) for e in copies)
    copy_s = sum(e["dur"] for e in copies) / 1e6
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": run.power_limit() if cuda else "cpu",
        "cost_ms_a_step": {k: {"median": statistics.median(v), "runs": v}
                           for k, v in cost.items()},
        "trace": {"window_ms": window["window_s"] * 1e3,
                  "busy_ms": window["busy_s"] * 1e3,
                  "idle_share": (1 - window["busy_s"] / window["window_s"]
                                 if window["window_s"] else None),
                  "kernels_a_step": window["kernels"] / STEPS},
        "idle_by_span_ms": port_logging.idle_by_span(in_epoch),
        "launches": {"in_epoch": len(launches), "in_loop_step": in_steps,
                     "share": in_steps / len(launches) if launches else None},
        "span_metrics": metrics,
        "phases_times_steps_over_window": (
            phases * STEPS / (window["window_s"] * 1e3)
            if window["window_s"] else None),
        "memcpy_htod": {"copies": len(copies), "bytes": copy_bytes,
                        "gbps": copy_bytes / copy_s / 1e9 if copy_s else None},
        "spans_in_trace": len(marks),
    }), flush=True)


if __name__ == "__main__":
    main()
