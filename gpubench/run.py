"""Run one cell of the benchmark once.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 gpubench/run.py --list

Set-up (weights from the seed, the port's model, optimizer and loop, the
first steps), a window of ``--seconds`` on the host clock, with ``--trace
1`` a few profiled steps after it, then the comparison with the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, also the last lines of standard error.  Without a CUDA
device, or with fewer than the cell asks for, it prints no result and
exits 2; it exits 3 if JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--list", action="store_true",
                   help="print every cell's files and metrics and exit")
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def host_clock() -> dict:
    """CPU seconds of the main thread and of the whole process (the
    autograd engine's device thread, which runs the backward, the prefetch
    thread and any worker threads with it)."""
    return {"main": time.thread_time(), "process": time.process_time()}


def main(argv=None, need_chip: bool = True, fault=None) -> dict:
    """One run; returns the result line's object (``need_chip=False`` and
    ``fault`` are for tests on the CPU)."""
    args = parse(argv)
    t_torch = time.perf_counter()
    bench = harness.benchmark()
    if args.list:
        print(json.dumps(harness.listing(bench), indent=1))
        return {}
    cell = harness.cell(bench, args.workload)
    import torch

    t_torch = time.perf_counter() - t_torch
    if need_chip:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.zeros(1, device=device).item()  # the CUDA context
    else:
        device = torch.device("cpu")
    config = harness.config(bench, cell["config"])
    traffic = harness.traffic(cell["traffic"])
    limits = harness.limits(cell["name"])
    kind = harness.kind_module(traffic["kind"])

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = kind.Cell(config, traffic, args.seed, device, fault=fault)
    imports_s = time.perf_counter() - T_START
    run.setup()
    setup_s = time.perf_counter() - T_START
    before = host_clock()
    window = run.window(args.seconds)
    after = host_clock()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = run.trace() if args.trace else None
    run.release()
    numbers = kind.compare(run.program_readings(), run.reference_readings())
    checks = {k: numbers[k] for k in limits}
    correct = all(checks[k] <= limits[k] for k in limits)

    e2e = kind.end_to_end(run, window, peak, setup_s)
    if args.trace:
        ctx = {"window": window, "trace": trace, "shape": run.shape,
               "counted": trace["counted"]}
        metrics = {}
        for m in harness.metrics_of(bench, "per_layer", cell["name"]):
            value = harness.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in harness.metrics_of(bench, "end_to_end",
                                               cell["name"])}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power"] = power_limit()
    out = {"correct": correct, "attempted": window["steps"], "failed": 0,
           "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace["busy_s"], trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": limits[k]}
                     for k, v in checks.items()}
    banned = harness.banned_modules()
    if banned:
        print(f"loaded modules of JAX or the JAX package: {banned}",
              file=sys.stderr)
        raise SystemExit(3)
    print(f"window: {window['steps']} steps in {window['seconds']:.3f} s; "
          f"host in the step call "
          f"{statistics.fmean(window['host_ms']) if window['host_ms'] else 0:.2f} "
          f"ms a step (mean), between calls "
          f"{statistics.median(window['gap_ms']) if window['gap_ms'] else 0:.3f}"
          f" ms (median)", file=sys.stderr)
    print(f"host in the window: the main thread on a CPU "
          f"{after['main'] - before['main']:.3f} s, the process "
          f"{after['process'] - before['process']:.3f} s; torch threads "
          f"{torch.get_num_threads()}", file=sys.stderr)
    print(f"set-up seconds: to torch imported {t_torch:.3f}, to the cell "
          f"built {imports_s:.3f}, " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         run.phases.items()), file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v!r} limit {limits[k]!r}"
              f" {'ok' if v <= limits[k] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
