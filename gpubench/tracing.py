"""Capture and read a ``torch.profiler`` trace of a few steps.

``capture`` runs a callable under the profiler with CUDA activity alone
(recording every host operator as well slowed a 4,800-launch step from
235 to 520 ms on the H100 machine), warmed first with a synchronised
kernel and a 50 ms pause, since the first activities after the profiler
starts can be missing from its trace; it ends with a synchronise.  ``read``
takes the device's operations (kernels, copies, sets) after that pause:
the traced window runs from the first of them to the end of the last;
their union is the busy time; the gaps between them are named by the
CUDA runtime call the launching thread was in when each began (none: it
was in Python or PyTorch's dispatch); and the hand-written kernels are
counted and timed by kind, named as the CUDA sources name them: K1
``attention_fwd_mma_kernel`` / ``attention_bwd_mma_kernel`` (bf16 space
attention), K2 ``k2::...fwd_kernel`` / ``bwd_kernel`` (time attention), K3
``k3::fwd_kernel`` / ``bwd_kernel`` (LayerNorm).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

PAUSE_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel kind -> substrings its demangled name holds, and the port's
# launch counter that counts it
KINDS = {
    "space_fwd": (("attention_fwd_mma_kernel",), "space_attention_fwd"),
    "space_bwd": (("attention_bwd_mma_kernel",), "space_attention_bwd"),
    "time_fwd": (("k2::", "fwd_kernel"), "time_attention_fwd"),
    "time_bwd": (("k2::", "bwd_kernel"), "time_attention_bwd"),
    "ln_fwd": (("k3::fwd_kernel",), "layer_norm_fwd"),
    "ln_bwd": (("k3::bwd_kernel",), "layer_norm_bwd"),
}


def kind_of(name: str):
    for kind, (parts, _) in KINDS.items():
        if all(p in name for p in parts):
            return kind
    return None


def capture(run, device) -> list:
    """``run()`` traced; the Chrome trace's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        torch.ones(1, device=device).add_(1).item()
        time.sleep(PAUSE_S)
        run()
        if cuda:
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(events: list, steps: int) -> dict:
    """The traced window's numbers (times in seconds): ``window_s``,
    ``busy_s`` (the union of device operations), ``kernels`` (launches),
    ``by_kind`` (``{kind: [count, seconds]}`` of the hand-written
    kernels), ``device_ops`` (the ten kernel names with the most time) and
    ``idle_gaps`` (the ten longest gaps between device operations, named
    by what the launching thread was doing)."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    # the warm-up kernel and its read come before the pause
    for i in range(1, min(len(dev), 8)):
        if dev[i]["ts"] - (dev[i - 1]["ts"] + dev[i - 1]["dur"]) >= PAUSE_S * 0.8e6:
            dev = dev[i:]
            break
    if not dev:
        return {"steps": steps, "window_s": 0.0, "busy_s": 0.0, "kernels": 0,
                "by_kind": {k: [0, 0.0] for k in KINDS}, "device_ops": [],
                "idle_gaps": []}
    union = merged((e["ts"], e["ts"] + e["dur"]) for e in dev)
    s0, s1 = union[0][0], union[-1][1]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    totals, by_kind = {}, {k: [0, 0.0] for k in KINDS}
    for e in kernels:
        totals[e["name"]] = totals.get(e["name"], 0.0) + e["dur"]
        kind = kind_of(e["name"])
        if kind:
            by_kind[kind][0] += 1
            by_kind[kind][1] += e["dur"] / 1e6
    top = sorted(totals.items(), key=lambda x: -x[1])[:10]
    gaps = sorted(((a[1], b[0]) for a, b in zip(union[:-1], union[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    calls = _launcher_calls(events)
    return {
        "steps": steps, "window_s": (s1 - s0) / 1e6,
        "busy_s": sum(b - a for a, b in union) / 1e6,
        "kernels": len(kernels), "by_kind": by_kind,
        "device_ops": [[_short(n), t / 1e6] for n, t in top],
        "idle_gaps": [[_host_at(calls, a), (b - a) / 1e6] for a, b in gaps],
    }


def _launcher_calls(events: list) -> list:
    """The CUDA runtime calls of the thread that launched the most
    kernels."""
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and e.get("ph") == "X"]
    count = {}
    for e in runtime:
        if "LaunchKernel" in e["name"]:
            count[e.get("tid")] = count.get(e.get("tid"), 0) + 1
    if not count:
        return []
    tid = max(count, key=count.get)
    return [e for e in runtime if e.get("tid") == tid]


def _host_at(calls: list, ts: float) -> str:
    """The runtime call the launching thread was in at ``ts``."""
    inside = [e for e in calls if e["ts"] <= ts <= e["ts"] + e["dur"]]
    if not inside:
        return "host: Python or dispatch (no CUDA call)"
    return "host: " + min(inside, key=lambda e: e["dur"])["name"]


def _short(name: str) -> str:
    """A kernel name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def complete(trace: dict, counted: dict) -> bool:
    """Whether the trace holds as many hand-written kernels of each kind as
    the port's launch counter counted over the traced steps."""
    return all(trace["by_kind"][k][0] >= counted.get(c, 0)
               for k, (_, c) in KINDS.items())

