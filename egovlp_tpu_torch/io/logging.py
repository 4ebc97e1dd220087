"""Logging for the port's entry points: Python logging, scalar metrics
and device traces.

Counterpart of ``egovlp_tpu/io/logging.py``:

* ``setup_logging`` (:21-38): a stdout handler and, given a directory, a
  rotating ``info.log`` on the ``egovlp_tpu_torch`` logger.  In a
  multi-process run only rank 0 logs at INFO; the other ranks log
  warnings and errors.
* ``MetricLogger`` (:41-93): scalars tagged ``{mode}/{name}`` at a step,
  one JSON line each in ``{log_dir}/metrics.jsonl`` and, when
  ``tensorboardX`` imports, a TensorBoard event file; ``set_step`` logs
  ``steps_per_sec`` since the previous ``set_step``.  ``run_task``
  enables it on rank 0 only, in the run's ``tf`` directory.
* ``Profiler`` (:96-125): a ``torch.profiler`` trace from step ``start``
  to step ``stop``, written as a Chrome trace into ``log_dir``: CUDA
  activity alone on a CUDA device (recording every host operator as well
  slowed a 16-frame training step from 235 to 524 ms on an H100), CPU
  activity on the CPU; the port's spans of the window go into the same
  trace.

The port's own spans and counters (no JAX counterpart):

* ``span(name, device=False, args=None)``: a context manager around one
  piece of work.  It records only while a ``torch.profiler`` session is
  open or inside ``recording()``; otherwise it returns one shared no-op
  context, reading no clock and making no CUDA call.  A record holds the
  name, its id, the id of the innermost span open on the same thread when
  it began (its parent, -1 for none), the thread's native id (a Chrome
  trace's ``tid``), the host start and end in ns on ``time.time_ns()``,
  which is the trace's clock (an event at ``ts`` us sits at
  ``baseTimeNanoseconds + 1000 ts``), and ``args``.  With ``device=True``
  and CUDA in use, it also records a timing CUDA event on the current
  stream at entry and at exit, read only by ``spans()``; on the CPU its
  device interval is its host interval.  The last ``SPAN_CAPACITY`` spans
  are kept.
* ``count(name, n=1)`` adds to ``counts[name]``; counters always count.
* ``spans()`` the records as dicts; ``idle_by_span(events)`` names the
  gaps between a trace's device operations by the span open on the host.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import logging.handlers
import os
import sys
import threading
import time
from collections import Counter, deque
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _torch_profiler

from egovlp_tpu_torch.core.dist import is_main_process


def setup_logging(save_dir: Optional[str] = None,
                  level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger("egovlp_tpu_torch")
    logger.setLevel(level if is_main_process() else logging.WARNING)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            Path(save_dir) / "info.log", maxBytes=10 * 1024 ** 2,
            backupCount=20)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Scalar logging to JSONL and, when ``tensorboardX`` imports, to
    TensorBoard; a no-op unless ``enabled`` and given a ``log_dir``."""

    def __init__(self, log_dir: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled and log_dir is not None
        self._tb = None
        self._jsonl = None
        self._step = 0
        self._mode = ""
        self._t0 = None
        if self.enabled:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(log_dir) / "metrics.jsonl", "a")
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def set_step(self, step: int, mode: str = "train") -> None:
        self._step = step
        self._mode = mode
        now = time.time()
        if self._t0 is not None and step > 0:
            self.scalar("steps_per_sec", 1.0 / max(now - self._t0, 1e-9))
        self._t0 = now

    def scalar(self, name: str, value: float,
               step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        step = self._step if step is None else step
        tag = f"{self._mode}/{name}" if self._mode else name
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        self._jsonl.write(json.dumps(
            {"step": step, "tag": tag, "value": float(value),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def scalars(self, values: Dict[str, float],
                step: Optional[int] = None) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()


class Profiler:
    """A ``torch.profiler`` trace of chosen steps: ``prof = Profiler(
    log_dir, start=10, stop=13)``, then ``prof.step(i)`` once a step; the
    steps from ``start`` up to ``stop`` are written to
    ``{log_dir}/trace_steps{start}-{stop}.json``.  ``start < 0`` or no
    ``log_dir`` turns it off.  ``device``: where the steps run (default:
    CUDA when it is available); on CUDA the trace holds CUDA activity
    alone, on the CPU the host's operators.  The trace also holds the
    spans recorded in its window, as complete events of category
    ``port_span`` (args: ``id``, ``parent``, the span's own args and, for
    a device span on CUDA, ``device_ms``)."""

    def __init__(self, log_dir: Optional[str], start: int = -1,
                 stop: int = -1, device=None):
        self.log_dir = log_dir
        self.start_step = start
        self.stop_step = stop
        self.cuda = (torch.cuda.is_available() if device is None
                     else torch.device(device).type == "cuda")
        self._prof = None
        self._t0 = 0

    def step(self, step: int) -> None:
        if self.log_dir is None or self.start_step < 0:
            return
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[
                ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
            self._t0 = _clock()
            self._prof.start()
        elif step == self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        """Stop an active trace and write it with its window's spans."""
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        window = [s for s in spans() if s["start_ns"] >= self._t0]
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        path = (Path(self.log_dir)
                / f"trace_steps{self.start_step}-{self.stop_step}.json")
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            trace = json.load(f)
        trace["traceEvents"].extend(
            chrome_events(window, trace.get("baseTimeNanoseconds", 0)))
        with open(path, "w") as f:
            json.dump(trace, f)


# --------------------------------------------------------------------------
# Spans and counters
# --------------------------------------------------------------------------

SPAN_CAPACITY = 65536
# the trace's clock; tests patch it to see that an idle span reads none
_clock = time.time_ns
_records: deque = deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count()
_local = threading.local()
_recording = 0
counts: Counter = Counter()


class _NoSpan:
    """The shared context of a span that does not record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "args", "device", "id", "parent", "tid", "start",
                 "end", "events")

    def __init__(self, name: str, device: bool, args: Optional[dict]):
        self.name, self.device, self.args = name, device, dict(args or {})
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if device and torch.cuda.is_initialized() else None)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else -1
        self.tid = threading.get_native_id()
        stack.append(self)
        self.start = _clock()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end = _clock()
        _local.stack.pop()
        _records.append(self)
        return False

    def note(self, **args) -> None:
        """Add to the span's args."""
        self.args.update(args)


def span(name: str, device: bool = False, args: Optional[dict] = None):
    """A context manager that records the work inside it as a span (see
    the module notes); ``with span(...) as s`` gives ``s.note(**args)``."""
    if not (_recording or _torch_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, device, args)


@contextlib.contextmanager
def recording():
    """Record spans inside, with no profiler open."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def count(name: str, n: int = 1) -> None:
    counts[name] += n


def spans() -> List[dict]:
    """The kept spans in the order they began: ``name``, ``id``,
    ``parent``, ``tid``, ``start_ns``, ``end_ns``, ``args`` and
    ``device_ms`` (``[start, end]``; None for a host span).  On CUDA a
    device span's interval is its two events' times in ms from the entry
    event of the first device span kept (each waited for here); on the
    CPU it is its host interval in ms."""
    records = sorted(_records, key=lambda r: r.id)
    ref = next((r.events[0] for r in records if r.events is not None), None)
    out = []
    for r in records:
        dev = None
        if r.events is not None:
            r.events[1].synchronize()
            dev = [ref.elapsed_time(e) for e in r.events]
        elif r.device:
            dev = [r.start / 1e6, r.end / 1e6]
        out.append({"name": r.name, "id": r.id, "parent": r.parent,
                    "tid": r.tid, "start_ns": r.start, "end_ns": r.end,
                    "args": dict(r.args), "device_ms": dev})
    return out


def chrome_events(records: List[dict], base_ns: int = 0) -> List[dict]:
    """``spans()`` records as a Chrome trace's complete events, ``ts`` in
    us after ``base_ns`` (the trace's ``baseTimeNanoseconds``)."""
    pid = os.getpid()
    out = []
    for s in records:
        args = {"id": s["id"], "parent": s["parent"], **s["args"]}
        if s["device_ms"] is not None:
            args["device_ms"] = s["device_ms"][1] - s["device_ms"][0]
        out.append({"ph": "X", "cat": "port_span", "name": s["name"],
                    "pid": pid, "tid": s["tid"],
                    "ts": (s["start_ns"] - base_ns) / 1e3,
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": args})
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_SPAN = "(no span)"


def idle_by_span(events: List[dict], tid: Optional[int] = None) -> Dict:
    """The gaps between a Chrome trace's device operations (kernels,
    copies, sets), each named by the innermost ``port_span`` of the main
    thread open when it began (``NO_SPAN`` where none was), summed by
    name: ``{name: [gaps, ms]}``, the most idle first.  ``tid``: the main
    thread; by default the thread of the longest span."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS and e.get("ph") == "X")
    union = []
    for a, b in dev:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    marks = [e for e in events if e.get("cat") == "port_span"]
    if tid is None and marks:
        tid = max(marks, key=lambda e: e["dur"])["tid"]
    # one thread's spans nest: a sweep keeps the stack of those open
    main = sorted((e for e in marks if e["tid"] == tid),
                  key=lambda e: (e["ts"], -e["dur"]))
    out: Dict[str, list] = {}
    stack, i = [], 0
    for (_, a), (b, _) in zip(union[:-1], union[1:]):
        while i < len(main) and main[i]["ts"] <= a:
            start = main[i]["ts"]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= start:
                stack.pop()
            stack.append(main[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= a:
            stack.pop()
        name = stack[-1]["name"] if stack else NO_SPAN
        total = out.setdefault(name, [0, 0.0])
        total[0] += 1
        total[1] += (b - a) / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))
