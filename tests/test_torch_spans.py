"""The port's spans and counters (``egovlp_tpu_torch/io/logging.py``).

* With no profiler and no ``recording()`` a span is one shared no-op: it
  reads no clock, makes no CUDA event and records nothing.
* A two-step EgoClip epoch through ``make_train_epoch_fn`` under the
  ``Profiler`` (CPU activity on the CPU) records ``loop.epoch``, a
  ``loop.step`` a step whose children are ``step.forward`` (with its child
  ``step.inputs``), ``step.backward`` and ``step.optimizer`` in that order,
  ``prefetch.wait`` on the main thread and ``prefetch.copy`` on the feed's
  thread; the counters count the batches and bytes fed; the trace holds
  the spans, and the host operators of each phase fall inside its span on
  the trace's clock to within 1 ms.
* ``idle_by_span`` on a hand-built trace.
* On the card (``cuda`` marker): the device spans' CUDA events, and the
  kernel launches of the steps inside their ``loop.step`` spans.

The model is a tiny random one built by ``build.build_model``; no JAX.
"""

import json
import logging
import threading

import numpy as np
import pytest
import torch

from egovlp_tpu_torch import build
from egovlp_tpu_torch.io import logging as port_logging
from egovlp_tpu_torch.train.recipes import make_train_epoch_fn
from egovlp_tpu_torch.train.state import make_optimizer
from egovlp_tpu_torch.train.steps import make_egoclip_train_step

ARCH = {"type": "FrozenInTime", "args": {
    "video_params": {"img_size": 32, "patch_size": 16, "embed_dim": 32,
                     "depth": 2, "num_heads": 2, "mlp_ratio": 4.0,
                     "num_frames": 2},
    "text_params": {"vocab_size": 100, "dim": 32, "n_layers": 1,
                    "n_heads": 2, "hidden_dim": 64,
                    "max_position_embeddings": 16, "max_length": 8},
    "projection": "minimal", "projection_dim": 16, "precision": "fp32"}}
EPOCH, STEPS, SLACK_US = 3, 2, 1000.0
PHASES = ["step.forward", "step.backward", "step.optimizer"]


def batches(n=STEPS, b=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"_index": np.arange(b)}
        for suffix in ("", "_neg"):
            batch["frames" + suffix] = rng.integers(
                0, 256, (b, 2, 40, 40, 3)).astype(np.uint8)
            name = "text_neg" if suffix else "text"
            batch[f"{name}_ids"] = rng.integers(4, 100, (b, 8)).astype(
                np.int32)
            batch[f"{name}_mask"] = np.ones((b, 8), np.int32)
            for key, dim in (("noun_vec", 6), ("verb_vec", 4)):
                batch[key + suffix] = np.eye(dim, dtype=np.float32)[
                    rng.integers(0, dim, b)]
        out.append(batch)
    return out


def payload_bytes(batch):
    return sum(v.nbytes for k, v in batch.items() if not k.startswith("_"))


def traced_epoch(device, log_dir):
    """A two-step epoch under the ``Profiler``: (the spans it recorded, the
    counters' growth, the trace's events, the batches fed)."""
    model, _ = build.build_model(ARCH, device)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.02)
    opt, _ = make_optimizer(model, base_lr=1e-3, milestones=())
    fed = batches()
    step = make_egoclip_train_step(input_res=32)
    epoch_fn = make_train_epoch_fn([fed], step, device, seed=1)
    epoch_fn(model, opt, 1, logging.getLogger("test"))  # warm, not recorded
    last = max((s["id"] for s in port_logging.spans()), default=-1)
    counts = dict(port_logging.counts)
    prof = port_logging.Profiler(str(log_dir), start=0, stop=1, device=device)
    prof.step(0)
    epoch_fn(model, opt, EPOCH, logging.getLogger("test"))
    prof.step(1)
    spans = [s for s in port_logging.spans() if s["id"] > last]
    grown = {k: port_logging.counts[k] - counts.get(k, 0)
             for k in ("prefetch.batches", "prefetch.bytes")}
    (path,) = log_dir.iterdir()
    return spans, grown, json.loads(path.read_text())["traceEvents"], fed


@pytest.fixture(scope="module")
def cpu_epoch(tmp_path_factory):
    return traced_epoch("cpu", tmp_path_factory.mktemp("prof"))


def test_an_idle_span_reads_no_clock_and_records_nothing(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("an idle span read a clock or made an event")

    monkeypatch.setattr(port_logging, "_clock", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert not torch.autograd.profiler._is_profiler_enabled
    kept = len(port_logging.spans())
    a = port_logging.span("a", device=True)
    b = port_logging.span("b", args={"epoch": 1})
    assert a is b
    with a as s, b:
        s.note(bytes=3)
    assert len(port_logging.spans()) == kept
    before = port_logging.counts["test.counter"]
    port_logging.count("test.counter", 5)  # counters always count
    assert port_logging.counts["test.counter"] == before + 5


def test_recording_records_with_no_profiler(monkeypatch):
    ticks = iter(range(1000, 2000, 10))
    monkeypatch.setattr(port_logging, "_clock", lambda: next(ticks))
    last = max((s["id"] for s in port_logging.spans()), default=-1)
    with port_logging.recording():
        with port_logging.span("outer", args={"k": 1}) as outer:
            with port_logging.span("inner", device=True) as inner:
                inner.note(bytes=7)
    assert port_logging.span("after") is port_logging.span("again")
    got = {s["name"]: s for s in port_logging.spans() if s["id"] > last}
    assert set(got) == {"outer", "inner"}
    assert got["outer"]["parent"] == -1 and got["outer"]["args"] == {"k": 1}
    assert got["inner"]["parent"] == outer.id == got["outer"]["id"]
    assert got["inner"]["args"] == {"bytes": 7}
    assert got["outer"]["device_ms"] is None
    # on the CPU a device span's interval is its host interval
    inner_ns = (got["inner"]["start_ns"], got["inner"]["end_ns"])
    assert got["inner"]["device_ms"] == [t / 1e6 for t in inner_ns]
    assert got["outer"]["start_ns"] < inner_ns[0] < inner_ns[1] \
        < got["outer"]["end_ns"]
    assert got["inner"]["tid"] == threading.get_native_id()


def test_the_epoch_records_its_spans(cpu_epoch):
    spans, _, _, _ = cpu_epoch
    by_id = {s["id"]: s for s in spans}
    (epoch,) = [s for s in spans if s["name"] == "loop.epoch"]
    assert epoch["args"] == {"epoch": EPOCH} and epoch["parent"] == -1
    main = threading.get_native_id()
    steps = [s for s in spans if s["name"] == "loop.step"]
    assert len(steps) == STEPS
    for step in steps:
        assert step["parent"] == epoch["id"] and step["tid"] == main
        children = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["start_ns"])
        assert [s["name"] for s in children] == PHASES
        for a, b in zip(children[:-1], children[1:]):
            assert a["end_ns"] <= b["start_ns"]
        (inputs,) = [s for s in spans if s["name"] == "step.inputs"
                     and by_id[s["parent"]]["parent"] == step["id"]]
        assert by_id[inputs["parent"]]["name"] == "step.forward"
        assert all(s["device_ms"] is not None for s in children + [inputs])
    waits = [s for s in spans if s["name"] == "prefetch.wait"]
    # one wait a batch and one for the end of the feed
    assert len(waits) == STEPS + 1
    assert all(s["tid"] == main and s["parent"] == epoch["id"] for s in waits)
    copies = [s for s in spans if s["name"] == "prefetch.copy"]
    assert len(copies) == STEPS
    assert all(s["tid"] != main and s["parent"] == -1 for s in copies)
    assert all(epoch["start_ns"] <= s["start_ns"] <= s["end_ns"]
               <= epoch["end_ns"] for s in spans)


def test_the_counters_count_the_batches_and_bytes_fed(cpu_epoch):
    spans, grown, _, fed = cpu_epoch
    want = sum(payload_bytes(b) for b in fed)
    assert grown == {"prefetch.batches": len(fed), "prefetch.bytes": want}
    assert sum(s["args"]["bytes"] for s in spans
               if s["name"] == "prefetch.copy") == want


def inside(event, span, slack=SLACK_US):
    return (span["ts"] - slack <= event["ts"]
            and event["ts"] + event["dur"] <= span["ts"] + span["dur"] + slack)


def test_the_trace_holds_the_spans_on_its_clock(cpu_epoch):
    """The forward's operators (the text tower's embeddings), the autograd
    engine's backward functions and the optimizer's step each fall inside
    their phase's span and outside the other two."""
    spans, _, events, _ = cpu_epoch
    marks = [e for e in events if e.get("cat") == "port_span"]
    assert sorted(e["args"]["id"] for e in marks) == \
        sorted(s["id"] for s in spans)
    for e in marks:
        assert e["ph"] == "X" and "parent" in e["args"]
    phase = {name: [e for e in marks if e["name"] == name]
             for name in PHASES + ["loop.step"]}
    ops = [e for e in events if e.get("ph") == "X"
           and any(inside(e, s, 0) for s in phase["loop.step"])]
    groups = {
        "step.forward": [e for e in ops if e["name"] == "aten::embedding"],
        "step.backward": [e for e in ops if e["name"].startswith(
            "autograd::engine::evaluate_function")],
        "step.optimizer": [e for e in ops
                           if e["name"].startswith("Optimizer.step#")],
    }
    for name, group in groups.items():
        assert len(group) >= STEPS, name
        for e in group:
            assert any(inside(e, s) for s in phase[name]), (name, e)
            others = [s for n in PHASES if n != name for s in phase[n]]
            assert not any(inside(e, s, 0) for s in others), (name, e)


def rounded(table):
    return {k: (n, round(ms, 9)) for k, (n, ms) in table.items()}


def test_idle_by_span_names_and_sums_the_gaps():
    def op(ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}

    def mark(name, ts, dur, tid=1):
        return {"ph": "X", "cat": "port_span", "name": name, "ts": ts,
                "dur": dur, "tid": tid, "args": {}}

    events = [
        op(0, 10), op(12, 8), op(25, 5, "gpu_memcpy"), op(30, 10),
        op(35, 2, "gpu_memset"), op(50, 10), op(150, 10), op(400, 10),
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 100,
         "dur": 50},
        mark("A", 0, 300), mark("B", 9, 4), mark("C", 19, 7),
        mark("P", 0, 150, tid=2),
    ]
    # gaps: 10-12 in B, 20-25 in C, 40-50 and 60-150 in A, 160-400 in A
    want = {"A": [3, (10 + 90 + 240) / 1e3], "C": [1, 5 / 1e3],
            "B": [1, 2 / 1e3]}
    got = port_logging.idle_by_span(events)
    assert rounded(got) == rounded(want) and list(got) == ["A", "C", "B"]
    # on the other thread: every gap began inside P but the last
    got = port_logging.idle_by_span(events, tid=2)
    assert rounded(got) == rounded({port_logging.NO_SPAN: [1, 0.24],
                                    "P": [4, 0.107]})
    assert port_logging.idle_by_span([op(0, 1)]) == {}


@pytest.mark.cuda
def test_cuda_device_spans_and_launches_inside_the_steps(tmp_path):
    """On the card: each phase's device interval is its events' (inside
    its step's, in order), the copies' on the copy stream, and every
    kernel launch of the main and autograd threads in the epoch falls
    inside a ``loop.step`` span of the trace, whose activity is CUDA's
    alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    spans, grown, events, fed = traced_epoch(device, tmp_path)
    assert grown["prefetch.bytes"] == sum(payload_bytes(b) for b in fed)
    assert not any(e.get("cat") == "cpu_op" for e in events)
    for step in (s for s in spans if s["name"] == "loop.step"):
        children = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["start_ns"])
        assert [s["name"] for s in children] == PHASES
        dev = [s["device_ms"] for s in children]
        assert all(a <= b for a, b in dev)
        assert all(x[1] <= y[0] for x, y in zip(dev[:-1], dev[1:]))
    assert all(s["device_ms"][1] > s["device_ms"][0] for s in spans
               if s["name"] == "prefetch.copy")
    marks = [e for e in events if e.get("cat") == "port_span"]
    (epoch,) = [e for e in marks if e["name"] == "loop.epoch"]
    steps = [e for e in marks if e["name"] == "loop.step"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "Launch" in e["name"] and inside(e, epoch, 0)]
    assert launches
    out = [e for e in launches if not any(inside(e, s, 0) for s in steps)]
    assert len(out) <= 0.01 * len(launches), out[:5]
