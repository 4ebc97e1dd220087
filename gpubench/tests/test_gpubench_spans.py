"""The readers of the port's spans (``gpubench/spans.py`` and the six
metrics that use it): a traced run of the tiny checkout reads them all on
the CPU (host intervals in place of the device's), each finds None where
no span was recorded or the program records none, and every cell lists
them."""

import collections
import json
import subprocess
import sys

import pytest

from gpubench import harness, spans
from gpubench.tests import tiny

SPAN_METRICS = ("fwd_ms.train", "bwd_ms.train", "opt_ms.train",
                "between_ms.train", "feed_wait_ms", "h2d_gbps")


def test_a_traced_run_reads_the_span_metrics(tmp_path):
    root = tiny.make(tmp_path, limit=1e-2)
    proc = tiny.run(root, "tiny-epic", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    got = {m: out["metrics"][m]["value"] for m in SPAN_METRICS}
    assert all(v > 0 for k, v in got.items() if k != "between_ms.train"), got
    assert got["between_ms.train"] >= 0
    # the three phases and the waits between steps fill the traced steps
    assert got["fwd_ms.train"] > got["opt_ms.train"]
    assert out["metrics"]["feed_wait_ms"]["unit"] == "ms"
    assert out["metrics"]["h2d_gbps"]["unit"] == "GB/s"


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_reader_finds_none_without_spans(monkeypatch, metric):
    from egovlp_tpu_torch.io import logging as port_logging

    read = harness.reader(metric)
    monkeypatch.setattr(port_logging, "_records", collections.deque())
    assert spans.traced_epoch() is None and read({}) is None
    # a program that records no spans at all
    monkeypatch.delattr(port_logging, "spans")
    assert read({}) is None


def test_every_cell_lists_the_span_metrics():
    out = subprocess.run([sys.executable, "gpubench/run.py", "--list"],
                         cwd=tiny.REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    listed = json.loads(out.stdout)
    assert listed and all(set(SPAN_METRICS) <= set(cell["per_layer"])
                          for cell in listed.values())
