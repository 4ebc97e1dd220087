"""The harness on the CPU: the contract's static rules on ``BENCHMARK.json``,
the import guard, the data-driven lookup, the refusal without a chip or
without the port, and ``correct`` at tiny widths: true for the port, false
for each planted fault and for the lower-precision control."""

import json
import math
import pathlib
import re
import subprocess
import sys

import pytest

from gpubench import harness
from gpubench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpubench/")
        assert (tiny.REPO / c["file"]).is_file()
        assert json.loads((tiny.REPO / c["file"]).read_text())["reduced"] \
            == c["reduced"]
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_name_finds_its_files():
    listed = harness.listing(BENCH)
    assert list(listed) == [w["name"] for w in BENCH["workloads"]]
    for cell in listed.values():
        assert cell["kind"] == "train" and "setup_s" in cell["end_to_end"]
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    # a per-layer metric's cells report the end-to-end metric it moves
    for m in BENCH["per_layer"]:
        assert all(m["moves"] in listed[w]["end_to_end"]
                   for w in m["workloads"])


def fresh(code: str, cwd=tiny.REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_nothing_the_harness_runs_loads_jax():
    """The harness's modules, the readers, the reference and every port
    module the harness imports, in one fresh interpreter: no top-level
    module named jax, jaxlib, flax, optax, orbax or egovlp_tpu (compared
    whole: egovlp_tpu_torch is the port)."""
    code = """
import sys, pathlib
sys.path.insert(0, '.')
from gpubench import harness, run, readings, faults, tracing, roofline
from gpubench.traffic import train
from gpubench.reference import model, train as rt
for p in sorted(pathlib.Path('gpubench/metrics').glob('*.py')):
    harness.reader(p.stem)
from egovlp_tpu_torch import build
from egovlp_tpu_torch.train import recipes, state, steps
from egovlp_tpu_torch.kernels import cuda_attention
found = harness.banned_modules()
assert 'egovlp_tpu_torch' in sys.modules
print(found)
assert not found, found
"""
    out = fresh(code)
    assert out.returncode == 0, out.stdout + out.stderr
    assert harness.banned_modules.__doc__


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "egovlp_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxy.core", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "egovlp_tpu.models", sys)
    assert harness.banned_modules() == ["egovlp_tpu.models"]


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries only: the harness lists them."""
    root = tiny.make(tmp_path)
    g = root / "gpubench"
    (g / "configs" / "other.json").write_text(json.dumps(
        {"name": "other", "arch": tiny.tiny_arch()}))
    (g / "traffic" / "mix2.json").write_text(json.dumps(tiny.traffic("epic")))
    (g / "workloads" / "other-mix2.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}))
    (g / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "other", "source": "test",
                             "file": "gpubench/configs/other.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "other-mix2", "config": "other",
                               "traffic": "mix2", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "x",
                               "better": "lower", "source": "program_counter",
                               "layer": "test", "moves": "samples_per_s",
                               "workloads": ["other-mix2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "gpubench/run.py", "--list"],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    listed = json.loads(out.stdout)
    assert listed["other-mix2"]["config"] == "gpubench/configs/other.json"
    assert "new_metric" in listed["other-mix2"]["per_layer"]
    assert "new_metric" not in listed["tiny-epic"]["per_layer"]


def test_no_chip_no_result():
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tiny.REPO, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout == "", out.stderr


def test_the_benchmark_alone_is_no_program(tmp_path):
    """A directory with only BENCHMARK.json and gpubench/: the port is
    missing, so the run fails and prints no result."""
    root = tiny.make(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); from gpubench import run;"
         "run.main(['--workload', 'tiny-epic', '--seconds', '0.2'], "
         "need_chip=False)"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "egovlp_tpu_torch" in out.stderr


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"), limit=1e-2)


def result(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks"
    tail = proc.stderr.strip().splitlines()[-len(out["checks"]):]
    assert all(line.startswith("check ") for line in tail)
    return out


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_port_is_correct(checkout, cell):
    out = result(tiny.run(checkout, cell, seed=2 ** 31 + 11))
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["metrics"]) == {"samples_per_s", "peak_gib", "setup_s"}


def test_a_traced_run_reads_the_per_layer_metrics(checkout):
    out = result(tiny.run(checkout, "tiny-egoclip", trace=1))
    assert out["correct"] is True
    # no device on the CPU: the trace-read metrics find nothing to read
    assert {"host_ms_per_step", "prefetch_wait_ms", "mfu"} <= set(out["metrics"])
    assert "attn_roofline" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in tiny.CELLS for f in ("frozen", "half_batch", "altered_row")])
def test_each_planted_fault_is_not_correct(checkout, cell, fault):
    out = result(tiny.run(checkout, cell, fault=fault))
    assert out["correct"] is False
    failed = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    assert failed, out["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_fp8_control_is_not_correct(checkout, cell):
    """The reference in the program's place with fp8 matmuls, against the
    float32 reference, at the tiny cells' limits."""
    sys.path.insert(0, str(checkout))
    try:
        from gpubench.traffic import train
        t = json.loads((checkout / "gpubench" / "traffic" /
                        f"{cell}.json").read_text())
        conf = json.loads((checkout / "gpubench" / "configs" /
                           "tiny.json").read_text())
        run = train.TrainCell(conf, t, 17, "cpu")
        got = train.compare(run.reference_readings(quant="fp8"),
                            run.reference_readings())
    finally:
        sys.path.remove(str(checkout))
    assert any(v > 1e-2 for v in got.values()), got
    assert all(math.isfinite(v) for v in got.values())


@pytest.mark.cuda
def test_the_fp8_control_fails_at_a_cells_size():
    """On the card: the control at the first cell's own size fails the
    committed limits (``readings.py --plan fp8:...`` reads three seeds)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gpubench import readings
    from gpubench.traffic import train

    name = BENCH["workloads"][0]["name"]
    cell = harness.cell(BENCH, name)
    got = readings.reading(train, harness.config(BENCH, cell["config"]),
                           harness.traffic(cell["traffic"]), 5,
                           torch.device("cuda", 0), "fp8")
    limits = harness.limits(name)
    assert any(got["checks"][k] > limits[k] for k in limits), got


def test_paths_hold_the_benchmark_only():
    files = [p for p in (tiny.REPO / "gpubench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts]
    assert all(re.match(r"^[A-Za-z0-9_/.-]+$", str(p.relative_to(tiny.REPO)))
               for p in files)
    assert pathlib.Path(harness.HERE).name == "gpubench"
