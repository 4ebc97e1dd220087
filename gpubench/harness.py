"""The benchmark's harness: it finds everything by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.  A
cell names a configuration, ``gpubench/configs/<config>.json``, and a
traffic mix, ``gpubench/traffic/<traffic>.json``, whose ``kind`` names the
module that runs it, ``gpubench/traffic/<kind>.py`` (its ``Cell``, its
``compare`` and its ``end_to_end``).  A cell's limits for ``correct`` are
in ``gpubench/workloads/<cell>.json``.  A per-layer metric is read by
``gpubench/metrics/<metric>.py`` (its ``read(ctx)``, which returns a
number, or None where it finds nothing to read).  Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "egovlp_tpu")


def root() -> pathlib.Path:
    return HERE.parent


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(root() / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                     f"({', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root() / c["file"])
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def kind_module(kind: str):
    return importlib.import_module(f"gpubench.traffic.{kind}")


def limits(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")["limits"]


def metrics_of(bench: dict, section: str, workload: str) -> list:
    """The ``section`` metrics (``end_to_end`` / ``per_layer``) that
    ``workload`` reports."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def reader(metric: str):
    """``gpubench/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def listing(bench: dict) -> dict:
    """Every cell with its configuration file, traffic kind, limits file
    and metrics; raises where a file a name points to is missing."""
    out = {}
    for w in bench["workloads"]:
        conf = next(c for c in bench["configs"] if c["name"] == w["config"])
        t = traffic(w["traffic"])
        for path in (root() / conf["file"], HERE / "traffic" / f"{t['kind']}.py",
                     HERE / "workloads" / f"{w['name']}.json"):
            if not path.is_file():
                raise FileNotFoundError(path)
        per_layer = [m["name"] for m in metrics_of(bench, "per_layer", w["name"])]
        for m in per_layer:
            if not (HERE / "metrics" / f"{m}.py").is_file():
                raise FileNotFoundError(HERE / "metrics" / f"{m}.py")
        out[w["name"]] = {
            "config": conf["file"], "kind": t["kind"],
            "end_to_end": [m["name"] for m in
                           metrics_of(bench, "end_to_end", w["name"])],
            "per_layer": per_layer}
    return out


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of ``BANNED``, compared
    whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in BANNED})
