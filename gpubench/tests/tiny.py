"""A checkout of the benchmark at tiny widths, for tests on the CPU: the
``gpubench`` folder copied beside a ``BENCHMARK.json`` that holds two tiny
cells (EgoClip with negatives and EPIC max-margin) of one tiny
configuration, with their traffic and limits files."""

import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
CELLS = ("tiny-egoclip", "tiny-epic")


def tiny_arch(precision: str = "fp32") -> dict:
    return {"type": "FrozenInTime", "args": {
        "video_params": {"img_size": 32, "patch_size": 16, "embed_dim": 32,
                         "depth": 2, "num_heads": 2, "mlp_ratio": 4.0,
                         "remat": False},
        "text_params": {"vocab_size": 1100, "dim": 32, "n_layers": 1,
                        "n_heads": 2, "hidden_dim": 64,
                        "max_position_embeddings": 16, "max_length": 8},
        "projection": "minimal", "projection_dim": 16,
        "precision": precision}}


def traffic(task: str) -> dict:
    t = {"kind": "train", "task": task, "batch_size": 4, "num_frames": 2,
         "pre_size": 40, "input_res": 32, "negatives": task == "egoclip",
         "text_tokens": [2, 5], "pool": 3, "optimizer": {"lr": 1e-3}}
    if task == "egoclip":
        t.update(noun_vec=[10, 2], verb_vec=[6, 2],
                 loss={"type": "EgoNCE", "args": {}})
    else:
        t.update(loss={"type": "MaxMarginRankingLoss",
                       "args": {"margin": 0.2}})
        t["optimizer"]["mu_dtype"] = "bfloat16"
    return t


def make(root: pathlib.Path, precision: str = "fp32",
         limit: float = 1e-3) -> pathlib.Path:
    """The tiny checkout under ``root``; returns ``root``."""
    shutil.copytree(REPO / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    g = root / "gpubench"
    (g / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "arch": tiny_arch(precision)}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "gpubench/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = []
    for name, task in zip(CELLS, ("egoclip", "epic")):
        (g / "traffic" / f"{name}.json").write_text(json.dumps(traffic(task)))
        (g / "workloads" / f"{name}.json").write_text(json.dumps(
            {"limits": {"embed_gap": limit, "loss_gap": limit,
                        "grad_gap": limit, "change_gap": limit}}))
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": name, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"] = list(CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: pathlib.Path, cell: str, seed: int = 5, trace: int = 0,
        fault: str = "", need_chip: bool = False, extra=()):
    """``gpubench/run.py`` in a fresh interpreter from ``root`` on the CPU
    (the look for a chip skipped, ``fault`` planted): the completed
    process."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from gpubench import faults, run;"
        f"run.main(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '0.5', '--trace', '{trace}', *{list(extra)!r}], "
        f"need_chip={need_chip!r}, "
        f"fault={f'faults.FAULTS[{fault!r}]' if fault else None})")
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2",
                               "PYTHONPATH": str(REPO)})
