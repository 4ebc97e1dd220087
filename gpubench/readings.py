"""The readings that set a cell's limits for ``correct``, at the cell's own
sizes, many seeds in one process (no measured window: a training cell's
numbers come from its first steps).

    python3 gpubench/readings.py --workload <name> --plan port:1-12,fp8:1-3

``--plan`` names sides, each with its seeds (``a-b`` or ``a;b;c``):
``port`` (sound runs of the program: the lower readings),
``fp8`` (the control: the reference in the program's place, its linear
layers as fp8 matmuls, the precision below the configuration's bf16), or a fault planted under the port's timed path
(``frozen``, ``half_batch``, ``altered_row``: ``gpubench/faults.py``).
Each seed prints one JSON line: the side, the seed and the compared
numbers.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import faults, harness  # noqa: E402


def reading(kind, config, traffic, seed, device, side) -> dict:
    run = kind.Cell(config, traffic, seed, device,
                    fault=faults.FAULTS.get(side))
    start = time.perf_counter()
    if side == "fp8":
        program = run.reference_readings(quant="fp8")
    else:
        run.setup()
        run.release()
        program = run.program_readings()
    reference = run.reference_readings()
    return {"side": side, "seed": seed,
            "checks": kind.compare(program, reference),
            "worst": kind.worst_leaves(program, reference),
            "losses": [program["losses"], reference["losses"]],
            "seconds": time.perf_counter() - start}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--plan", required=True,
                   help="side:seeds,side:seeds,...; seeds a-b or a;b;c")
    args = p.parse_args(argv)
    plan = []
    for part in args.plan.split(","):
        side, seeds = part.split(":")
        if side not in ("port", "fp8", *faults.FAULTS):
            raise SystemExit(f"unknown side {side!r}")
        if "-" in seeds:
            a, b = (int(x) for x in seeds.split("-"))
            plan += [(side, s) for s in range(a, b + 1)]
        else:
            plan += [(side, int(s)) for s in seeds.split(";")]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", 0)
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.config(bench, cell["config"])
    traffic = harness.traffic(cell["traffic"])
    kind = harness.kind_module(traffic["kind"])
    for side, seed in plan:
        print(json.dumps({"workload": cell["name"],
                          **reading(kind, config, traffic, seed, device,
                                    side)}), flush=True)
        torch.cuda.empty_cache()
    banned = harness.banned_modules()
    if banned:
        raise SystemExit(f"loaded modules of JAX or the JAX package: {banned}")


if __name__ == "__main__":
    main()
