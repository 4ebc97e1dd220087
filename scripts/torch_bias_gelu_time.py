"""K7 (the MLP's bias add + exact GELU, ``kernels/bias_gelu.py``) on the
card alone: ``chip_smoke.py``'s phase 3d without the smoke's other phases.

    python3 scripts/torch_bias_gelu_time.py [--out DIR]

Phase 3d holds K7-fwd and K7-bwd to their plain twins at the benchmark
cells' MLP shapes and times them (kernel, device, plain and library ms)
against their byte bound; see ``chip_smoke.phase_bias_gelu``.  This prints
its lines and writes its rows, with the card's name and power limit, to
``DIR/bias_gelu_time.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = chip_smoke.phase_bias_gelu(smi)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "bias_gelu_time.json").write_text(
        json.dumps({"nvidia_smi": smi, "kernels": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
