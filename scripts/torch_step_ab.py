"""Host time of the PyTorch port's EgoClip training step in one or more
checkouts, on one CUDA device.

    python3 scripts/torch_step_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one; another commit unpacked with ``git archive``).  For each, in the
order given, a fresh Python process imports that tree's
``egovlp_tpu_torch`` and ``chip_smoke.py`` and runs phase 5's step
(``chip_smoke.train_setup``: ``configs/pt/egoclip.json`` at full width,
bf16, random time attention, 16 clips + 16 scene negatives, AdamW) for
18 steps on 3 seeded batches already on the device; a step is timed on
the host clock between two ``torch.cuda.synchronize()`` calls, and the
median, min and max of steps 4-18 are printed.  Give the trees in turns
(``A B B A A B``) so that a drift of the shared host reaches both; the
card's name and power limit come last.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time


def run(tree: str) -> None:
    """Phase 5's step in the checkout ``tree`` (this process)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from egovlp_tpu_torch import build
    from egovlp_tpu_torch.train.recipes import to_device
    from egovlp_tpu_torch.train.state import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    arch, sched, step = cs.train_setup(3)
    model, _ = build.build_model(arch, "cuda")
    build.init_params(model, seed=0)
    opt, _ = make_optimizer(model, **sched)
    rng = np.random.default_rng(0)
    batches = [to_device(cs.egoclip_batch(rng), "cuda") for _ in range(3)]
    times = []
    for i in range(18):
        gen = torch.Generator(device="cuda").manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, opt, batches[i % 3], gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    t = times[3:]
    print(f"step {tree}: median {statistics.median(t):.2f} ms, min "
          f"{min(t):.2f}, max {max(t):.2f} over {len(t)} steps", flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2])
        return
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--run", tree], check=True,
                       timeout=600)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
