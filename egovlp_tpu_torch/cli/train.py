"""Training CLI.

    python -m egovlp_tpu_torch.cli.train --config configs/pt/egoclip.json \
        [--lr 3e-5] [--bs 16] [--resume PATH] [-o trainer.epochs=2 ...] \
        [--device cuda]

Counterpart of ``egovlp_tpu/cli/train.py``: one process on one device
(``cuda`` by default; it raises when no CUDA device is present unless
``--device cpu`` is given).  ``--bs`` is the batch size of this process.
Multi-process runs (``--multihost``) come with DDP (``ROADMAP.md``,
Queue A, A9).
"""

from __future__ import annotations

import argparse
import json

from egovlp_tpu_torch.io.config import load_config
from egovlp_tpu_torch.train.recipes import run_task


def parse_overrides(config, overrides) -> None:
    """Apply ``dotted.path=value`` overrides, values parsed as JSON where
    they parse (else kept as strings)."""
    for ov in overrides:
        k, _, v = ov.partition("=")
        try:
            v = json.loads(v)
        except ValueError:
            pass
        config.override(k, v)


def main(argv=None):
    ap = argparse.ArgumentParser(description="egovlp_tpu_torch trainer")
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--resume", "-r", default=None)
    ap.add_argument("--lr", type=float, default=None,
                    help="override optimizer.args.lr")
    ap.add_argument("--bs", type=int, default=None,
                    help="override data_loader.args.batch_size")
    ap.add_argument("--override", "-o", action="append", default=[],
                    metavar="dotted.path=value",
                    help="arbitrary config override (JSON-parsed value)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = load_config(args.config)
    if args.lr is not None:
        config.override("optimizer.args.lr", args.lr)
    if args.bs is not None:
        config.override("data_loader.args.batch_size", args.bs)
    parse_overrides(config, args.override)
    return run_task(config, resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
