"""Offline evaluation CLI.

    python -m egovlp_tpu_torch.cli.eval --config configs/eval/egomcq.json \
        --checkpoint results/models/.../checkpoint-epoch2.pth \
        [--split val] [-o dotted.path=value ...] [--device cuda]

Counterpart of the ``egoclip``/``egomcq`` branch of
``egovlp_tpu/cli/eval.py`` (:46-86): EgoMCQ accuracies of the config's
model, printed as JSON.  ``--checkpoint`` takes a torch pickle (a
published ``egovlp.pth`` or the port's own ``checkpoint-epoch{n}.pth``,
whose payload holds ``state_dict``), loaded strictly.  The device is
``cuda`` unless ``--device cpu`` is given.  The other tasks are still to
port (``ROADMAP.md``, Queue A, A11).
"""

from __future__ import annotations

import argparse
import json
import os

from egovlp_tpu_torch import build
from egovlp_tpu_torch.cli.train import parse_overrides
from egovlp_tpu_torch.evals.egomcq import evaluate_egomcq
from egovlp_tpu_torch.io.config import load_config
from egovlp_tpu_torch.io.logging import setup_logging
from egovlp_tpu_torch.train.recipes import _dl_args, infer_task, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description="egovlp_tpu_torch evaluator")
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--checkpoint", "-k", default=None,
                    help="torch .pth/.pt/.bin")
    ap.add_argument("--split", default="val")
    ap.add_argument("--override", "-o", action="append", default=[],
                    metavar="dotted.path=value",
                    help="arbitrary config override (JSON-parsed value)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logger = setup_logging()
    config = load_config(args.config)
    parse_overrides(config, args.override)
    task = infer_task(config)
    if task not in ("egoclip", "egomcq"):
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP.md, Queue A, A11)")
    device = resolve_device(args.device)
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"--checkpoint {args.checkpoint}: not found")
        config.override("arch.args.load_checkpoint", args.checkpoint)
    arch = config["arch"]
    model, _ = build.build_model(arch, device)
    build.load_pretrained(build.init_params(model), arch, logger)

    dl_args = _dl_args(config)
    tokenizer = build.build_tokenizer(
        config, int(config.get_path("arch.args.text_params.max_length", 30)))
    input_res = int(dl_args.get("video_params", {}).get("input_res", 224))
    bs = int(config.get("trainer", {}).get("val_batch_size", 8))
    loader = build.build_loader(dl_args, args.split, tokenizer, batch_size=bs)
    try:
        metrics = evaluate_egomcq(model, loader, input_res)
    finally:
        loader.close()
    print(json.dumps(metrics, indent=2, default=float))
    return metrics


if __name__ == "__main__":
    main()
