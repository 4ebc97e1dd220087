"""Offline evaluation CLI.

    python -m egovlp_tpu_torch.cli.eval --config configs/eval/epic.json \
        --checkpoint results/models/.../checkpoint-epoch2.pth \
        [--dual_softmax] [--split test] [-o dotted.path=value ...] \
        [--device cuda] [--multihost]

Counterpart of ``egovlp_tpu/cli/eval.py``: the metrics of the config's
model on its task, printed as JSON.  ``egoclip`` / ``egomcq``: EgoMCQ
accuracies; ``epic``: nDCG and mAP, with the dual-softmax rescoring when
``--dual_softmax`` is given; ``charades``: the 157-class mAP; ``oscc``:
the state-change accuracy; ``pnr``: the keyframe distance in seconds.
The split is ``--split``, else ``val`` for egoclip, egomcq, oscc and pnr
and ``test`` for epic and charades, as the JAX CLI has it.
``--checkpoint`` takes a torch pickle (a published ``egovlp.pth`` or the
port's own ``checkpoint-epoch{n}.pth``, whose payload holds
``state_dict``), loaded strictly.  The device is ``cuda``
unless ``--device cpu`` is given.  ``--multihost`` (under torchrun) joins
the process group first: each rank evaluates its shard and every rank
gets the whole dataset's metrics; rank 0 prints them.  ``nlq`` / ``mq``
have no metric here and raise, naming ``cli.extract``.  With the config's
``visualizer.type`` set, ``epic`` and ``charades`` also write a ranking
report (``ranking_ep0.html``) under ``{trainer.save_dir}/web``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from egovlp_tpu_torch import build
from egovlp_tpu_torch.cli.train import parse_overrides
from egovlp_tpu_torch.core.dist import init_distributed, is_main_process
from egovlp_tpu_torch.evals.charades import (
    evaluate_charades,
    load_charades_classes,
)
from egovlp_tpu_torch.evals.egomcq import evaluate_egomcq
from egovlp_tpu_torch.evals.epic_mir import embed_dataset, evaluate_epic_mir
from egovlp_tpu_torch.evals.oscc_pnr import evaluate_oscc, evaluate_pnr
from egovlp_tpu_torch.io.config import load_config
from egovlp_tpu_torch.io.logging import setup_logging
from egovlp_tpu_torch.metrics.mir import load_epic_annotations
from egovlp_tpu_torch.models.dual_encoder import sim_matrix
from egovlp_tpu_torch.train.recipes import (
    _dl_args,
    _visualizer,
    classes_file,
    infer_task,
    resolve_device,
)

TASKS = ("egoclip", "egomcq", "epic", "charades", "oscc", "pnr")
VAL_SPLIT_TASKS = ("egoclip", "egomcq", "oscc", "pnr")


def main(argv=None):
    ap = argparse.ArgumentParser(description="egovlp_tpu_torch evaluator")
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--checkpoint", "-k", default=None,
                    help="torch .pth/.pt/.bin")
    ap.add_argument("--dual_softmax", action="store_true",
                    help="epic: dual-softmax rescoring of raw dot products")
    ap.add_argument("--split", default=None,
                    help="default: val (egoclip, egomcq, oscc, pnr), test "
                         "(epic, charades)")
    ap.add_argument("--override", "-o", action="append", default=[],
                    metavar="dotted.path=value",
                    help="arbitrary config override (JSON-parsed value)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multihost", action="store_true",
                    help="join torchrun's process group before running")
    args = ap.parse_args(argv)

    if args.multihost:
        init_distributed(args.device)
    logger = setup_logging()
    config = load_config(args.config)
    parse_overrides(config, args.override)
    task = infer_task(config)
    if task in ("nlq", "mq"):
        raise NotImplementedError(
            f"task {task!r} has no evaluation: extract its features with "
            "`python -m egovlp_tpu_torch.cli.extract`")
    if task not in TASKS:
        raise NotImplementedError(f"unknown task {task!r}")
    split = args.split or ("val" if task in VAL_SPLIT_TASKS else "test")
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
    bs = (int(config.get("trainer", {}).get("val_batch_size", 8))
          if task in ("egoclip", "egomcq") else None)
    loader = build.build_loader(dl_args, split, tokenizer, batch_size=bs)
    loader.drop_last = False  # every item of the split, whichever it is
    visualizer = _visualizer(config)
    try:
        if task == "epic":
            t, v, _, meta = embed_dataset(model, loader, input_res,
                                          return_meta=True)
            metrics = evaluate_epic_mir(
                t, v, *load_epic_annotations(
                    dl_args.get("meta_dir") or dl_args["data_dir"]),
                use_dual_softmax=args.dual_softmax)
            if visualizer is not None:
                sims = sim_matrix(torch.from_numpy(t), torch.from_numpy(v))
                page = visualizer.visualize_ranking(
                    sims.numpy(), 0, meta["texts"], meta["paths"])
                logger.info("wrote retrieval report %s", page)
        elif task in ("oscc", "pnr"):
            evaluate = evaluate_oscc if task == "oscc" else evaluate_pnr
            metrics = evaluate(model, loader, input_res)
        elif task == "charades":
            metrics = evaluate_charades(
                model, loader,
                load_charades_classes(classes_file(config, dl_args)),
                tokenizer, input_res, visualizer=visualizer)
        else:
            metrics = evaluate_egomcq(model, loader, input_res)
    finally:
        loader.close()
    if is_main_process():
        print(json.dumps(metrics, indent=2, default=float))
    if args.multihost:
        dist.destroy_process_group()
    return metrics


if __name__ == "__main__":
    main()
