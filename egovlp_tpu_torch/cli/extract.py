"""NLQ / MQ dense feature extraction CLI.

    python -m egovlp_tpu_torch.cli.extract --config configs/eval/nlq.json \
        --out features/nlq [--checkpoint x.pth] [--subsample video|text] \
        [--split val] [--token_level] [--save_format npy|pt] \
        [-o dotted.path=value ...] [--device cuda]

Counterpart of ``egovlp_tpu/cli/extract.py``: the config's model (its
``load_checkpoint``, or ``--checkpoint``, a torch pickle loaded
strictly), the config's NLQ / MQ dataset on ``--split`` in the
``--subsample`` mode (else the config's), and one feature file a clip
(video) or a query (text) in ``--out`` (``evals/features.py``).  The
mode is the dataset's: MQ extracts video features whatever
``--subsample`` says (the JAX CLI would feed its video items to the text
extractor).  The device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

from egovlp_tpu_torch import build
from egovlp_tpu_torch.cli.train import parse_overrides
from egovlp_tpu_torch.evals.features import (
    extract_text_features,
    extract_video_features,
)
from egovlp_tpu_torch.io.config import load_config
from egovlp_tpu_torch.io.logging import setup_logging
from egovlp_tpu_torch.train.recipes import _dl_args, resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="egovlp_tpu_torch NLQ/MQ feature extractor")
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--checkpoint", "-k", default=None,
                    help="torch .pth/.pt/.bin")
    ap.add_argument("--subsample", choices=("video", "text"), default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--split", default="val")
    ap.add_argument("--token_level", action="store_true",
                    help="text mode: save token-level features")
    ap.add_argument("--save_format", choices=("npy", "pt"), default="npy")
    ap.add_argument("--override", "-o", action="append", default=[],
                    metavar="dotted.path=value",
                    help="arbitrary config override (JSON-parsed value)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logger = setup_logging()
    config = load_config(args.config)
    parse_overrides(config, args.override)
    device = resolve_device(args.device)
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"--checkpoint {args.checkpoint}: not found")
        config.override("arch.args.load_checkpoint", args.checkpoint)
    arch = config["arch"]
    model, _ = build.build_model(arch, device)
    build.load_pretrained(build.init_params(model), arch, logger)

    dl_args = _dl_args(config)
    if args.subsample:
        dl_args["subsample"] = args.subsample
    dataset = build.build_dataset(dl_args, args.split)
    vp = dl_args.get("video_params", {})
    mode = dataset.cfg.subsample  # MQ's dataset is video only
    if mode == "text":
        tokenizer = build.build_tokenizer(
            config,
            int(config.get_path("arch.args.text_params.max_length", 30)))
        if tokenizer is None:
            raise SystemExit("text features need the config's "
                             "arch.args.text_params.vocab")
        extract_text_features(model, dataset, tokenizer, args.out,
                              token_level=args.token_level,
                              save_format=args.save_format)
    else:
        extract_video_features(
            model, dataset, args.out,
            num_frames=int(vp.get("num_frames", 4)),
            input_res=int(vp.get("input_res", 224)),
            save_format=args.save_format)
    logger.info("wrote %d %s features to %s", len(dataset), mode, args.out)
    return args.out


if __name__ == "__main__":
    main()
