"""Embedding service CLI.

    python -m egovlp_tpu_torch.cli.serve --config configs/eval/egomcq.json \
        [--checkpoint egovlp.pth] [--host 127.0.0.1] [--port 8000] \
        [--device cuda]

``--checkpoint`` takes a torch pickle (``.pth``/``.pt``/``.bin``); an Orbax
directory from the JAX package must first be exported with
``python -m egovlp_tpu.cli.convert export_torch``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from egovlp_tpu_torch import build
from egovlp_tpu_torch.io.config import load_config
from egovlp_tpu_torch.serving import Embedder, serve
from egovlp_tpu_torch.train.recipes import _dl_args


def main(argv=None):
    ap = argparse.ArgumentParser(description="egovlp_tpu_torch embedding service")
    ap.add_argument("--config", "-c", required=True)
    ap.add_argument("--checkpoint", "-k", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    logger = logging.getLogger("egovlp_tpu_torch.serve")

    config = load_config(args.config)
    arch = config["arch"]
    if args.checkpoint:
        if not os.path.exists(args.checkpoint):
            raise SystemExit(f"--checkpoint {args.checkpoint}: not found")
        config.override("arch.args.load_checkpoint", args.checkpoint)
    model, _ = build.build_model(arch, device)
    build.load_pretrained(build.init_params(model), arch, logger)
    tokenizer = build.build_tokenizer(
        config, int(config.get_path("arch.args.text_params.max_length", 30)))
    if tokenizer is None:
        raise SystemExit("serving requires a vocab.txt "
                         "(arch.args.text_params.vocab)")
    vp = _dl_args(config).get("video_params", {})
    emb = Embedder(model, tokenizer, num_frames=int(vp.get("num_frames", 4)),
                   input_res=int(vp.get("input_res", 224)))
    logger.info("serving on %s:%d (%s)", args.host, args.port, device)
    serve(emb, args.host, args.port)


if __name__ == "__main__":
    main()
