"""Embedding service CLI.

    python -m egovlp_tpu_torch.cli.serve --config configs/eval/egomcq.json \
        [--checkpoint egovlp.pth] [--host 127.0.0.1] [--port 8000] \
        [--device cuda]

AOT mode (``torch.export`` artifacts, ``egovlp_tpu_torch/io/export.py``):

    # export text and video programs for buckets 1, 4, 16 and exit
    ... --config c.json [--checkpoint k] --export-aot embedder.zip
    # serve from the artifact, the checkpoint's weights as its input
    ... --config c.json [--checkpoint k] --aot embedder.zip

An artifact runs on the device type it was exported on.  ``--checkpoint``
takes a torch pickle (``.pth``/``.pt``/``.bin``); an Orbax directory from
the JAX package must first be exported with ``python -m
egovlp_tpu.cli.convert export_torch``.
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
    ap.add_argument("--export-aot", default=None, metavar="PATH",
                    help="export a torch.export artifact and exit")
    ap.add_argument("--aot", default=None, metavar="PATH",
                    help="serve from a previously exported artifact")
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
    num_frames = int(vp.get("num_frames", 4))
    input_res = int(vp.get("input_res", 224))
    if args.export_aot:
        from egovlp_tpu_torch.io.export import export_embedder

        manifest = export_embedder(model, args.export_aot,
                                   num_frames=num_frames, input_res=input_res,
                                   max_length=tokenizer.max_length)
        logger.info("exported %s: buckets=%s device=%s", args.export_aot,
                    manifest["buckets"], manifest["device"])
        return
    if args.aot:
        from egovlp_tpu_torch.io.export import ExportedEmbedder

        emb = ExportedEmbedder(args.aot, model.state_dict(), tokenizer,
                               device=device)
        logger.info("serving AOT artifact %s (buckets=%s)", args.aot,
                    emb.buckets)
    else:
        emb = Embedder(model, tokenizer, num_frames=num_frames,
                       input_res=input_res)
    logger.info("serving on %s:%d (%s)", args.host, args.port, device)
    serve(emb, args.host, args.port)


if __name__ == "__main__":
    main()
