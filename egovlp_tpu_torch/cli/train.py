"""Training CLI.

    python -m egovlp_tpu_torch.cli.train --config configs/pt/egoclip.json \
        [--lr 3e-5] [--bs 16] [--resume PATH] [-o trainer.epochs=2 ...] \
        [--device cuda] [--multihost [--backend gloo]]

    torchrun --nproc_per_node=N -m egovlp_tpu_torch.cli.train \
        -c configs/pt/egoclip.json --multihost
    torchrun --nproc_per_node=N -m egovlp_tpu_torch.cli.train \
        -c configs/pt/egoclip_vitl_tp.json --multihost

Counterpart of ``egovlp_tpu/cli/train.py``: ``cuda`` by default (it
raises when no CUDA device is present unless ``--device cpu`` is given).
``--multihost`` joins the process group of torchrun's environment
(``core.dist.init_distributed``: NCCL on ``cuda``, gloo on ``cpu``)
before anything else, and the run trains one process per GPU with the
global-batch EgoNCE, on the (data, model) mesh of the config's ``mesh``
(``configs/pt/egoclip_vitl_tp.json``: model 2 with sequence parallelism);
without it the run is one process on one device.  ``--backend gloo``
names gloo for CUDA tensors: ranks that share one GPU (NCCL refuses two
ranks on one device; start each with ``LOCAL_RANK=0``).  ``--bs`` is the
batch size a GPU (a data replica of ``model`` GPUs takes ``model`` times
it).
"""

from __future__ import annotations

import argparse
import json

import torch.distributed as dist

from egovlp_tpu_torch.core.dist import init_distributed
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
    ap.add_argument("--multihost", action="store_true",
                    help="join torchrun's process group before running")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend (default: NCCL on "
                         "cuda, gloo on cpu)")
    args = ap.parse_args(argv)

    if args.multihost:
        init_distributed(args.device, backend=args.backend)
    config = load_config(args.config)
    if args.lr is not None:
        config.override("optimizer.args.lr", args.lr)
    if args.bs is not None:
        config.override("data_loader.args.batch_size", args.bs)
    parse_overrides(config, args.override)
    out = run_task(config, resume=args.resume, device=args.device)
    if args.multihost:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
