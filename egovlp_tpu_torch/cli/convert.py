"""Checkpoint summary CLI.

    python -m egovlp_tpu_torch.cli.convert inspect -k pretrained/egovlp.pth

Counterpart of ``inspect`` in ``egovlp_tpu/cli/convert.py`` (:31-87): one
line a tensor (name, shape, dtype), then the tensor and parameter counts
and the trainer's metadata (``epoch``, ``monitor_best``, the type of a
``config`` entry), for a torch pickle (raw, or its tensors under
``state_dict``).  The pickle is read with ``torch.load(weights_only=
True)``, which refuses objects other than tensors and plain containers.
An Orbax directory, and the ``import_torch`` / ``export_torch`` modes,
need jax: they raise, naming ``python -m egovlp_tpu.cli.convert``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

JAX_CONVERT = "python -m egovlp_tpu.cli.convert"


def inspect_checkpoint(path: str, print_fn=print) -> dict:
    """Print the summary of the torch pickle ``path``; returns ``{name:
    (shape, dtype)}``."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint?): reading Orbax "
            f"needs jax; inspect it with `{JAX_CONVERT} inspect -k {path}` "
            f"or export it to a .pth with `{JAX_CONVERT} export_torch`")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        for k in ("epoch", "monitor_best", "config"):
            if k in obj:
                meta[k] = obj[k] if k != "config" else type(obj[k]).__name__
        obj = obj["state_dict"]
    tensors = {k: v for k, v in obj.items() if hasattr(v, "shape")}
    summary = {}
    total = 0
    for name in sorted(tensors):
        shape = tuple(tensors[name].shape)
        total += int(np.prod(shape)) if shape else 1
        summary[name] = (shape, str(tensors[name].dtype))
        print_fn(f"{name:<72s} {str(shape):<20s} {summary[name][1]}")
    print_fn(f"-- {len(summary)} tensors, {total / 1e6:.2f}M params"
             + (f", meta={meta}" if meta else ""))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="egovlp_tpu_torch checkpoint summary")
    ap.add_argument("mode", choices=("import_torch", "export_torch",
                                     "inspect"))
    ap.add_argument("--checkpoint", "-k", required=True)
    args, _ = ap.parse_known_args(argv)
    if args.mode != "inspect":
        raise SystemExit(
            f"{args.mode} converts between torch and Orbax checkpoints and "
            f"needs jax: run `{JAX_CONVERT} {args.mode}`")
    return inspect_checkpoint(args.checkpoint)


if __name__ == "__main__":
    main()
