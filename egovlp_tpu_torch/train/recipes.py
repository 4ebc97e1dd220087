"""Task recipes: a config wired into loaders, the step, validation and the
Trainer.

Counterpart of ``egovlp_tpu/train/recipes.py`` for the ``egoclip`` task:

* ``make_train_epoch_fn`` (:75-130): one optimizer step per loader per
  batch index (the reference zips its loaders), the batches copied to the
  device, per-loader DEVICE losses kept through the epoch (a host sync
  only every ``log_step`` batches and once for the epoch means
  ``loss_{i}``), and ``max_samples`` cutting the epoch.  Each step draws
  its randomness from its own ``torch.Generator`` on the device, seeded
  from ``(seed, epoch, step)``.
* ``run_task`` (:133-413): the model (seeded init, then
  ``load_pretrained``), the EgoClip Loader of every ``data_loader`` entry,
  AdamW with step-LR, the EgoClip step, EgoMCQ validation of every entry
  each epoch, run directories, checkpoints and resume.  It runs on
  ``cuda`` unless the caller asks for ``cpu``: one process on one device,
  or one process per GPU under ``torch.distributed`` (``core.dist``).
  There every rank builds and loads the model from the same seed and
  checkpoint, trains it wrapped in ``DistributedDataParallel`` (the
  gradient all-reduce overlaps the backward) on its shard of every loader,
  and validates the unwrapped model on its shard of the val loader.  The
  config's batch size is the process's (the reference's per-GPU
  convention): the global batch is world size times it, and an epoch is
  the per-rank loader's length.  Tensor, sequence and ZeRO parallelism and
  the other tasks raise (``ROADMAP.md``, Queue A).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from egovlp_tpu_torch import build
from egovlp_tpu_torch.core.dist import (
    in_process_group,
    local_rank,
    process_shard,
)
from egovlp_tpu_torch.evals.egomcq import evaluate_egomcq
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.io.logging import setup_logging
from egovlp_tpu_torch.train.state import make_optimizer
from egovlp_tpu_torch.train.steps import make_egoclip_train_step, numeric_batch
from egovlp_tpu_torch.train.trainer import Trainer, TrainerConfig


def to_device(batch: dict, device: "torch.device | str"
              ) -> Dict[str, torch.Tensor]:
    """numpy arrays (and tensors) of a collated batch -> device tensors."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in numeric_batch(batch).items()}


def step_generator(device: "torch.device | str", seed: int, epoch: int,
                   index: int) -> torch.Generator:
    """The generator of one step, a fixed function of (seed, epoch, step)."""
    s = np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def make_train_epoch_fn(loaders: Sequence[Iterable], step_fn: Callable,
                        device: "torch.device | str", max_samples: int = 0,
                        log_step: int = 100, seed: int = 0) -> Callable:
    """``train_epoch(model, optimizer, epoch, logger) -> {'loss_{i}': ...}``.
    A loader is a ``Loader`` (its ``epoch(epoch)`` batches) or any iterable
    of collated numpy batches."""
    def train_epoch(model, optimizer, epoch, logger):
        t0 = time.time()
        losses = [[] for _ in loaders]
        nl, n = len(loaders), 0
        streams = [l.epoch(epoch) if hasattr(l, "epoch") else l
                   for l in loaders]
        for i, batch_tuple in enumerate(zip(*streams)):
            bs = len(batch_tuple[0]["frames"])
            if max_samples and (i + 1) * bs > max_samples:
                break
            for dl_idx, batch in enumerate(batch_tuple):
                gen = step_generator(device, seed, epoch, i * nl + dl_idx)
                loss = step_fn(model, optimizer, to_device(batch, device), gen)
                losses[dl_idx].append(loss)
                n += 1
            if i % log_step == 0:
                for dl_idx in range(nl):
                    logger.info("epoch %d step %d dl%d loss %.4f (%.2f s/it)",
                                epoch, i, dl_idx, float(losses[dl_idx][-1]),
                                (time.time() - t0) / max(n, 1))
        return {f"loss_{dl_idx}": float(torch.stack(ls).mean()) if ls else 0.0
                for dl_idx, ls in enumerate(losses)}

    return train_epoch


def infer_task(config) -> str:
    if "task" in config:
        return config["task"]
    name = str(config.get_path("data_loader.args.dataset_name", ""))
    return {
        "EgoClip_EgoMCQ": "egoclip",
        "MultiInstanceRetrieval": "epic",
        "CharadesEgo": "charades",
        "Ego4D_OSCC": "oscc",
        "Ego4D_PNR": "pnr",
    }.get(name, "egoclip")


def _dl_args(config) -> Dict[str, Any]:
    dl = config["data_loader"]
    if isinstance(dl, list):
        dl = dl[0]
    return dict(dl.get("args", dl))


def _all_dl_args(config):
    """All data_loader entries (the reference zips several loaders and
    steps once for each within a batch index)."""
    dl = config["data_loader"]
    if isinstance(dl, list):
        return [dict(d.get("args", d)) for d in dl]
    return [dict(dl.get("args", dl))]


def check_ported(config) -> None:
    """Raise ``NotImplementedError`` on a task or a parallelism key the
    port does not run yet, and ``ValueError`` on a data-parallel size
    (``mesh.data``, ``n_devices``) other than the world size."""
    task = infer_task(config)
    if task != "egoclip":
        raise NotImplementedError(
            f"task {task!r} is not ported yet (ROADMAP.md, Queue A, A11)")
    mesh = config.get("mesh") or {}
    if (int(mesh.get("model", 1)) > 1 or mesh.get("sequence_parallel")
            or mesh.get("zero") or int(mesh.get("dcn_data", 1)) > 1):
        raise NotImplementedError(
            f"mesh {mesh}: tensor, sequence and ZeRO parallelism are not "
            "ported (ROADMAP.md, Queue A, A13)")
    world = process_shard()[1]
    for key, n in (("mesh.data", int(mesh.get("data", -1))),
                   ("n_devices", int(config.get("n_devices") or -1))):
        if n != -1 and n != world:
            raise ValueError(
                f"{key}={n} but the world size is {world}: the port runs "
                "one process per GPU (torchrun --nproc_per_node=N ... "
                "--multihost)")
    drop_path = float(config.get_path(
        "arch.args.video_params.drop_path_rate", 0.0) or 0.0)
    if world > 1 and drop_path > 0:
        raise NotImplementedError(
            f"drop_path_rate={drop_path} in a world of {world}: drop-path "
            "masks of the global batch are not ported (ROADMAP.md, Queue "
            "A, A9)")


def resolve_device(device: "torch.device | str") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must be present.  In
    a process group ``'cuda'`` is this process's GPU, ``cuda:{LOCAL_RANK}``
    (the one ``DistributedDataParallel`` is bound to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (pass "
            "device='cpu' to run on the CPU)")
    if device.type == "cuda" and device.index is None and in_process_group():
        device = torch.device("cuda", local_rank())
    return device


def data_parallel(model: torch.nn.Module, device: torch.device
                  ) -> torch.nn.Module:
    """``model`` wrapped in ``DistributedDataParallel`` when a process group
    exists (at world 1 too, as ``torchrun --nproc_per_node=1`` runs it;
    every parameter gets a gradient in the EgoClip step, so no
    unused-parameter search), ``model`` itself otherwise."""
    if not in_process_group():
        return model
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None)


def run_task(config, resume: Optional[str] = None,
             device: "torch.device | str" = "cuda"):
    """Train (and validate) the config's task; ``resume`` is a checkpoint
    path to go on from.  Returns ``(model, optimizer)``."""
    config = config if isinstance(config, Config) else Config(config)
    logger = setup_logging()
    check_ported(config)
    device = resolve_device(device)
    task = infer_task(config)
    rank, world = process_shard()
    logger.info("task: %s on %s (rank %d of %d)", task, device, rank, world)

    arch = config["arch"]
    model, _ = build.build_model(arch, device)
    build.load_pretrained(build.init_params(model, seed=0), arch, logger)
    logger.info("model: %.1fM params",
                sum(p.numel() for p in model.parameters()) / 1e6)

    dl_args = _dl_args(config)
    if dl_args.get("validation_split"):
        # the recipe validates on the explicit val split; taking the key
        # here would silently drop the carved-out fraction from training
        raise ValueError(
            "validation_split is a Loader-level feature: build the loader "
            "yourself and use Loader(validation_split=...)"
            ".split_validation(); run_task validates on the val split")
    tok_len = int(config.get_path("arch.args.text_params.max_length", 30))
    tokenizer = build.build_tokenizer(config, tok_len)
    if tokenizer is None:
        logger.warning("no vocab.txt found; text batches stay raw strings")

    trainer_cfg = config.get("trainer", {})
    max_samples = trainer_cfg.get("max_samples_per_epoch")
    input_res = int(dl_args.get("video_params", {}).get("input_res", 224))
    all_args = _all_dl_args(config)
    train_loaders = [build.build_loader(dict(a), "train", tokenizer,
                                        max_samples_per_epoch=max_samples)
                     for a in all_args]
    steps_per_epoch = max(min(len(l) for l in train_loaders), 1)

    opt_args = config.get("optimizer", {}).get("args", {})
    optimizer, _ = make_optimizer(
        model, base_lr=float(opt_args.get("lr", 3e-5)),
        milestones=tuple(trainer_cfg.get("lr_milestones", (60, 80))),
        steps_per_epoch=steps_per_epoch,
        weight_decay=float(opt_args.get("weight_decay", 0.0)),
        mu_dtype=opt_args.get("mu_dtype"),
        variant=opt_args.get("variant", "optax"))

    loss_cfg = config.get("loss", {})
    loss_args = loss_cfg.get("args", {})
    step = make_egoclip_train_step(
        loss_type=loss_cfg.get("type", "EgoNCE"), input_res=input_res,
        temperature=float(loss_args.get("temperature", 0.05)),
        noun=bool(loss_args.get("noun", True)),
        verb=bool(loss_args.get("verb", True)),
        global_sim=str(loss_args.get("global_sim", "gather")),
        n_micro=int(trainer_cfg.get("grad_accum", 1)))

    # one val loader per data_loader entry; loader 0's metrics keep their
    # names (the monitor reads them), later loaders' get a _{i} suffix.
    # The 5 options fold into the batch, so a val batch of 8 items scores
    # as 8 batches of 1 (the reference's batch size).
    val_bs = int(trainer_cfg.get("val_batch_size", 8))
    val_loaders = [build.build_loader(dict(a), "val", tokenizer,
                                      batch_size=val_bs) for a in all_args]

    def valid(model, epoch, logger):
        out = {}
        for dl_idx, vl in enumerate(val_loaders):
            m = evaluate_egomcq(model, vl, input_res=input_res)
            out.update(m if dl_idx == 0 else
                       {f"{k}_{dl_idx}": v for k, v in m.items()})
        return out

    dirs = config.make_run_dirs()
    if trainer_cfg.get("async_save"):
        logger.info("trainer.async_save: the port writes checkpoints "
                    "synchronously")
    tcfg = TrainerConfig(
        epochs=int(trainer_cfg.get("epochs", 10)),
        save_period=int(trainer_cfg.get("save_period", 1)),
        monitor=trainer_cfg.get("monitor", "off"),
        early_stop=int(trainer_cfg.get("early_stop", 10)),
        init_val=bool(trainer_cfg.get("init_val", False)),
        save_dir=str(dirs["models"]),
    )
    log_step = int(np.sqrt(sum(l.batch_size for l in train_loaders))) or 1
    train_epoch = make_train_epoch_fn(train_loaders, step, device,
                                      max_samples=max_samples or 0,
                                      log_step=log_step)
    trainer = Trainer(tcfg, train_epoch, valid, logger=logger)
    if resume:
        payload = trainer.resume(model, optimizer, resume)
        logger.info("resumed from %s (epoch %d) at epoch %d", resume,
                    payload["epoch"], trainer.cfg.start_epoch)
    try:
        trainer.train(data_parallel(model, device), optimizer)
    finally:
        for l in train_loaders + val_loaders:
            l.close()
    return model, optimizer
