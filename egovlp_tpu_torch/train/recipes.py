"""Task recipes: a config wired into loaders, the step, validation and the
Trainer.

Counterpart of ``egovlp_tpu/train/recipes.py`` for the ``egoclip``,
``epic`` and ``charades`` tasks:

* ``make_train_epoch_fn`` (:75-130): one optimizer step per loader per
  batch index (the reference zips its loaders), each loader's batches
  copied to the device by ``data.pipeline.device_prefetch`` at depth 2
  while the steps before them run (:85), per-loader DEVICE losses kept
  through the epoch (a host sync only every ``log_step`` batches and once
  for the epoch means ``loss_{i}``), and ``max_samples`` cutting the
  epoch.  Each step draws its randomness from its own ``torch.Generator``
  on the device, seeded from ``(seed, epoch, step)``.
* ``run_task`` (:133-413): the model (seeded init, then
  ``load_pretrained``), the train Loader of every ``data_loader`` entry,
  AdamW with step-LR, the task's step and validation each epoch, run
  directories, checkpoints and resume.  ``egoclip``: the EgoClip step and
  EgoMCQ validation of every entry.  ``epic``: the max-margin step (margin
  0.4 for the adaptive loss, else 0.2, unless the config sets one) and
  nDCG / mAP on the ``test`` split, dual-softmax when the config's
  ``dual_softmax`` is set.  ``charades``: the InfoNCE step and the
  157-class mAP on the ``test`` split against the config's
  ``charades_classes`` file.  ``oscc`` / ``pnr``: the video-only cross
  entropy steps and the accuracy / keyframe distance on the ``val``
  split.  It runs on
  ``cuda`` unless the caller asks for ``cpu``: one process on one device,
  or one process per GPU under ``torch.distributed`` (``core.dist``).
  There every rank builds and loads the model from the same seed and
  checkpoint, trains it wrapped in ``DistributedDataParallel`` (the
  gradient all-reduce overlaps the backward) on its shard of every loader,
  and validates the unwrapped model on its shard of the val loader.  The
  config's batch size is the process's (the reference's per-GPU
  convention): the global batch is world size times it, and an epoch is
  the per-rank loader's length.  The config's ``mesh`` (``data``,
  ``model``, ``dcn_data``, ``sequence_parallel``, ``zero``) lays the ranks
  out as a (data, model) mesh (``core/mesh.py``, :148-257): a data
  replica of ``model`` ranks takes ``batch_size * model`` rows, the same
  on each of its ranks; with ``model`` > 1 the model is tensor-parallel
  over them (``core/tp.py``), its video tower sequence-parallel instead
  when ``sequence_parallel`` is set (``core/sp.py``), ZeRO ``zero`` (1 or
  3) splits the optimizer state over the data group (``core/zero.py``,
  applied after any resume, :390-397), and the optimizer reduces the
  gradients itself in place of the DDP wrapper (``apply_mesh``).  At
  ``model`` 1 without ZeRO nothing changes: DDP over the world.
  ``mesh.sequence_parallel`` at ``model`` 1
  logs JAX's warning and trains (:158-163); ``nlq`` / ``mq`` train
  nothing and raise, naming ``cli.extract``.  Rank 0 writes the logged
  losses and every validation's metrics to the run's ``tf`` directory
  (``io/logging.MetricLogger``, :372-373); the ``epic`` and ``charades``
  validations write a ranking report when the config's
  ``visualizer.type`` is set (``io/visualizer.py``, :305-324).
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
    is_main_process,
    local_rank,
    process_shard,
)
from egovlp_tpu_torch.core.mesh import MeshSpec, create_mesh
from egovlp_tpu_torch.core.zero import apply_mesh
from egovlp_tpu_torch.data.pipeline import device_prefetch, numeric_batch
from egovlp_tpu_torch.evals.charades import (
    evaluate_charades,
    load_charades_classes,
)
from egovlp_tpu_torch.evals.egomcq import evaluate_egomcq
from egovlp_tpu_torch.evals.epic_mir import embed_dataset, evaluate_epic_mir
from egovlp_tpu_torch.evals.oscc_pnr import evaluate_oscc, evaluate_pnr
from egovlp_tpu_torch.io.config import Config
from egovlp_tpu_torch.io.logging import MetricLogger, setup_logging, span
from egovlp_tpu_torch.io.visualizer import build_visualizer
from egovlp_tpu_torch.metrics.mir import load_epic_annotations
from egovlp_tpu_torch.models.dual_encoder import sim_matrix
from egovlp_tpu_torch.train.state import make_optimizer
from egovlp_tpu_torch.train.steps import (
    make_charades_train_step,
    make_egoclip_train_step,
    make_epic_train_step,
    make_oscc_train_step,
    make_pnr_train_step,
)
from egovlp_tpu_torch.train.trainer import Trainer, TrainerConfig


def to_device(batch: dict, device: "torch.device | str"
              ) -> Dict[str, torch.Tensor]:
    """numpy arrays (and tensors) of a collated batch -> device tensors,
    copied in line on the current stream (the fixed-batch paths; the
    epoch function prefetches)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in numeric_batch(batch).items()}


def step_generator(device: "torch.device | str", seed: int, epoch: int,
                   index: int) -> torch.Generator:
    """The generator of one step, a fixed function of (seed, epoch, step)."""
    s = np.random.SeedSequence([seed, epoch, index]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def make_train_epoch_fn(loaders: Sequence[Iterable], step_fn: Callable,
                        device: "torch.device | str", max_samples: int = 0,
                        log_step: int = 100, seed: int = 0,
                        mlog: Optional[MetricLogger] = None) -> Callable:
    """``train_epoch(model, optimizer, epoch, logger) -> {'loss_{i}': ...}``.
    A loader is a ``Loader`` (its ``epoch(epoch)`` batches) or any iterable
    of collated numpy batches.  Every ``log_step`` batches the losses go to
    ``logger`` and to ``mlog`` (tag ``train/loss``, or ``train/loss_{i}``
    with several loaders, at step ``(epoch - 1) * len(loaders[0]) + i``).
    The epoch records the spans ``loop.epoch`` (args: ``epoch``) and
    ``loop.step`` around each call of ``step_fn`` (``io/logging.span``)."""
    mlog = mlog or MetricLogger(None, enabled=False)

    def train_epoch(model, optimizer, epoch, logger):
        with span("loop.epoch", args={"epoch": epoch}):
            return run_epoch(model, optimizer, epoch, logger)

    def run_epoch(model, optimizer, epoch, logger):
        t0 = time.time()
        losses = [[] for _ in loaders]
        nl, n = len(loaders), 0
        streams = [device_prefetch(l.epoch(epoch) if hasattr(l, "epoch")
                                   else l, device, depth=2)
                   for l in loaders]
        try:
            for i, batch_tuple in enumerate(zip(*streams)):
                bs = len(batch_tuple[0]["frames"])
                if max_samples and (i + 1) * bs > max_samples:
                    break
                for dl_idx, batch in enumerate(batch_tuple):
                    gen = step_generator(device, seed, epoch, i * nl + dl_idx)
                    with span("loop.step"):
                        loss = step_fn(model, optimizer, batch, gen)
                    losses[dl_idx].append(loss)
                    n += 1
                if i % log_step == 0:
                    mlog.set_step((epoch - 1) * len(loaders[0]) + i, "train")
                    for dl_idx in range(nl):
                        lv = float(losses[dl_idx][-1])
                        mlog.scalar(f"loss_{dl_idx}" if nl > 1 else "loss",
                                    lv)
                        logger.info("epoch %d step %d dl%d loss %.4f "
                                    "(%.2f s/it)", epoch, i, dl_idx, lv,
                                    (time.time() - t0) / max(n, 1))
        finally:  # stops and joins every prefetch thread
            for s in streams:
                s.close()
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


PORTED_TASKS = ("egoclip", "epic", "charades", "oscc", "pnr")
# the tasks whose step runs the video tower alone
VIDEO_ONLY_TASKS = ("oscc", "pnr")


def _visualizer(config):
    """The ranking-report writer of the config's ``visualizer`` section
    (``{trainer.save_dir}/web`` unless it names a ``web_dir``) on rank 0;
    None on the other ranks and when its ``type`` is empty."""
    if not is_main_process():
        return None
    save_dir = config.get_path("trainer.save_dir", "results")
    return build_visualizer(config, f"{save_dir}/web")


def classes_file(config, dl_args: Dict[str, Any]) -> str:
    """The Charades class list: the config's ``charades_classes``, else
    ``Charades_v1_classes.txt`` in the loader's meta (or data) dir."""
    meta = dl_args.get("meta_dir", dl_args["data_dir"])
    return config.get("charades_classes",
                      f"{meta}/Charades_v1_classes.txt")


def mesh_spec(config) -> MeshSpec:
    """The config's ``mesh`` as a ``MeshSpec``."""
    mesh = config.get("mesh") or {}
    return MeshSpec(data=int(mesh.get("data", -1)),
                    model=int(mesh.get("model", 1)),
                    dcn_data=int(mesh.get("dcn_data", 1)))


def check_ported(config) -> None:
    """Raise ``NotImplementedError`` on a task or a key the port does not
    run, and ``ValueError`` on a mesh that does not cover the world
    (``data * model * dcn_data``) or an ``n_devices`` other than the world
    size."""
    task = infer_task(config)
    if task in ("nlq", "mq"):
        raise NotImplementedError(
            f"task {task!r} trains nothing: its features come from "
            "`python -m egovlp_tpu_torch.cli.extract`")
    if task not in PORTED_TASKS:
        raise NotImplementedError(f"unknown task {task!r}")
    world = process_shard()[1]
    spec = mesh_spec(config)
    if spec.data > 0 and spec.data * spec.model * spec.dcn_data != world:
        raise ValueError(
            f"mesh.data={spec.data} but the world size is {world}: mesh "
            f"{spec.dcn_data}x{spec.data}x{spec.model} (dcn x data x model) "
            f"does not cover {world} devices; the port runs one process "
            "per GPU (torchrun --nproc_per_node=N ... --multihost)")
    spec.resolve(world)
    n = int(config.get("n_devices") or -1)
    if n != -1 and n != world:
        raise ValueError(
            f"n_devices={n} but the world size is {world}: the port runs "
            "one process per GPU (torchrun --nproc_per_node=N ... "
            "--multihost)")
    zero = (config.get("mesh") or {}).get("zero") or 0
    if zero and int(zero) not in (1, 3):
        raise ValueError(f"zero stage must be 1 or 3, got {zero!r}")


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


def data_parallel(model: torch.nn.Module, device: torch.device,
                  video_only: bool = False) -> torch.nn.Module:
    """``model`` wrapped in ``DistributedDataParallel`` when a process group
    exists (at world 1 too, as ``torchrun --nproc_per_node=1`` runs it),
    ``model`` itself otherwise.  The contrastive steps give every
    parameter a gradient, so the wrapper looks for no unused parameter.
    The video-only steps (``video_only``: OSCC, PNR) call the wrapper
    without text, so the text tower gets no gradient: the wrapper then
    searches the graph for unused parameters each step, and leaves their
    gradients ``None`` (AdamW skips them)."""
    if not in_process_group():
        return model
    return DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=video_only)


def run_task(config, resume: Optional[str] = None,
             device: "torch.device | str" = "cuda"):
    """Train (and validate) the config's task; ``resume`` is a checkpoint
    path to go on from.  Returns ``(model, optimizer)``."""
    config = config if isinstance(config, Config) else Config(config)
    logger = setup_logging()
    check_ported(config)
    mesh_cfg = config.get("mesh") or {}
    if mesh_cfg.get("sequence_parallel") and mesh_spec(config).model <= 1:
        # as JAX recipes.py:158-163: a mesh without a model axis runs on
        logger.warning(
            "mesh.sequence_parallel is set but the mesh has no model axis "
            "(model=1) — sequence parallelism is OFF; set mesh.model >= 2")
    device = resolve_device(device)
    mesh = create_mesh(mesh_spec(config))
    with mesh:
        return _run_task(config, resume, device, mesh, logger)


def _run_task(config, resume, device, mesh, logger):
    task = infer_task(config)
    rank, world = process_shard()
    logger.info("task: %s on %s (rank %d of %d; mesh data %d x model %d)",
                task, device, rank, world, mesh.data.size, mesh.model.size)
    mesh_cfg = config.get("mesh") or {}

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
    # batch_size is per chip: a data replica of `model` ranks loads
    # batch_size * model rows, the same on each of its ranks (:204-221)
    train_loaders = [build.build_loader(
        dict(a), "train", tokenizer,
        batch_size=int(a.get("batch_size", 16)) * mesh.model.size,
        max_samples_per_epoch=max_samples) for a in all_args]
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
    loss_type = loss_cfg.get("type", "EgoNCE")
    loss_args = loss_cfg.get("args", {})
    if task == "egoclip":
        step = make_egoclip_train_step(
            loss_type=loss_type, input_res=input_res,
            temperature=float(loss_args.get("temperature", 0.05)),
            noun=bool(loss_args.get("noun", True)),
            verb=bool(loss_args.get("verb", True)),
            global_sim=str(loss_args.get("global_sim", "gather")),
            n_micro=int(trainer_cfg.get("grad_accum", 1)))
        # one val loader per data_loader entry; loader 0's metrics keep
        # their names (the monitor reads them), later loaders' get a _{i}
        # suffix.  The 5 options fold into the batch, so a val batch of 8
        # items scores as 8 batches of 1 (the reference's batch size).
        val_bs = int(trainer_cfg.get("val_batch_size", 8))
        val_loaders = [build.build_loader(dict(a), "val", tokenizer,
                                          batch_size=val_bs)
                       for a in all_args]

        def valid(model, epoch, logger):
            out = {}
            for dl_idx, vl in enumerate(val_loaders):
                m = evaluate_egomcq(model, vl, input_res=input_res)
                out.update(m if dl_idx == 0 else
                           {f"{k}_{dl_idx}": v for k, v in m.items()})
            mlog.set_step(epoch, "val")
            mlog.scalars(out)
            return out
    elif task == "epic":
        step = make_epic_train_step(
            loss_type=loss_type, input_res=input_res,
            margin=float(loss_args.get(
                "margin", 0.4 if "Adaptive" in loss_type else 0.2)),
            fix_norm=bool(loss_args.get("fix_norm", True)))
        val_loaders = [build.build_loader(dl_args, "test", tokenizer)]
        annotations = dl_args.get("meta_dir") or dl_args["data_dir"]
        use_dual_softmax = bool(config.get("dual_softmax", False))
        visualizer = _visualizer(config)

        def valid(model, epoch, logger):
            t, v, _, meta = embed_dataset(model, val_loaders[0], input_res,
                                          return_meta=True)
            m = evaluate_epic_mir(t, v, *load_epic_annotations(annotations),
                                  use_dual_softmax=use_dual_softmax)
            if visualizer is not None:
                sims = sim_matrix(torch.from_numpy(t), torch.from_numpy(v))
                visualizer.visualize_ranking(sims.numpy(), epoch,
                                             meta["texts"], meta["paths"])
            mlog.set_step(epoch, "val")
            mlog.scalars(m)
            return m
    elif task in VIDEO_ONLY_TASKS:
        step = (make_oscc_train_step if task == "oscc"
                else make_pnr_train_step)(input_res=input_res)
        val_loaders = [build.build_loader(dl_args, "val", tokenizer)]
        evaluate = evaluate_oscc if task == "oscc" else evaluate_pnr

        def valid(model, epoch, logger):
            m = evaluate(model, val_loaders[0], input_res)
            mlog.set_step(epoch, "val")
            mlog.scalars(m)
            return m
    else:  # charades
        step = make_charades_train_step(
            input_res=input_res,
            temperature=float(loss_args.get("temperature", 0.05)))
        val_loaders = [build.build_loader(dl_args, "test", tokenizer)]
        classes = classes_file(config, dl_args)
        visualizer = _visualizer(config)

        def valid(model, epoch, logger):
            m = evaluate_charades(model, val_loaders[0],
                                  load_charades_classes(classes), tokenizer,
                                  input_res, visualizer=visualizer,
                                  epoch=epoch)
            mlog.set_step(epoch, "val")
            mlog.scalars(m)
            return m

    dirs = config.make_run_dirs()
    mlog = MetricLogger(str(dirs["tf"]), enabled=is_main_process())
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
                                      log_step=log_step, mlog=mlog)
    trainer = Trainer(tcfg, train_epoch, valid, logger=logger)
    if resume:
        payload = trainer.resume(model, optimizer, resume)
        logger.info("resumed from %s (epoch %d) at epoch %d", resume,
                    payload["epoch"], trainer.cfg.start_epoch)
    # the mesh's sharding, after the resume so that any checkpoint
    # re-shards onto this mesh (:390-397)
    sharded = apply_mesh(
        model, optimizer, mesh,
        sequence_parallel=bool(mesh_cfg.get("sequence_parallel")),
        zero=int(mesh_cfg.get("zero") or 0), logger=logger)
    try:
        trainer.train(model if sharded is not None else data_parallel(
            model, device, video_only=task in VIDEO_ONLY_TASKS), optimizer)
    finally:
        for l in train_loaders + val_loaders:
            l.close()
        mlog.close()
    return model, optimizer
