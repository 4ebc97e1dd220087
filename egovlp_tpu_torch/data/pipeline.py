"""Host input pipeline: sharded sampling, threaded decode, static batches.

Counterpart of ``egovlp_tpu/data/pipeline.py`` (:47-345, :377), the role
of the reference's torch DataLoader + DistributedSampler stack:

  * per-process sharding by a (shard, num_shards) pair: each process
    decodes only its slice of the global batch (the DistributedSampler
    contract);
  * a thread pool (or, with ``num_procs``, a pool of spawned processes)
    decodes items, with a bounded in-order prefetch window;
  * collation stacks fixed-shape numpy batches and tokenizes text with a
    static ``max_length``.

The frames stay ``[B, T, pre, pre, 3]`` uint8 (the port's step takes that
layout); the JAX package's channel fold and its mesh prefetch are TPU
layout and mesh code, not ported.  The epoch function copies each batch
to the device (``train/recipes.py``).
"""

from __future__ import annotations

import multiprocessing
import queue
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from egovlp_tpu_torch.data.text import WordPieceTokenizer

# ---- process-worker state (num_procs > 0): each spawned worker builds its
# dataset once from the pickled parent copy; items are fetched by index with
# the same (seed, epoch, item) rng as the threaded path, so thread- and
# process-based loading produce IDENTICAL batches (tested).
_WORKER_DATASET = None


def _proc_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _proc_fetch(args):
    seed, epoch, item_idx = args
    rng = Loader.item_rng(seed, epoch, item_idx)
    return _WORKER_DATASET.get(int(item_idx), rng)


def shard_indices(n: int, *, epoch: int, shuffle: bool, seed: int,
                  shard: int, num_shards: int,
                  drop_last: bool = True) -> np.ndarray:
    """Deterministic per-epoch index shard (DistributedSampler semantics:
    shuffle by seed+epoch, pad/trim to equal shards)."""
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed + epoch).permutation(n)
    if drop_last:
        per = n // num_shards
        idx = idx[: per * num_shards]
    else:
        per = -(-n // num_shards)
        pad = per * num_shards - n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
    return idx[shard::num_shards]


# string fields that are metadata (file paths etc.), NOT captions: collate
# keeps them as python lists and never tokenizes / ships them to the device
META_STR_KEYS = frozenset({"path", "video_uid", "narration_id"})


def collate(items: List[Dict[str, Any]],
            tokenizer: Optional[WordPieceTokenizer] = None
            ) -> Dict[str, Any]:
    """Stack numpy fields; tokenize str fields to {key}_ids/{key}_mask
    (except META_STR_KEYS)."""
    out: Dict[str, Any] = {}
    keys = items[0].keys()
    for k in keys:
        v0 = items[0][k]
        vals = [it[k] for it in items]
        if isinstance(v0, str):
            out[k] = vals
            if tokenizer is not None and k not in META_STR_KEYS:
                ids, mask = tokenizer(vals)
                out[f"{k}_ids"] = ids
                out[f"{k}_mask"] = mask
        elif isinstance(v0, np.ndarray) or np.isscalar(v0):
            out[k] = np.stack([np.asarray(v) for v in vals])
        elif isinstance(v0, (list, tuple)) and v0 and isinstance(v0[0], str):
            out[k] = vals  # list of str-lists (e.g. MCQ text options)
            if tokenizer is not None:
                flat = [s for v in vals for s in v]
                ids, mask = tokenizer(flat)
                n = len(v0)
                out[f"{k}_ids"] = ids.reshape(len(vals), n, -1)
                out[f"{k}_mask"] = mask.reshape(len(vals), n, -1)
        elif isinstance(v0, dict):
            out[k] = vals
        else:
            out[k] = np.asarray(vals)
    return out


class Loader:
    """Threaded prefetching loader over a TextVideoDataset."""

    def __init__(self, dataset, batch_size: int,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 shuffle: Optional[bool] = None, seed: int = 0,
                 num_workers: int = 8, prefetch_batches: int = 4,
                 drop_last: bool = True, shard: int = 0, num_shards: int = 1,
                 max_samples_per_epoch: Optional[int] = None,
                 item_timeout: Optional[float] = None,
                 num_procs: int = 0,
                 validation_split: "float | int" = 0.0,
                 subset: Optional[np.ndarray] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.shuffle = (dataset.cfg.split == "train") if shuffle is None else shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch_batches = prefetch_batches
        self.drop_last = drop_last
        self.shard = shard
        self.num_shards = num_shards
        self.max_samples_per_epoch = max_samples_per_epoch
        self.item_timeout = item_timeout
        # num_procs > 0 decodes in SPAWNED worker processes (the reference's
        # torch-DataLoader model, base_data_loader.py) instead of threads —
        # for hosts where the GIL-holding parts (numpy, samplers, metadata)
        # cap thread scaling.  Spawn, not fork: the parent holds a CUDA
        # context and threads that must not be inherited; a spawned worker
        # imports only the dataset's modules and never touches CUDA.
        self.num_procs = num_procs
        self._pool = None  # ThreadPoolExecutor or ProcessPoolExecutor
        # workers lost to timed-out (possibly hung-forever) items since the
        # pool was created; when most of the pool is gone it is recycled at
        # the next epoch boundary instead of silently starving
        self._abandoned = 0

        # random train/val split of ONE dataset (the reference
        # BaseDataLoader's validation_split sampler,
        # base_data_loader.py:29-54): a fixed seed-0 permutation assigns
        # the first `len_valid` indices to validation, the rest to this
        # loader; `split_validation()` returns the val-side Loader.
        self._valid_subset = None
        self.subset = subset
        if validation_split:
            if subset is not None:
                raise ValueError("validation_split and subset are exclusive")
            n = len(dataset)
            len_valid = (int(validation_split) if validation_split >= 1
                         else int(n * validation_split))
            if not 0 < len_valid < n:
                raise ValueError(
                    f"validation_split {validation_split} gives {len_valid} "
                    f"of {n} samples")
            idx_full = np.random.RandomState(0).permutation(n)
            self._valid_subset = idx_full[:len_valid]
            self.subset = idx_full[len_valid:]

    def split_validation(self, batch_size: Optional[int] = None,
                         shuffle: bool = True) -> "Loader":
        """The validation-side Loader of a ``validation_split`` loader
        (reference base_data_loader.py:56-62; SubsetRandomSampler => the
        val side shuffles per epoch too unless ``shuffle=False``)."""
        if self._valid_subset is None:
            raise ValueError("loader was built without validation_split")
        return Loader(
            self.dataset, batch_size or self.batch_size,
            tokenizer=self.tokenizer, shuffle=shuffle, seed=self.seed,
            num_workers=self.num_workers, drop_last=False,
            shard=self.shard, num_shards=self.num_shards,
            item_timeout=self.item_timeout, num_procs=self.num_procs,
            subset=self._valid_subset,
        )

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._abandoned = 0

    @staticmethod
    def item_rng(seed: int, epoch: int, item_idx: int) -> np.random.Generator:
        """Per-item decode rng — a function of (seed, epoch, item) ONLY, so
        an item's content is identical no matter which shard/process decodes
        it (the property the multi-host equivalence tests rely on)."""
        return np.random.default_rng(
            (seed * 1_000_003 + epoch * 131 + item_idx) & 0x7FFFFFFF
        )

    def __len__(self):
        n = len(self.subset) if self.subset is not None else len(self.dataset)
        if self.max_samples_per_epoch:
            # an epoch can be SHORTER (truncate) or LONGER (cycle, the
            # reference's inf_loop epoch stretching, utils/util.py) than
            # the dataset
            n = self.max_samples_per_epoch
        per_shard = n // self.num_shards if self.drop_last else -(-n // self.num_shards)
        return per_shard // self.batch_size if self.drop_last else -(-per_shard // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        n = len(self.subset) if self.subset is not None else len(self.dataset)
        idx = shard_indices(n, epoch=epoch, shuffle=self.shuffle,
                            seed=self.seed, shard=self.shard,
                            num_shards=self.num_shards,
                            drop_last=self.drop_last)
        if self.subset is not None:
            idx = np.asarray(self.subset)[idx]
        if self.max_samples_per_epoch:
            target = self.max_samples_per_epoch // self.num_shards
            if 0 < len(idx) < target:
                # max_samples_per_epoch beyond the dataset size cycles the
                # epoch's order (the reference wraps its loader in
                # utils/util.py::inf_loop and bounds the epoch by
                # max_samples_per_epoch alone, trainer_egoclip.py:104-105)
                idx = np.concatenate([idx] * (-(-target // len(idx))))
            idx = idx[:target]
        batches = [
            idx[i:i + self.batch_size]
            for i in range(0, len(idx) - self.batch_size + 1, self.batch_size)
        ] if self.drop_last else [
            idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)
        ]

        def fetch_item(args):
            i, item_idx = args
            rng = self.item_rng(self.seed, epoch, int(item_idx))
            return self.dataset.get(int(item_idx), rng)

        n_workers = self.num_procs if self.num_procs > 0 else self.num_workers
        if self._pool is not None and self._abandoned >= max(1, n_workers // 2):
            # most workers are stuck on hung decodes — recycle the pool so
            # the lax straggler policy cannot starve itself (the abandoned
            # threads/processes drain or leak in the background; a fresh
            # pool restores full decode concurrency)
            self.close()
        if self._pool is None:
            # persistent across epochs: straggler workers from a previous
            # epoch drain in the background instead of stalling epoch end
            if self.num_procs > 0:
                self._pool = ProcessPoolExecutor(
                    self.num_procs,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_proc_init,
                    initargs=(self.dataset,),
                )
            else:
                self._pool = ThreadPoolExecutor(self.num_workers)
        pool = self._pool
        window: "queue.Queue" = queue.Queue()
        it = iter(batches)

        def submit_next():
            try:
                b = next(it)
            except StopIteration:
                return False
            if self.num_procs > 0:
                futs = [(bi, pool.submit(_proc_fetch,
                                         (self.seed, epoch, int(bi))))
                        for bi in b]
            else:
                futs = [(bi, pool.submit(fetch_item, (j, bi)))
                        for j, bi in enumerate(b)]
            window.put(futs)
            return True

        for _ in range(self.prefetch_batches):
            if not submit_next():
                break
        while not window.empty():
            futs = window.get()
            submit_next()
            items = [self._item_result(i, f) for i, f in futs]
            ok = [x for x in items if x is not None]
            if not ok:
                raise TimeoutError(
                    f"all {len(items)} items of a batch timed out after "
                    f"{self.item_timeout}s each"
                )
            # lax policy: a straggler/corrupt item is replaced by a healthy
            # neighbour from the same batch (same role as the reference's
            # black-frame substitute, base_dataset.py:109-115, but keeps
            # valid pixel statistics for contrastive batches)
            items = [x if x is not None else ok[0] for x in items]
            batch = collate(items, self.tokenizer)
            # global dataset index of each row: the distributed-eval gather
            # (core/dist_eval.py) uses it to drop shard-pad duplicates and
            # restore dataset order across processes
            batch["_index"] = np.asarray([i for i, _ in futs], np.int64)
            yield batch

    def _item_result(self, item_idx, fut):
        """Future result with the straggler policy: under loading='lax' a
        decode that exceeds ``item_timeout`` (or raises) yields None for
        neighbour substitution; 'strict' re-raises.  The abandoned thread
        finishes in the background (threads are not cancellable) — the
        persistent pool simply schedules around it."""
        from concurrent.futures.process import BrokenProcessPool

        lax = getattr(self.dataset, "cfg", None) is not None and \
            getattr(self.dataset.cfg, "loading", "strict") == "lax"
        try:
            return fut.result(timeout=self.item_timeout)
        except FutureTimeoutError:
            self._abandoned += 1
            if not lax:
                raise TimeoutError(
                    f"decode of item {item_idx} exceeded "
                    f"{self.item_timeout}s (loading='strict')"
                ) from None
            return None
        except BrokenProcessPool:
            # a worker PROCESS died (segfault in a native decode) — the
            # whole pool is dead, so item substitution cannot help; discard
            # it (recreated fresh on the next epoch() call) and surface a
            # clear diagnosis instead of a cascade of bogus timeouts
            self.close()
            raise RuntimeError(
                f"decode worker process died while fetching item {item_idx} "
                "(BrokenProcessPool); the pool was discarded and will be "
                "recreated next epoch — if this repeats, hunt for a video "
                "that crashes the native decoder"
            ) from None
        except Exception:
            if not lax:
                raise
            return None


class MultiLoader:
    """Round-robin over several Loaders (the reference trainers zip their
    data_loader list, base/base_data_loader.py:134-150): each epoch yields
    tuples with one batch per loader, length = min over loaders."""

    def __init__(self, loaders):
        self.loaders = list(loaders)

    def __len__(self):
        return min(len(l) for l in self.loaders)

    @property
    def batch_size(self):
        return sum(l.batch_size for l in self.loaders)

    def epoch(self, epoch: int = 0):
        return zip(*(l.epoch(epoch) for l in self.loaders))
