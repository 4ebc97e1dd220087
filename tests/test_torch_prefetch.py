"""The port's ``data.pipeline.device_prefetch`` against JAX's, and the
training epoch function that runs every loader through it.

On the CPU the prefetch thread copies with ``torch.as_tensor``: the same
thread, queue, depth, shutdown and error paths as on CUDA, where it copies
from pinned memory on a stream of its own.  The CUDA case carries the
``cuda`` marker and skips where no CUDA device is present; this file
imports jax only inside the tests that compare with the JAX package, so on
a machine without jax the CUDA case runs as

    python -m pytest --noconftest -m cuda tests/test_torch_prefetch.py

Every comparison here is exact: the prefetch copies, it computes nothing.
"""

import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

from egovlp_tpu_torch.data.pipeline import device_prefetch
from egovlp_tpu_torch.train.recipes import (
    make_train_epoch_fn,
    step_generator,
    to_device,
)

N_BATCHES = 5


def numpy_batches(n=N_BATCHES, seed=0):
    """Seeded collated batches: frames, ids, a float vector, the Loader's
    ``_index``, a list of strings and a numpy scalar."""
    rng = np.random.default_rng(seed)
    return [{"frames": rng.integers(0, 256, (2, 4, 8, 8, 3)).astype(np.uint8),
             "text_ids": rng.integers(0, 100, (2, 6)).astype(np.int32),
             "noun_vec": rng.normal(size=(2, 5)).astype(np.float32),
             "_index": np.arange(2 * i, 2 * i + 2, dtype=np.int64),
             "narration": [f"clip {2 * i}", f"clip {2 * i + 1}"],
             "scale": np.float32(i),
             "ready": rng.normal(size=(2, 3)).astype(np.float32)}
            for i in range(n)]


def prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device_prefetch"]


def test_matches_jax_device_prefetch():
    """Count, order and values against JAX's ``device_prefetch`` on a
    one-device CPU mesh; a value already on the device passes through
    uncopied; the payload is what ``to_device`` gives, dtype for dtype."""
    import jax

    from egovlp_tpu.core.mesh import MeshSpec, create_mesh
    from egovlp_tpu.data.pipeline import device_prefetch as jax_device_prefetch

    batches = numpy_batches()
    mesh = create_mesh(MeshSpec(), jax.devices()[:1])
    want = list(jax_device_prefetch(
        ({**b, "ready": jax.device_put(b["ready"])} for b in batches), mesh))
    ours = [{**b, "ready": torch.from_numpy(b["ready"])} for b in batches]
    got = list(device_prefetch(iter(ours), "cpu"))
    assert len(got) == len(want) == N_BATCHES
    for b, g, w, src in zip(batches, got, want, ours):
        # JAX keeps arrays only; the port keeps numpy scalars too, as its
        # steps' numeric_batch does
        assert set(w) == {"frames", "text_ids", "noun_vec", "ready"}
        assert set(g) == set(w) | {"scale"}
        for k in w:
            assert g[k].dtype == torch.as_tensor(b[k]).dtype, k
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), k)
        assert g["ready"] is src["ready"]
        inline = to_device(src, "cpu")
        assert set(inline) == set(g)
        for k in g:
            assert g[k].dtype == inline[k].dtype and torch.equal(
                g[k], inline[k]), k


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_bounds_the_lead(depth):
    """The source is never more than ``depth`` + 1 batches ahead of the
    batches the consumer holds, and the thread does fill its ``depth``."""
    pulled, leads, n = [0], [], 8

    def source():
        for b in numpy_batches(n):
            pulled[0] += 1
            yield b

    for taken, _ in enumerate(device_prefetch(source(), "cpu", depth=depth),
                              start=1):
        want = min(depth, n - taken)
        deadline = time.monotonic() + 10.0
        while pulled[0] - taken < want and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(0.02)  # room to overrun, if it would
        leads.append(pulled[0] - taken)
    assert len(leads) == n
    assert max(leads) <= depth + 1
    assert leads[0] >= depth, leads


@pytest.mark.parametrize("end", ["max_samples", "step_raises", "epoch_end",
                                 "shorter_loader"])
def test_no_thread_outlives_the_epoch(end):
    """A ``max_samples`` break, a step that raises, the end of the epoch
    and the end of the shorter of two loaders each leave no prefetch
    thread alive, and each loader's epoch generator closed."""
    before = prefetch_threads()
    closed = []

    class Loader:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def epoch(self, epoch):
            try:
                yield from numpy_batches(self.n)
            finally:
                closed.append(self.n)

    def step(model, optimizer, batch, gen):
        if end == "step_raises" and len(calls) == 2:
            raise KeyError("step 2")
        calls.append(batch["frames"].shape[0])
        return torch.tensor(1.0)

    calls = []
    loaders = ([Loader(6), Loader(3)] if end == "shorter_loader"
               else [Loader(6)])
    fn = make_train_epoch_fn(loaders, step, "cpu",
                             max_samples=4 if end == "max_samples" else 0)
    if end == "step_raises":
        with pytest.raises(KeyError, match="step 2"):
            fn(None, None, 1, logging.getLogger("test"))
    else:
        fn(None, None, 1, logging.getLogger("test"))
    assert calls == {"max_samples": [2, 2], "step_raises": [2, 2],
                     "epoch_end": [2] * 6, "shorter_loader": [2] * 6}[end]
    assert prefetch_threads() == before
    assert sorted(closed) == sorted(l.n for l in loaders)


@pytest.mark.parametrize("where", ["source", "copy"])
def test_error_reaches_the_consumer_at_its_batch(where):
    """An exception in the source or in the copy of batch k comes out
    after k batches, the very exception; the thread is gone after it."""
    k, boom = 3, ValueError("batch 3 is corrupt")

    def source():
        for i, b in enumerate(numpy_batches()):
            if i == k:
                if where == "source":
                    raise boom
                b = {**b, "frames": np.array([object()], dtype=object)}
            yield b

    before = prefetch_threads()
    got = []
    with pytest.raises((ValueError, TypeError)) as err:
        for batch in device_prefetch(source(), "cpu"):
            got.append(batch)
    assert len(got) == k
    if where == "source":
        assert err.value is boom
    else:
        assert isinstance(err.value, TypeError)
    assert prefetch_threads() == before


def test_epoch_losses_equal_the_inline_loop():
    """The EgoClip step through ``make_train_epoch_fn`` (prefetched) and
    through an in-line ``to_device`` loop from the same weights, batches
    and step generators: bit-equal losses and weights."""
    from tests.test_torch_models import port_model, random_params
    from tests.test_torch_train import SCHED, egoclip_batch
    from egovlp_tpu_torch.train import steps as port_steps
    from egovlp_tpu_torch.train.state import make_optimizer

    params = random_params()
    batches = [egoclip_batch(400 + i) for i in range(3)]
    step = port_steps.make_egoclip_train_step(input_res=32)
    seed, epoch = 7, 2

    model = port_model(params)
    opt, _ = make_optimizer(model, **SCHED)
    prefetched = []

    def recorded(m, o, batch, gen):
        assert all(isinstance(v, torch.Tensor) for v in batch.values())
        prefetched.append(step(m, o, batch, gen))
        return prefetched[-1]

    make_train_epoch_fn([batches], recorded, "cpu", seed=seed)(
        model, opt, epoch, logging.getLogger("test"))

    ref = port_model(params)
    ref_opt, _ = make_optimizer(ref, **SCHED)
    inline = [step(ref, ref_opt, to_device(b, "cpu"),
                   step_generator("cpu", seed, epoch, i))
              for i, b in enumerate(batches)]
    assert len(prefetched) == len(inline) == 3
    for a, b in zip(prefetched, inline):
        assert torch.equal(a, b), (a, b)
    for (k, v), w in zip(model.state_dict().items(),
                         ref.state_dict().values()):
        assert torch.equal(v, w), k


def htod_and_kernel_streams(prof, path):
    """The CUDA streams of a profile's host-to-device copies, each copy's
    kind, and the streams of its kernels, read from its Chrome trace."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    htod = [e for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    kernels = {e["args"]["stream"] for e in events if e.get("cat") == "kernel"}
    return ({e["args"]["stream"] for e in htod}, [e["name"] for e in htod],
            kernels)


@pytest.mark.cuda
def test_cuda_copies_from_pinned_memory_on_its_own_stream(tmp_path):
    """On the card: the tensors land on the device equal to ``to_device``'s,
    a value already there passes through, and the trace holds one copy an
    array, each from pinned memory on another stream than the consumer's
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", torch.cuda.current_device())
    batches = [{**b, "ready": torch.from_numpy(b["ready"]).to(device)}
               for b in numpy_batches()]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a trace can miss the first activities after it starts
        torch.ones(1, device=device).add_(1).item()
        time.sleep(0.05)
        got = []
        for batch in device_prefetch(iter(batches), device):
            got.append({k: v * 1 for k, v in batch.items()})  # a kernel each
        torch.cuda.synchronize()
    copies, kinds, kernels = htod_and_kernel_streams(
        prof, tmp_path / "trace.json")
    # frames, text_ids, noun_vec and scale a batch; "ready" passes through
    assert len(kinds) == 4 * len(batches), kinds
    assert set(kinds) == {"Memcpy HtoD (Pinned -> Device)"}, kinds
    assert copies and kernels and not copies & kernels, (copies, kernels)
    for b, g in zip(batches, got):
        want = to_device(b, device)
        assert set(g) == set(want)
        for k in g:
            assert g[k].device == device and g[k].dtype == want[k].dtype
            assert torch.equal(g[k], want[k]), k
    passed = next(device_prefetch(iter(batches[:1]), device))
    assert passed["ready"] is batches[0]["ready"]


SLEEP_CYCLES = 100_000_000  # torch.cuda._sleep: ~50 ms on an H100


def equal_sized_batches(n, seed):
    """``n`` seeded batches of numpy arrays alone, every batch the same
    shapes (so the caching allocator hands one batch's blocks to the
    next)."""
    rng = np.random.default_rng(seed)
    return [{"frames": rng.integers(0, 256, (4, 4, 64, 64, 3)).astype(np.uint8),
             "noun_vec": rng.normal(size=(4, 300)).astype(np.float32)}
            for _ in range(n)]


def poison_copy_stream(device, batch):
    """The device's copy stream (made by a first prefetch), with its pool
    holding freed blocks of ``batch``'s sizes filled with 0x5a bytes: a
    read of a batch's memory before its copy lands sees them."""
    from egovlp_tpu_torch.data import pipeline

    list(device_prefetch(iter(equal_sized_batches(1, seed=99)), device))
    stream = pipeline._COPY_STREAMS[device]
    with torch.cuda.stream(stream):
        junk = [torch.full((v.nbytes,), 0x5a, dtype=torch.uint8,
                           device=device) for v in batch.values()]
    torch.cuda.synchronize()
    del junk
    return stream


@pytest.mark.cuda
def test_cuda_consumer_waits_for_a_late_copy():
    """The consumer's stream waits on each batch's event: with the copy
    stream held back (``torch.cuda._sleep`` queued on it before the first
    copy), every tensor read at once on the consumer's stream is the
    batch, not what its memory held before the copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    batches = equal_sized_batches(4, seed=11)
    stream = poison_copy_stream(device, batches[0])
    with torch.cuda.stream(stream):
        torch.cuda._sleep(4 * SLEEP_CYCLES)
    got = [{k: v.clone() for k, v in batch.items()}
           for batch in device_prefetch(iter(batches), device)]
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for b, g in zip(batches, got):
        for k, v in b.items():
            assert torch.equal(g[k].cpu(), torch.from_numpy(v)), k


@pytest.mark.cuda
def test_cuda_batch_memory_outlives_the_step_that_reads_it():
    """A batch the consumer drops while its stream has still to read it
    keeps its memory (``record_stream``): the batches copied meanwhile, on
    the idle copy stream, do not land in it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    batches = equal_sized_batches(8, seed=12)
    poison_copy_stream(device, batches[0])
    got = []
    for batch in device_prefetch(iter(batches), device, depth=2):
        torch.cuda._sleep(SLEEP_CYCLES)  # the step is still running
        got.append({k: v.clone() for k, v in batch.items()})  # its read
        del batch  # dropped before the read has run
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for i, (b, g) in enumerate(zip(batches, got)):
        for k, v in b.items():
            assert torch.equal(g[k].cpu(), torch.from_numpy(v)), (i, k)
