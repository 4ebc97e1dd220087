"""Faults planted under the port's timed path, for the readings that set
the limits of ``correct`` and for the tests that see them fail.  Each is a
context manager factory taking the cell's run:

* ``frozen``: a step that returns its state unchanged (AdamW's step does
  nothing);
* ``half_batch``: half of every batch left out (each key's first half of
  rows kept, negatives too), so the loss is the mean over the rest;
* ``altered_row``: one answer altered where it is produced (the first
  clip's video embedding negated as the model returns it).
"""

import contextlib


@contextlib.contextmanager
def frozen(run):
    from egovlp_tpu_torch.train.state import AdamW

    saved = AdamW.step
    AdamW.step = lambda self, closure=None: None
    try:
        yield
    finally:
        AdamW.step = saved


@contextlib.contextmanager
def half_batch(run):
    from egovlp_tpu_torch.train import recipes

    saved = recipes.device_prefetch

    def halved(iterator, device, depth=2):
        inner = saved(iterator, device, depth)
        try:
            for batch in inner:
                yield {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        finally:
            inner.close()

    recipes.device_prefetch = halved
    try:
        yield
    finally:
        recipes.device_prefetch = saved


@contextlib.contextmanager
def altered_row(run):
    import torch

    from egovlp_tpu_torch.models.dual_encoder import DualEncoder

    saved = DualEncoder.encode_video

    def altered(self, *args, **kw):
        v = saved(self, *args, **kw)
        return torch.cat([-v[:1], v[1:]])

    DualEncoder.encode_video = altered
    try:
        yield
    finally:
        DualEncoder.encode_video = saved


FAULTS = {"frozen": frozen, "half_batch": half_batch,
          "altered_row": altered_row}
