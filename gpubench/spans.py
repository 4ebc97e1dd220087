"""The port's spans of the traced steps, for the readers in
``gpubench/metrics``.

The traced steps run as one epoch of the port's loop under the profiler,
and the port records its spans (``egovlp_tpu_torch.io.logging.span``) only
while a profiler session is open, so the last ``loop.epoch`` recorded is
the traced one.  ``traced_epoch`` takes it and the spans that began inside
it, on any thread (the feed's copies run on its own); each reader divides
by the epoch's ``loop.step`` spans.  Where the program records no spans
(a port without ``io.logging.spans``) or no epoch, every function here
gives None.
"""

from __future__ import annotations


def traced_epoch():
    """``(the spans that began inside the last loop.epoch, its steps)``, or
    None."""
    try:
        from egovlp_tpu_torch.io import logging as port_logging
    except ImportError:
        return None
    read = getattr(port_logging, "spans", None)
    if read is None:
        return None
    records = read()
    epochs = [s for s in records if s["name"] == "loop.epoch"]
    if not epochs:
        return None
    epoch = epochs[-1]
    inside = [s for s in records if s["id"] > epoch["id"]
              and s["start_ns"] <= epoch["end_ns"]]
    steps = sum(s["name"] == "loop.step" for s in inside)
    return (inside, steps) if steps else None


def named(inside: list, name: str) -> list:
    """The spans called ``name``, in the order they began."""
    return sorted((s for s in inside if s["name"] == name),
                  key=lambda s: s["start_ns"])


def device_ms_per_step(name: str):
    """The device ms a step in the spans called ``name``."""
    got = traced_epoch()
    if got is None:
        return None
    inside, steps = got
    timed = [s["device_ms"] for s in named(inside, name)
             if s["device_ms"] is not None]
    return sum(b - a for a, b in timed) / steps if timed else None


def host_ms_per_step(name: str):
    """The host ms a step in the spans called ``name``."""
    got = traced_epoch()
    if got is None:
        return None
    inside, steps = got
    spans = named(inside, name)
    return (sum(s["end_ns"] - s["start_ns"] for s in spans) / 1e6 / steps
            if spans else None)


def between_ms_per_step():
    """The device ms a step from each step's ``step.optimizer`` end event
    to the next step's ``step.forward`` start event."""
    got = traced_epoch()
    if got is None:
        return None
    inside, steps = got
    fwd, opt = named(inside, "step.forward"), named(inside, "step.optimizer")
    if len(fwd) != len(opt) or len(fwd) < 2 or any(
            s["device_ms"] is None for s in fwd + opt):
        return None
    return sum(f["device_ms"][0] - o["device_ms"][1]
               for o, f in zip(opt[:-1], fwd[1:])) / steps


def copy_rate_gbps():
    """The bytes of the epoch's ``prefetch.copy`` spans (each span's
    ``bytes``, what it added to the ``prefetch.bytes`` counter) over their
    device seconds, in GB/s."""
    got = traced_epoch()
    if got is None:
        return None
    copies = [s for s in named(got[0], "prefetch.copy")
              if s["device_ms"] is not None and "bytes" in s["args"]]
    ms = sum(s["device_ms"][1] - s["device_ms"][0] for s in copies)
    nbytes = sum(s["args"]["bytes"] for s in copies)
    return nbytes / (ms / 1e3) / 1e9 if ms > 0 and nbytes else None
