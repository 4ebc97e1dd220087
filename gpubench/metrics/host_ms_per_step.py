"""The host's time in one call of the step function, the mean over the
window's calls (the benchmark's timer around each call)."""

import statistics


def read(ctx):
    ms = ctx["window"]["host_ms"]
    return statistics.fmean(ms) if ms else None
