"""The median time from one step call's return to the next call: the
epoch loop's wait on ``device_prefetch`` for the next batch and its own
work between steps."""

import statistics


def read(ctx):
    ms = ctx["window"]["gap_ms"]
    return statistics.median(ms) if ms else None
