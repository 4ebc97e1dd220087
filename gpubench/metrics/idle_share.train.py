"""The share of the traced steps' span in which no kernel, copy or set
ran on the device, in %."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] else None
