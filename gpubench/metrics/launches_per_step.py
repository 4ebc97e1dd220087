"""Kernels a step in the traced steps."""


def read(ctx):
    t = ctx["trace"]
    return t["kernels"] / t["steps"] if t["kernels"] else None
