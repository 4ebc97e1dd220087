"""K1 and K2 (space and time attention, forward and backward) against
their roofline: the sum of each traced launch's least time at the cell's
shape (``roofline.attention_bound_ms``) over the sum of their device
time, in %."""

from gpubench import roofline

KINDS = ("space_fwd", "space_bwd", "time_fwd", "time_bwd")


def read(ctx):
    s = ctx["shape"]
    by_kind = ctx["trace"]["by_kind"]
    bound = sum(by_kind[k][0] * roofline.attention_bound_ms(
        k, s["clips"], s["frames"], s["patches"], s["dim"]) / 1e3
        for k in KINDS)
    spent = sum(by_kind[k][1] for k in KINDS)
    return 100.0 * bound / spent if spent else None
