"""K3 (LayerNorm, forward and backward) against its roofline: the least
time of every K3 launch of the traced steps (``roofline.ln_launches`` of
the cell's shape: the rows of each launch) over their device time, in %.
Only where the trace holds every K3 launch and the port's launch counter
counted as many as the shapes give; else nothing."""

from gpubench import roofline


def read(ctx):
    t, steps = ctx["trace"], ctx["trace"]["steps"]
    launches = roofline.ln_launches(ctx["shape"])
    for direction in ("fwd", "bwd"):
        want = steps * sum(d == direction for d, _, _ in launches)
        if not (t["by_kind"][f"ln_{direction}"][0] == want
                == ctx["counted"][f"layer_norm_{direction}"]):
            return None
    spent = t["by_kind"]["ln_fwd"][1] + t["by_kind"]["ln_bwd"][1]
    bound = steps * sum(roofline.ln_bound_ms(d, rows, D) / 1e3
                        for d, rows, D in launches)
    return 100.0 * bound / spent if spent else None
