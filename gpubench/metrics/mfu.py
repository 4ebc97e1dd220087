"""The whole step's share of the H100's dense bf16 peak: the model FLOPs
of a step (``roofline.step_flops``, recompute not counted) times the
window's steps, over the window's seconds and 989 TFLOP/s, in %."""

from gpubench import roofline


def read(ctx):
    w = ctx["window"]
    if not w["steps"]:
        return None
    flops = roofline.step_flops(ctx["shape"]) * w["steps"]
    return 100.0 * flops / w["seconds"] / roofline.PEAK_BF16_FLOPS
