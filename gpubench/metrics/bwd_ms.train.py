"""The device ms a traced step spends in ``step.backward`` (the port's
span around ``loss.backward()``; GradCache's loss gradient and pass 2),
from its CUDA events."""

from gpubench import spans


def read(ctx):
    return spans.device_ms_per_step("step.backward")
