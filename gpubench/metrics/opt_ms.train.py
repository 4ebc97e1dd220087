"""The device ms a traced step spends in ``step.optimizer`` (the port's
span around the optimizer's step), from its CUDA events."""

from gpubench import spans


def read(ctx):
    return spans.device_ms_per_step("step.optimizer")
