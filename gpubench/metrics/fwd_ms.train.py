"""The device ms a traced step spends in ``step.forward`` (the port's
span from the step's entry to its loss: the inputs' transform, both
towers and the loss), from its CUDA events."""

from gpubench import spans


def read(ctx):
    return spans.device_ms_per_step("step.forward")
