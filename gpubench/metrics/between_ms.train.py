"""The device ms a traced step from one step's ``step.optimizer`` end
event to the next step's ``step.forward`` start event: how long the
device waits on the epoch loop between steps."""

from gpubench import spans


def read(ctx):
    return spans.between_ms_per_step()
