"""The host ms a traced step the epoch loop waits in ``prefetch.wait``
(the port's span around ``device_prefetch``'s hand-over of the next
batch)."""

from gpubench import spans


def read(ctx):
    return spans.host_ms_per_step("prefetch.wait")
