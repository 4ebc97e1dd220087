"""The feed's copy rate in the traced steps: the bytes ``device_prefetch``
copied (its ``prefetch.copy`` spans' ``bytes``, the ``prefetch.bytes``
counter's growth) over those spans' device time (their CUDA events on the
copy stream, which take in the host's pinning), in GB/s."""

from gpubench import spans


def read(ctx):
    return spans.copy_rate_gbps()
