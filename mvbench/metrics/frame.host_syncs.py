"""Host syncs a frame in the measured window: the `sync` spans of the
program's frame records (`multivolumes_tpu_torch.utils.timing.host_read`),
each a place the host waits for the card."""
from mvbench import spans


def read(ctx):
    return spans.syncs(ctx)
