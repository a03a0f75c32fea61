"""Host ms a frame spent waiting in its host syncs in the measured
window: the summed `sync` spans of the program's frame records
(`multivolumes_tpu_torch.utils.timing.host_read`)."""
from mvbench import spans


def read(ctx):
    return spans.sync_wait_ms(ctx)
