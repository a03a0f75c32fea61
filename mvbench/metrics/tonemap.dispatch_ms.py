"""The tonemap pass's host ms a frame in the measured window, from the
program's own span of the pass (`multivolumes_tpu_torch.utils.timing`),
the profiler off."""
from mvbench import spans


def read(ctx):
    return spans.pass_ms(ctx, "tonemap")
