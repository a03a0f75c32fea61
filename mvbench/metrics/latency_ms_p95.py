"""The 95th percentile over all frames delivered in the window of the
delivery stamp less the host time the frame's camera was taken."""
from mvbench import readers


def read(ctx):
    return readers.latency_ms(ctx, 95.0)
