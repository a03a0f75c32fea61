"""The mesh pass's device ms per traced frame (`render_frame`'s marks)."""
from mvbench import readers


def read(ctx):
    return readers.pass_ms(ctx, "mesh", "device_ms")
