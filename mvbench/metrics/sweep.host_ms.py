"""The sweep pass's host ms per traced frame (`render_frame`'s marks)."""
from mvbench import readers


def read(ctx):
    return readers.pass_ms(ctx, "sweep", "host_ms")
