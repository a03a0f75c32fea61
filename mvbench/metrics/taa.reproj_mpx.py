"""Millions of pixels the TAA history reprojection covers a frame in the
measured window: the program's counter `taa.reproj_px`, the window
around the mesh where the far preset allows it, else the screen."""
from mvbench import counters


def read(ctx):
    v = counters.mean(ctx, "taa.reproj_px")
    return None if v is None else v / 1e6
