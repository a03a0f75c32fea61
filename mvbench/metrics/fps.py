"""Frames delivered in the window over the window's seconds."""
from mvbench import readers


def read(ctx):
    return readers.fps(ctx)
