"""Kernels launched on the card per traced frame."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    return ctx.trace["kernels"] / ctx.trace_frames
