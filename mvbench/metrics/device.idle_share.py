"""The share (%) of a frame's time in which no operation ran on the
card: one less the device's busy time per frame, taken from the traced
frames, over the measured window's seconds per delivered frame. The
frame time comes from the untraced window because the profiler about
doubles the host's time a frame (the traced window's own idle share,
`device.window_s` against `device.busy_s`, reads that much higher);
the device's busy time is what the trace alone can give."""
from mvbench import readers


def read(ctx):
    if ctx.trace is None:
        return None
    fps = readers.fps(ctx)
    if fps <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace_frames * fps)
