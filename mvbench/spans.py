"""What the readers of the program's frame spans share
(`metrics/<pass>.dispatch_ms.py`, `frame.host_syncs.py`,
`frame.sync_wait_ms.py`).

The program records every `render_frame` call on the host clock
(`multivolumes_tpu_torch.utils.timing.SPANS`), keyed by the state's
frame index, which equals the frame loop's `Frame.index`: a `pass` span
between each two of the frame's marks, a `sync` span around each place
the frame makes the host wait for the device. A reader takes the records
of the measured window's frames (the profiled sub-window comes after
it, so none of them ran under the profiler) and gives the mean per
frame, or None where a window frame has no record (a program without the
recorder, or a frame the recorder no longer keeps: a mean over part of
the window would not say so) or no record has such a span (a pass the
cell does not run).
"""

from __future__ import annotations


def window_records(ctx):
    """The program's frame records of the window's frames, or None unless
    every frame of a non-empty window has one."""
    from multivolumes_tpu_torch.utils import timing

    spans = getattr(timing, "SPANS", None)
    if spans is None or not ctx.window:
        return None
    recs = [spans.frames.get(f.index) for f in ctx.window]
    return None if None in recs else recs


def pass_ms(ctx, name: str):
    """Host ms a frame from pass `name`'s mark to the next."""
    recs = window_records(ctx)
    if recs is None:
        return None
    per = [r.ms("pass").get(name) for r in recs]
    if all(v is None for v in per):
        return None
    return sum(v or 0.0 for v in per) / len(per)


def syncs(ctx):
    """Host syncs a frame: the frame's `sync` spans."""
    recs = window_records(ctx)
    if recs is None:
        return None
    return sum(r.count("sync") for r in recs) / len(recs)


def sync_wait_ms(ctx):
    """Host ms a frame inside its host syncs."""
    recs = window_records(ctx)
    if recs is None:
        return None
    return sum(sum(r.ms("sync").values()) for r in recs) / len(recs)
