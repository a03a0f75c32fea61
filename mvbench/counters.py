"""What the readers of the program's frame counters share
(`metrics/mesh.raster_msamples.py`, `mesh.shade_mpx.py`,
`taa.reproj_mpx.py`).

The program sums host numbers into each frame's record
(`multivolumes_tpu_torch.utils.timing.add`, `FrameRecord.counters`):
work a pass launches, worked out on the host from the config, with no
device read. A reader takes the measured window's records
(`spans.window_records`) and gives the counter's mean per frame, a frame
without it counting 0, or None where a window frame has no record or no
record has the counter (a program without counters, or a cell that does
not run the pass).
"""

from __future__ import annotations

from mvbench import spans


def mean(ctx, name: str):
    """Counter `name`'s mean per window frame."""
    recs = spans.window_records(ctx)
    if recs is None:
        return None
    per = [getattr(r, "counters", {}).get(name) for r in recs]
    if all(v is None for v in per):
        return None
    return sum(v or 0 for v in per) / len(per)
