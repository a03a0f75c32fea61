"""On the card: every host sync of the program's frame is one of its
`sync` spans (`multivolumes_tpu_torch.utils.timing.host_read`), so
`frame.host_syncs` counts them all. Each cell's frames run through the
benchmark's frame loop with PyTorch's sync debug mode on inside
`render`: with the `host_read` sites exempt no sync may be seen, and
without the exemption the syncs seen in each frame are its sync spans.
Skips without a card.

    python -m pytest mvbench/tests/test_host_syncs_card.py -q
"""

import threading
import warnings

import pytest
import torch

from mvbench import harness
from mvbench.loop import FrameLoop
from mvbench.spec import Spec

FRAMES = 20
SYNC_WARNING = "called a synchronizing CUDA operation"
CELLS = ["all64.orbit", "all16.orbit", "all16.orbit.nomesh",
         "all64.orbit.d1"]


class SyncWatch:
    """Turns the sync debug mode on around each `engine.render` and keeps,
    per frame, the syncs PyTorch reports from the rendering thread."""

    def __init__(self, engine):
        self.engine, self.render = engine, engine.render
        self.frames = []
        engine.render = self

    def __call__(self, *args, **kwargs):
        seen = []
        main = threading.current_thread()

        def show(message, category, filename, lineno, file=None,
                 line=None):
            # one sync each (the mode's own notice that it is a prototype
            # is not one)
            if (threading.current_thread() is main
                    and SYNC_WARNING in str(message)):
                seen.append(f"{filename}:{lineno}: {message}")

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = self.render(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        self.frames.append(seen)
        return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_every_host_sync_is_a_sync_span(card, cell, monkeypatch):
    from multivolumes_tpu_torch.core.camera import Camera
    from multivolumes_tpu_torch.utils import timing

    spec = Spec()
    w = spec.workload(cell)
    config, traffic = spec.config(w["config"]), spec.traffic(w["traffic"])
    engine, _dens, _mesh = harness.setup(config, traffic, 2 ** 31 + 11,
                                         card)
    loop = FrameLoop(engine, traffic, 0.25, Camera)
    try:
        loop.run(frames=harness.warmup_frames(traffic, config))
        torch.cuda.synchronize()
        watch = SyncWatch(engine)

        # the host_read sites exempt: nothing else may sync
        real = timing.host_read

        def exempt(site, fn):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return real(site, fn)
            finally:
                torch.cuda.set_sync_debug_mode("warn")

        monkeypatch.setattr(timing, "host_read", exempt)
        loop.run(frames=FRAMES)
        stray = [s for f in watch.frames for s in f]
        assert not stray, stray[:10]
        monkeypatch.setattr(timing, "host_read", real)

        # not exempt: the syncs of each frame are its sync spans
        watch.frames.clear()
        first = loop.frame
        loop.run(frames=FRAMES)
        counts = [(len(seen), timing.SPANS.frames[first + i].count("sync"))
                  for i, seen in enumerate(watch.frames)]
        assert len(counts) == FRAMES
        assert all(a == b for a, b in counts), counts
        print(f"{cell}: {counts[0][1]} host syncs a frame, each one seen")
    finally:
        loop.close()
