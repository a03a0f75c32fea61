"""The end-to-end arithmetic on synthetic stamps."""

import pytest

from mvbench.harness import Context
from mvbench.loop import Frame
from mvbench.spec import Spec


def frames(intervals, latency):
    """Frames taken at the given intervals (s), each delivered `latency`
    s after its camera; `latency` may be a list."""
    out, t = [], 100.0
    lats = latency if isinstance(latency, list) else [latency] * len(
        intervals)
    for i, (dt, lat) in enumerate(zip(intervals, lats)):
        out.append(Frame(i, t, 0.01, t + lat))
        t += dt
    return out


def read(name, ctx):
    return Spec().reader(name).read(ctx)


def test_steady_frames():
    ctx = Context(window=frames([0.05] * 200, 0.08), seconds=10.0)
    # cameras at 0, 0.05, ...; the last delivered in time is taken at 9.9
    assert read("fps", ctx) == pytest.approx(199 / 10.0)
    assert read("latency_ms_p95", ctx) == pytest.approx(80.0)
    assert read("frame.dispatch_ms", ctx) == pytest.approx(10.0)


def test_a_stall_moves_both():
    """Every tenth frame held 0.2 s: fewer frames fit the window, and the
    frames in flight behind each stall wait for it."""
    steady = frames([0.05] * 200, 0.08)
    intervals, lat = [0.05] * 200, [0.08] * 200
    for s in range(9, 200, 10):
        intervals[s] += 0.2
        for i in range(s - 2, s + 1):
            lat[i] += 0.2
    stalled = frames(intervals, lat)
    a = Context(window=steady, seconds=10.0)
    b = Context(window=stalled, seconds=10.0)
    assert read("fps", b) < read("fps", a) - 2.0
    assert read("latency_ms_p95", b) == pytest.approx(280.0)
    assert read("latency_ms_p95", a) == pytest.approx(80.0)


def test_frames_delivered_after_the_window_do_not_count():
    ctx = Context(window=frames([0.1] * 10, 0.5), seconds=0.95)
    # cameras at 0, 0.1, ... 0.9; delivered at 0.5 .. 1.4: five in time
    assert read("fps", ctx) == pytest.approx(5 / 0.95)
    assert read("latency_ms_p95", ctx) == pytest.approx(500.0)


def test_setup_and_device_readers():
    # 31.25 ms busy a traced frame; the window delivers 8 frames a second
    ctx = Context(setup_s=12.5, trace={"busy_s": 0.25, "window_s": 1.0,
                                       "kernels": 400, "passes": {}},
                  trace_frames=8, window=frames([0.125] * 80, 0.1),
                  seconds=10.0)
    assert read("setup_s", ctx) == 12.5
    assert read("fps", ctx) == pytest.approx(8.0)
    assert read("device.idle_share", ctx) == pytest.approx(75.0)
    assert read("device.kernels_per_frame", ctx) == pytest.approx(50.0)
    assert read("mesh.host_ms", ctx) is None
