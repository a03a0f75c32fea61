"""The frame's span recorder (`utils/timing.py`: `SPANS`, `span`,
`host_read`) on the CPU: one record a `render_frame` call with its
passes, steps and host syncs nested; the `span:` ranges it opens only
while a profiler records; `tools/trace_ops.py`'s attribution of kernels
and idle gaps to the innermost span; and the benchmark's readers of the
records (`mvbench/metrics/<pass>.dispatch_ms.py`, `frame.host_syncs.py`,
`frame.sync_wait_ms.py`) on synthetic records. That no host sync escapes
`host_read` on the card is `mvbench/tests/test_host_syncs_card.py`."""

import collections
import json

import pytest
import torch
from torch_parity import one_torch_thread, write_test_mesh  # noqa: F401

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.parallel import sharding as psh
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.scene import state as pstate
from multivolumes_tpu_torch.tools import trace_ops
from multivolumes_tpu_torch.utils import timing

CPU = torch.device("cpu")
# four volumes in three LOD buckets, so the sweep has three bucket spans
TINY = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                    max_ray_samples=16, max_light_samples=8, num_volumes=4,
                    num_volume_srcs=2, cube_map_size=16, shadow_map_size=64,
                    lod_bucket_caps=(1, 2, 1 << 30))
PASSES = ["prep", "mesh", "light", "sweep", "sky", "composite", "tail",
          "taa", "tonemap"]
STEPS = {"mesh.operands": 1, "mesh.raster": 1, "mesh.shade": 1,
         "light.update": 1, "light.store": 1, "sweep.partition": 1,
         "sweep.bucket": 3, "composite.prep": 1, "composite.kernel": 1}
# the main path's host syncs, as the card sees them (the mesh shown)
SYNCS = {"math3d.inverse": 3, "cull.viewport": 1, "cull.corners": 1,
         "cull.edges": 2, "cull.face_loops": 1, "mesh.shadow_up": 1,
         "math3d.look_at": 1, "mesh.shadow_proj": 3, "composite.corners": 1}


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    eng = MultiRayCaster(TINY, device=CPU)
    eng.set_mesh(write_test_mesh(tmp_path_factory.mktemp("mesh")
                                 / "torus.obj", 500))
    eng.select_raster_preset((0.0, 6.0, 60.0))
    return eng


def camera(f=0):
    return pcam.orbit_camera(f / 60.0, TINY.aspect_ratio, device=CPU)


def render(eng, f=0, **kw):
    """One frame through `render_frame` -> its record."""
    index = eng.state.frame_idx
    out = pframe.render_frame(eng.state, camera(f), eng.config, **kw)
    eng.state = out.state
    return timing.SPANS.frames[index]


def named(rec):
    """Each span as (name, kind, the name of its parent or None)."""
    return [(s[0], s[1], rec.spans[s[2]][0] if s[2] >= 0 else None)
            for s in rec.spans]


def test_one_frame_is_one_record_of_nested_spans(engine):
    marks = []
    index = engine.state.frame_idx
    rec = render(engine, timer=marks.append)
    assert rec.index == index and timing.SPANS.last() is rec
    assert marks == PASSES + [None]             # timer= as before
    frame, spans = rec.spans[0], named(rec)
    assert spans[0] == ("frame", "frame", None)
    assert [n for n, k, _p in spans if k == "pass"] == PASSES
    assert all(p == "frame" for _n, k, p in spans if k == "pass")
    steps = [(n, p) for n, k, p in spans if k == "step"]
    assert collections.Counter(n for n, _p in steps) == STEPS
    assert all(n.split(".")[0] == p for n, p in steps)
    for s in rec.spans[1:]:
        parent = rec.spans[s[2]]
        assert parent[3] <= s[3] <= s[4] <= parent[4], (s[0], parent[0])
    assert frame[3] < frame[4]
    # the passes tile the frame but for its few lines around them
    assert sum(rec.ms("pass").values()) <= (frame[4] - frame[3]) / 1e6
    own = rec.self_ms("pass")
    assert set(own) == set(PASSES)
    assert all(0.0 <= own[p] <= ms for p, ms in rec.ms("pass").items())


def test_host_read_gives_the_frames_syncs(engine):
    for f in range(2):
        rec = render(engine, f)
        syncs = [(n, p) for n, k, p in named(rec) if k == "sync"]
        assert syncs.count(("composite.corners", "composite.prep")) == 1
        assert collections.Counter(n for n, _p in syncs) == SYNCS
        assert rec.count("sync") == sum(SYNCS.values())
        assert sum(rec.ms("sync").values()) > 0.0
    # outside a frame: the call's value, and nothing recorded
    before = dict(timing.SPANS.frames)
    assert timing.host_read("x.y", lambda: 7) == 7
    with timing.span("x.z"):
        pass
    assert timing.SPANS.frames == before and timing.SPANS.current is None


def test_an_unbaked_light_axis_is_a_host_read():
    """A config whose sweep axis the engine did not bake reads the light
    position from the device in the light pass."""
    state = pstate.create_scene(TINY, device=CPU)
    index = state.frame_idx
    pframe.render_frame(state, camera(), TINY)
    syncs = [(n, p) for n, k, p in named(timing.SPANS.frames[index])
             if k == "sync"]
    assert syncs.count(("light.axis", "light")) == 1


def test_the_nomesh_frame_has_no_mesh_spans(engine):
    rec = render(engine, show_mesh=False)
    assert [n for n, k, _p in named(rec) if k == "pass"] == [
        p for p in PASSES if p != "mesh"]
    assert not [n for n, _k, _p in named(rec) if n.startswith("mesh.")]
    assert rec.count("sync") == sum(SYNCS.values()) - 5    # the shadow's


def test_profiler_trace_holds_the_span_ranges_nested(engine, tmp_path):
    with timing.profile_trace(tmp_path):
        rec = render(engine)
    with open(tmp_path / timing.TRACE_FILE) as f:
        spans = trace_ops.Spans(json.load(f)["traceEvents"])
    got = [(name, spans.ranges[parent][2] if parent >= 0 else None)
           for _t0, _t1, name, parent, _pass in spans.ranges]
    assert got == [(n, p) for n, _k, p in named(rec)]
    passes = [r for r in spans.ranges if r[3] == 0]
    assert [r[2] for r in passes] == PASSES
    assert all(r[4] == r[2] for r in passes)


def test_the_harness_pass_ranges_nest_with_the_span_ranges(engine,
                                                           monkeypatch):
    """The benchmark's `pass:` ranges, which `timer=` opens at the marks,
    and the recorder's `span:` ranges open and close as one stack, each
    pass's `span:` range inside its `pass:` range."""
    from mvbench import trace as trace_lib

    log = []
    real = torch.autograd.profiler.record_function

    class Logged(real):
        def __enter__(self):
            log.append(self.name)
            return super().__enter__()

        def __exit__(self, *exc):
            log.append("/" + self.name)
            return super().__exit__(*exc)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Logged)
    monkeypatch.setattr(torch.profiler, "record_function", Logged)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        render(engine, timer=trace_lib.range_marker(trace_lib.PASS_PREFIX))
    stack = []
    for name in log:
        if name.startswith("/"):
            assert stack.pop() == name[1:]
        else:
            stack.append(name)
    assert not stack
    assert [n for n in log if n.startswith(trace_lib.PASS_PREFIX)] == [
        trace_lib.PASS_PREFIX + p for p in PASSES]
    for p in PASSES:
        i = log.index(trace_lib.PASS_PREFIX + p)
        assert log[i + 1] == timing.SPAN_PREFIX + p


def test_no_record_function_without_a_profiler(engine, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting)
    render(engine)
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        rec = render(engine)
    assert opened == [timing.SPAN_PREFIX + s[0] for s in rec.spans]


def test_the_sharded_step_records_its_passes():
    cfg = TINY.with_(light_axis=2)
    mesh = psh.make_mesh([CPU] * 2)
    state = psh.shard_state(pstate.create_scene(cfg, device=CPU), mesh)
    index = state.frame_idx
    marks = []
    pframe.render_frame(state, camera(), cfg, mesh=mesh, timer=marks.append)
    rec = timing.SPANS.frames[index]
    assert [n for n, k, _p in named(rec) if k == "pass"] == [
        p for p in PASSES if p != "mesh"]
    assert marks[:-1] == [p for p in PASSES if p != "mesh"]


def test_profile_frame_gives_the_recorded_pass_times(engine):
    index = engine.state.frame_idx
    passes = timing.profile_frame(engine.state, camera(), engine.config,
                                  iters=1)
    assert passes == timing.SPANS.frames[index].ms("pass")
    assert list(passes) == PASSES


def test_the_app_stats_line_shows_the_frame_spans(tmp_path, capsys):
    from multivolumes_tpu_torch import app

    app.main(["--warp", "--width", "96", "--height", "64", "--gridSize",
              "16", "--lightGridSize", "8", "--maxRaySamples", "16",
              "--maxLightSamples", "8", "--numVolumes", "4", "--frames", "1",
              "--stats", "--out", str(tmp_path / "f.png")])
    line = capsys.readouterr().out.splitlines()[0]
    rec = timing.SPANS.last()
    assert "| host ms prep " in line and "tonemap" in line
    assert f"| {rec.count('sync')} host syncs, " in line
    assert app.host_stats(rec) in line


def test_recorder_keeps_the_newest_frames():
    rec = timing.SpanRecorder(keep=3)
    for i in (0, 1, 2, 1, 3):
        with rec.frame(i):
            rec.mark("prep")
            rec.mark(None)
    assert list(rec.frames) == [2, 1, 3] and rec.last().index == 3
    def fail():
        raise RuntimeError("mid-frame")

    with pytest.raises(RuntimeError):
        with rec.frame(4):
            rec.mark("prep")
            rec.host_read("prep.a", fail)
    bad = rec.frames[4]
    assert rec.current is None and all(s[4] >= s[3] > 0 for s in bad.spans)


def test_trace_ops_puts_kernels_and_gaps_in_the_innermost_span():
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": args}

    span = timing.SPAN_PREFIX
    events = [
        x(span + "frame", "user_annotation", 0.0, 400.0),
        x(span + "light", "user_annotation", 0.0, 100.0),
        x(span + "light.update", "user_annotation", 10.0, 50.0),
        x(span + "sweep", "user_annotation", 100.0, 300.0),
        x(span + "sweep.partition", "user_annotation", 100.0, 20.0),
        x(span + "sweep.bucket_mip", "user_annotation", 105.0, 10.0),
        x(span + "sweep.bucket", "user_annotation", 120.0, 80.0),
        x("cudaLaunchKernelExC", "cuda_runtime", 20.0, 5.0, correlation=1),
        x("cudaLaunchKernel", "cuda_runtime", 130.0, 5.0, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", 250.0, 5.0, correlation=3),
        x("self_scan_kernel", "kernel", 40.0, 65.0, correlation=1),
        x("sweep_kernel", "kernel", 150.0, 100.0, correlation=2),
        x("fill_kernel", "kernel", 300.0, 20.0, correlation=3),
    ]
    r = trace_ops.attribute({"traceEvents": events}, frames=1)
    assert r["spans"]["light.update"]["device_ms"] == pytest.approx(0.065)
    assert r["spans"]["sweep.bucket"]["device_ms"] == pytest.approx(0.1)
    assert r["spans"]["sweep"]["device_ms"] == pytest.approx(0.02)
    assert r["passes"]["sweep"]["device_ms"] == pytest.approx(0.12)
    assert r["passes"]["light"]["host_ms"] == pytest.approx(0.1)
    # idle: [0, 40) from light, [105, 150) from the sync inside the
    # partition, [250, 300) and [320, 400) from sweep; not counted after
    # the frame
    assert r["idle_ms"] == pytest.approx(0.215)
    assert r["spans"]["light"]["idle_ms"] == pytest.approx(0.04)
    assert r["spans"]["sweep.bucket_mip"]["idle_ms"] == pytest.approx(0.045)
    assert r["spans"]["sweep"]["idle_ms"] == pytest.approx(0.13)
    assert r["passes"]["sweep"]["idle_ms"] == pytest.approx(0.175)
    assert "frame" not in r["passes"] and r["unattributed_ms"] == 0.0


# ---- the benchmark's readers, on synthetic records ----------------------

MS = 1_000_000


def _record(index, prep_ms, sync_ms, syncs, mesh=True):
    """A frame record: prep, then mesh (when `mesh`), each 10 ms a
    frame, `syncs` sync spans of `sync_ms` each inside prep."""
    rec = timing.FrameRecord(index)
    t = 0
    rec.spans.append(["frame", "frame", -1, 0, 0])
    rec.spans.append(["prep", "pass", 0, t, t + prep_ms * MS])
    for k in range(syncs):
        rec.spans.append(["cull.corners", "sync", 1, t + k * sync_ms * MS,
                          t + (k + 1) * sync_ms * MS])
    t += prep_ms * MS
    if mesh:
        rec.spans.append(["mesh", "pass", 0, t, t + 10 * MS])
        t += 10 * MS
    rec.spans[0][4] = t
    return rec


@pytest.fixture
def records(monkeypatch):
    rec = timing.SpanRecorder()
    for i, (prep, wait, n) in enumerate([(1, 0.1, 1), (2, 0.2, 2),
                                         (4, 0.5, 3), (8, 1.0, 4)]):
        rec.frames[10 + i] = _record(10 + i, prep, wait, n)
    rec.frames[20] = _record(20, 3, 0.5, 1, mesh=False)
    monkeypatch.setattr(timing, "SPANS", rec)
    return rec


def _ctx(indices):
    from mvbench.harness import Context
    from mvbench.loop import Frame

    return Context(window=[Frame(i, 0.0, 0.01, 0.02) for i in indices],
                   seconds=1.0, trace=None)


READERS = {"prep.dispatch_ms": 3.0, "mesh.dispatch_ms": 10.0,
           "frame.host_syncs": 2.5, "frame.sync_wait_ms": 0.95}
OTHERS = ["light", "sweep", "sky", "composite", "tail", "taa", "tonemap"]


@pytest.mark.parametrize("name", list(READERS) + [f"{p}.dispatch_ms"
                                                  for p in OTHERS])
def test_span_readers_average_the_window_frames(name, records):
    from mvbench.spec import Spec

    reader = Spec().reader(name)
    # frames 11 and 12 were recorded; 10 and 13 are outside the window
    got = reader.read(_ctx([11, 12]))
    if name in READERS:
        assert got == pytest.approx(READERS[name])
    else:
        assert got is None                  # no frame ran the pass
    assert reader.read(_ctx([98, 99])) is None
    assert reader.read(_ctx([])) is None
    if name == "mesh.dispatch_ms":
        assert reader.read(_ctx([20])) is None
        assert reader.read(_ctx([13, 20])) == pytest.approx(5.0)


@pytest.mark.parametrize("name", list(READERS))
def test_span_readers_refuse_a_window_with_a_frame_missing(name, records):
    """A window frame with no record (one the recorder no longer keeps)
    gives no reading, not the mean of the other frames."""
    from mvbench.spec import Spec

    reader = Spec().reader(name)
    assert reader.read(_ctx([11, 12])) is not None
    for window in ([11, 12, 99], [99, 11], [11, 99, 12]):
        assert reader.read(_ctx(window)) is None


def test_span_readers_find_nothing_in_a_program_without_spans(
        monkeypatch):
    from mvbench.spec import Spec

    monkeypatch.delattr(timing, "SPANS")
    for name in list(READERS) + ["taa.dispatch_ms"]:
        assert Spec().reader(name).read(_ctx([11])) is None
