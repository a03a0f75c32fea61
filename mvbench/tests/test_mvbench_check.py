"""The check of `correct` at a tiny size on the CPU: the port against the
reference, the control, and the timed path broken underneath a run."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mvbench import check, harness, roofline
from mvbench.loop import FrameLoop
from mvbench.reference.precision import LOWER
from mvbench.spec import HERE

from tiny import tiny_spec

CELLS = {"mesh": "all16.orbit", "nomesh": "all16.orbit.nomesh",
         "host delivery": "all64.orbit.d1"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(CELLS.values()), ids=list(CELLS))
def test_port_matches_the_reference(tmp_path, cell):
    """On the CPU the port runs its plain versions, the reference's
    source: every number is 0, every frame delivered, and the run is
    correct under the cell's own limits."""
    spec = tiny_spec(tmp_path)
    r = harness.measure(spec, cell, 2 ** 33 + 5, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(v["value"] == 0.0 for v in r["check"].values())
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics(cell,
                                                                 False)}
    assert {"fps", "setup_s"} <= set(r["metrics"])
    assert list(r)[-1] == "check"


def test_traced_run_reports_the_per_layer_metrics(tmp_path):
    r = harness.measure(tiny_spec(tmp_path), "all16.orbit", 3, 0.5, True,
                        "cpu")
    assert r["correct"]
    for name in ("frame.dispatch_ms", "prep.host_ms", "mesh.host_ms",
                 "sweep.host_ms", "taa.host_ms", "device.idle_share"):
        assert name in r["metrics"]
    assert r["device"]["window_s"] > 0.0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_control_is_not_correct(tmp_path):
    """The reference one precision step lower in the program's place
    fails the cell's limits."""
    spec = tiny_spec(tmp_path)
    run = harness.Run(spec, "all16.orbit", 11, "cpu")
    run.warmup()
    run.window(0.5)
    run.close()
    exact, lower = run.reference(), run.reference(LOWER)
    rows = [check.frame_numbers(check.Sample(0, None, lo.hdr,
                                             lo.state.taa_history,
                                             lo.image), ex)
            for lo, ex in zip(lower, exact)]
    limits = json.loads((HERE / "limits" / "all16.orbit.json").read_text())
    correct, shown = check.verdict(check.worst(rows), limits)
    assert not correct


def stuck(engine):
    """A step that returns its state unchanged."""
    render = engine.render

    def step(camera, use_taa=True):
        before = engine.state
        image = render(camera, use_taa)
        engine.state = before
        return image

    engine.render = step


def half_the_volumes(engine):
    """Half of the volumes left out of the frame."""
    import multivolumes_tpu_torch.render.frame as frame_module

    cull_volumes = frame_module.cull_lib.cull_volumes

    class Cull:
        @staticmethod
        def cull_volumes(*args, **kwargs):
            c = cull_volumes(*args, **kwargs)
            visible = c.visible.clone()
            visible[1::2] = False
            return c._replace(visible=visible)

    engine._restore = (frame_module, "cull_lib", frame_module.cull_lib)
    frame_module.cull_lib = Cull


def altered(engine):
    """An answer altered where it is produced: a 4 x 4 block of each
    image."""
    render = engine.render

    def step(camera, use_taa=True):
        image = render(camera, use_taa).clone()
        image[:4, :4] += 0.25
        return image

    engine.render = step


def history_upset_once(engine):
    """The carried TAA history upset once, after frame 3, which is not
    sampled: only the replayed frame sees it."""
    render = engine.render

    def step(camera, use_taa=True):
        image = render(camera, use_taa)
        if engine.state.frame_idx == 4:
            engine.state = dataclasses.replace(
                engine.state, taa_history=engine.state.taa_history + 0.5)
        return image

    engine.render = step


@pytest.mark.parametrize("fault", [stuck, half_the_volumes, altered,
                                   history_upset_once],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    hooked = []

    def hook(engine):
        fault(engine)
        hooked.append(engine)

    try:
        r = harness.measure(tiny_spec(tmp_path), "all16.orbit", 21, 0.5,
                            False, "cpu", setup_hook=hook)
    finally:
        for engine in hooked:
            if hasattr(engine, "_restore"):
                setattr(*engine._restore)
    assert not r["correct"]
    assert r["failed"] > 0


def test_a_stale_host_copy_is_not_correct(tmp_path, monkeypatch):
    """Host delivery: the image compared is the host copy the client
    received; a copy made only for the first frame leaves every later
    frame's buffer stale."""
    send = FrameLoop._send

    def first_only(self, index, image):
        if index == 0:
            send(self, index, image)

    monkeypatch.setattr(FrameLoop, "_send", first_only)
    r = harness.measure(tiny_spec(tmp_path), "all64.orbit.d1", 23, 0.5,
                        False, "cpu")
    assert not r["correct"]
    assert r["check"]["image_p999"]["value"] > \
        r["check"]["image_p999"]["limit"]


def test_sweep_count_of_an_empty_volume(tmp_path, monkeypatch):
    """B1 on transparent volumes needs no sample: no operation, and bytes
    only for the per-ray parameters and the output."""
    import multivolumes_tpu_torch.render.sweep as sweep_module
    from mvbench import inputs

    monkeypatch.setattr(inputs, "densities", lambda seed, count, grid, dev:
                        [np.zeros((grid,) * 3, np.float32)] * count)
    calls = []
    march = sweep_module.sweep_march

    def capture(*a, **k):
        calls.append((a, k))
        return march(*a, **k)

    monkeypatch.setattr(sweep_module, "sweep_march", capture)
    run = harness.Run(tiny_spec(tmp_path), "all16.orbit.nomesh", 1, "cpu")
    run.loop.run(frames=1)
    run.close()
    assert calls
    for args, kwargs in calls:
        nbytes, flops = roofline.bound_sweep(args, kwargs)
        size, n = args[8], args[2].shape[0]
        assert flops == 0.0
        assert nbytes == roofline._nbytes(*args[4]) + 4 * n * 6 * 4 * \
            size * size
