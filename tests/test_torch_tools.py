"""The port's timing helpers, driver entry points and tools on the CPU:
`utils/timing.py` (smoke tests: the numbers are host-clock times here),
`entry.py` (the frame step against the JAX frame at
`__graft_entry__.py:_small_config`'s scale, mean < 2e-3 and p99.9 < 3e-2,
tests/test_goldens.py:37-41; the sharded dry run), and the tools at their
CPU sizes: `fidelity_demo --small --cpu` within the JAX gate (mean <
1e-2, p99 < 8e-2, tests/test_fidelity.py:61-68), the gallery's one-count
renderer, `trace_ops`'s attribution of device time by the pass that
launched it, `bench_fallbacks` and `profile_fast_path`. Without a card
and without `--cpu` (or `device="cpu"`) each stops with a clear error.

The JAX frame renders with `light_axis=2` baked: the default light ties
the three axes, and the port takes the host pick (ROADMAP.md section
C)."""

import json

import jax
import numpy as np
import pytest
import torch
from torch_parity import (image_stats, jax_state_dict,  # noqa: F401
                          one_torch_thread, port_config, write_test_mesh)

from __graft_entry__ import _small_config
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch import entry as pentry
from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.scene import state as pstate
from multivolumes_tpu_torch.tools import (bench_fallbacks, fidelity_demo,
                                          profile_fast_path, render_gallery,
                                          trace_ops)
from multivolumes_tpu_torch.utils import timing

CPU = torch.device("cpu")
TINY = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                    max_ray_samples=16, max_light_samples=8, num_volumes=2,
                    num_volume_srcs=2, cube_map_size=16, shadow_map_size=32)


def test_sync_and_time_fn_on_the_cpu():
    tree = {"a": (torch.tensor([3.0, 4.0]),), "b": [torch.tensor([5.0, 6.0])]}
    assert timing.sync(tree) == 5.0
    assert timing.sync((torch.ones(2), torch.empty(0))) == 1.0
    assert timing.sync(()) == 0.0
    x = torch.rand(256, 256)
    assert timing.time_fn(torch.matmul, x, x, iters=2) > 0.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(tmp_path) as log_dir:
        torch.ones(16).mul(2.0).sum()
    with open(log_dir / timing.TRACE_FILE) as f:
        assert json.load(f)["traceEvents"]


def test_profile_frame_times_every_pass_of_the_frame():
    state = pstate.create_scene(TINY, device="cpu")
    cam = pcam.default_camera(TINY.aspect_ratio, device="cpu")
    names = []
    pframe.render_frame(pstate.create_scene(TINY, device="cpu"), cam, TINY,
                        timer=names.append)
    passes = timing.profile_frame(state, cam, TINY, iters=2)
    assert list(passes) == [x for x in names if x is not None]
    assert list(passes) == ["prep", "light", "sweep", "sky", "composite",
                            "tail", "taa", "tonemap"]
    assert all(ms > 0.0 for ms in passes.values())


def test_entry_step_matches_the_jax_step():
    jcfg = _small_config()
    assert port_config(jcfg) == pentry.small_config()
    step, (state, camera) = pentry.entry(device="cpu")
    jst = jstate.create_scene(jcfg)
    out = jax.jit(lambda s, c: jframe.render_frame(
        s, c, jcfg.with_(light_axis=2), use_taa=True))(
            jst, jcam.default_camera(jcfg.aspect_ratio))
    img, new_state = step(pstate.state_from_numpy(jax_state_dict(jst)),
                          camera)
    assert tuple(img.shape) == (128, 192, 3)
    assert new_state.frame_idx == 1
    mean, p999, mx = image_stats(img, out.image, 99.9)
    assert mean < 2e-3 and p999 < 3e-2, (mean, p999, mx)
    # the example state is the port's own scene at that scale
    assert state.num_volumes == 8 and tuple(state.taa_history.shape) == (
        4, 128, 192)


def test_dryrun_multichip_on_cpu_shards():
    pentry.dryrun_multichip(2, device="cpu")


def test_entry_points_stop_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pentry.dryrun_multichip(2)
    for main in (fidelity_demo.main, bench_fallbacks.main,
                 render_gallery.main, trace_ops.main,
                 profile_fast_path.main, pentry.main):
        with pytest.raises(SystemExit, match="--cpu"):
            main([])


def test_fidelity_demo_small_is_within_the_jax_gate():
    r = fidelity_demo.main(["--small", "--cpu"])
    assert r["mean"] < 1e-2 and r["p99"] < 8e-2, r
    assert r["covered"] > 0.05, r


def test_gallery_renders_one_count_to_a_png(tmp_path):
    mesh = write_test_mesh(tmp_path / "torus.obj", 2000)
    path = render_gallery.render_count(4, tmp_path / "gallery", CPU,
                                       small=True, frames=1, mesh_path=mesh)
    with open(path, "rb") as f:
        data = f.read()
    assert path.endswith("all4_mesh.png")
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000


def test_trace_ops_parses_a_cpu_trace_into_passes(tmp_path):
    report = trace_ops.run(TINY, CPU, 1, log_dir=tmp_path)
    assert list(report["passes"]) == ["prep", "light", "sweep", "sky",
                                      "composite", "tail", "taa", "tonemap"]
    assert all(p["host_ms"] > 0.0 for p in report["passes"].values())
    assert report["device_ms"] == 0.0 and report["unattributed_ms"] == 0.0


def test_trace_ops_ties_each_kernel_to_the_pass_that_launched_it():
    """A kernel that runs during the next pass's range counts for the pass
    whose range holds its launch (the program's `span:` ranges); one whose
    launch is outside every range, or unknown, is unattributed."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": args}

    events = [
        x("span:light", "user_annotation", 0.0, 100.0),
        x("span:sweep", "user_annotation", 100.0, 100.0),
        x("cudaLaunchKernelExC", "cuda_runtime", 50.0, 5.0, correlation=1),
        x("cuLaunchKernel", "cuda_driver", 120.0, 5.0, correlation=2),
        x("cudaLaunchKernel", "cuda_runtime", 250.0, 5.0, correlation=3),
        # launched in light, run during sweep
        x("void (anonymous namespace)::self_scan_kernel<0, true>(float "
          "const*)", "kernel", 150.0, 40.0, correlation=1),
        x("void (anonymous namespace)::sweep_kernel<__nv_bfloat16, true>("
          "int)", "kernel", 190.0, 60.0, correlation=2),
        x("Memcpy HtoD", "gpu_memcpy", 260.0, 10.0, correlation=3),
        x("orphan_kernel", "kernel", 300.0, 20.0, correlation=9),
    ]
    report = trace_ops.attribute({"traceEvents": events}, frames=2)
    light, sweep = report["passes"]["light"], report["passes"]["sweep"]
    assert light["device_ms"] == pytest.approx(0.02)
    assert light["kernels"] == 0.5
    assert list(light["by_kernel"]) == ["self_scan_kernel<0, true>"]
    assert sweep["device_ms"] == pytest.approx(0.03)
    assert list(sweep["by_kernel"]) == ["sweep_kernel<__nv_bfloat16, true>"]
    assert light["host_ms"] == pytest.approx(0.05)
    assert report["device_ms"] == pytest.approx(0.065)
    assert report["unattributed_ms"] == pytest.approx(0.015)
    assert set(report["unattributed"]) == {"Memcpy HtoD", "orphan_kernel"}
    assert trace_ops.passes_of(report, "sweep_kernel") == {"sweep"}
    assert trace_ops.passes_of(report, "self_scan_kernel") == {"light"}


def test_bench_fallbacks_and_profile_fast_path_on_the_cpu():
    res = bench_fallbacks.bench(TINY, CPU, 1)
    assert set(res) == {"light_reference_point", "march_reference_raycast"}
    assert all(ms > 0.0 for ms, _first in res.values())
    passes, frame_ms = profile_fast_path.profile(TINY, CPU, 1)
    assert "sweep" in passes and frame_ms > 0.0
