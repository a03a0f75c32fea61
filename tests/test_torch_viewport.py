"""The all64 demo at 2560x1440 (the benchmark's `all64_1440p`): its
configuration, the raster-preset pick along the benchmark's orbit, the
near ladder's frame against the benchmark's frozen reference, and the
frame counters (`utils.timing.add`) that say which mesh and TAA work a
frame launched. CPU, tiny sizes; the card's run at the real size is
`mvbench/tests/test_viewport_card.py`."""

import json
import math

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread, write_test_mesh  # noqa: F401

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.render import mesh as mesh_lib
from multivolumes_tpu_torch.scene import io_obj
from multivolumes_tpu_torch.utils import timing

CELL = "all64.orbit.1440p"
NEAR_TIERS = ((2048, 10), (128, 36))   # the all-distance ladder, pinned


def _bench():
    from mvbench.spec import ROOT

    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _config(name):
    from mvbench.spec import Spec

    return Spec().config(name)


# --- (a) the configuration ------------------------------------------------

def test_config_loads_into_render_config():
    from mvbench.spec import render_config

    cfg = RenderConfig(**render_config(_config("all64_1440p")))
    assert (cfg.width, cfg.height) == (2560, 1440)
    assert cfg.num_volumes == 64 and cfg.mesh_pos_scale == (0.0, -9.0, 0.0,
                                                             1.8)


def test_config_is_all64_but_for_the_viewport():
    big, base = _config("all64_1440p"), _config("all64")
    assert {k: v for k, v in big["render"].items()
            if k not in ("width", "height")} == \
        {k: v for k, v in base["render"].items()
         if k not in ("width", "height")}
    assert base["render"]["width"] == 1280 and big["render"]["width"] == 2560
    for key in ("mesh_triangles", "precision", "reduced"):
        assert big[key] == base[key]
    n = len(base["assumed"])
    assert big["assumed"][:n] == base["assumed"]
    assert any("2560x1440" in a for a in big["assumed"][n:])


def test_config_entry_and_cell():
    bench = _bench()
    entry = next(c for c in bench["configs"] if c["name"] == "all64_1440p")
    assert len(entry["source"]) <= 200
    assert entry["source"] == _config("all64_1440p")["source"]
    assert entry["reduced"] == []
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("all64_1440p", "orbit", 1)


# --- (b) the preset along the benchmark's orbit ---------------------------

def _torus_aabb(tmp_path, render):
    """The benchmark's 70k-triangle torus placed as `set_mesh` places it
    -> its world AABB (2, 3), host numpy."""
    from mvbench import inputs

    mesh = io_obj.load_obj(inputs.write_torus(tmp_path / "t.obj", 70000))
    mx, my, mz, ms = render["mesh_pos_scale"]
    v = np.asarray(mesh.vertices, np.float32)[:, :3] * ms \
        + np.asarray([mx, my, mz], np.float32)
    return np.stack([v.min(0), v.max(0)])


@pytest.mark.parametrize("config,preset", [("all64", "far"),
                                           ("all64_1440p", "near")])
def test_the_orbit_picks_one_preset_at_each_viewport(tmp_path, config,
                                                     preset):
    """50 poses over two turns of the orbit (radius 60, height 6): the
    engine's host pick, from the torus's world AABB, takes the far ladder
    on every frame at 1280x800 (the bbox edge at most the 360-px bound)
    and the near one on every frame at 2560x1440 (above the bound's
    1.05x ceiling, 378 px)."""
    from mvbench import inputs
    from mvbench.spec import Spec

    render = _config(config)["render"]
    camera = Spec().traffic("orbit")["camera"]
    cfg = RenderConfig(width=render["width"], height=render["height"],
                       show_mesh=True, raster_far_tiers=((64, 8),))
    picker = type("Picker", (), {})()
    picker.config, picker._mesh_aabb = cfg, _torus_aabb(tmp_path, render)
    seen, sizes = set(), []
    for a in np.linspace(0.0, 4.0 * math.pi, 50, endpoint=False):
        eye = inputs.orbit(camera, 2.0 * a, 0, cfg.aspect_ratio)[0]
        seen.add(MultiRayCaster.select_raster_preset(
            picker, tuple(float(e) for e in eye)))
        sizes.append(mesh_lib.projected_size_px(
            picker._mesh_aabb, eye, camera["focus"], cfg.width, cfg.height))
    assert seen == {preset}
    if preset == "far":
        assert max(sizes) <= cfg.raster_far_bound
    else:
        assert min(sizes) > mesh_lib.far_ceiling(cfg)


# --- the raster's sample count --------------------------------------------

def _tiny_mesh(tmp_path, n_tris=600):
    """A torus's clip positions at a 96 x 64 viewport -> (clip, indices)."""
    mesh = io_obj.load_obj(write_test_mesh(tmp_path / "m.obj", n_tris))
    v = torch.from_numpy(np.asarray(mesh.vertices, np.float32)[:, :3])
    idx = torch.from_numpy(np.asarray(mesh.indices, np.int64))
    view = math3d.look_at_lh(torch.tensor([2.0, 3.0, -9.0]),
                             torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
    proj = math3d.perspective_fov_lh(0.8, 96 / 64, 0.1, 100.0)
    return math3d.transform_point(v, view @ proj), idx


LEVERS = {
    "near": dict(big_tiers=NEAR_TIERS, cull=1, capacity=300, dense_top=16,
                 tail=(0.6, 2)),
    "near-window": dict(big_tiers=NEAR_TIERS, cull=1, capacity=300,
                        dense_top=16, tail=(0.6, 2), dense_window=40),
    "far-small": dict(big_tiers=((40, 9), (100, 6)), cull=1, capacity=300,
                      dense_top=16, small_tiers=((200, 3), (260, 2))),
    "default": dict(),
    "plain": dict(big_tiers=(), k=3),
    "band": dict(big_tiers=NEAR_TIERS, dense_top=16, tail=(0.6, 2),
                 band=(1, 2)),
    "no-ids": dict(big_tiers=NEAR_TIERS, dense_top=16, want_ids=False),
}


@pytest.mark.parametrize("name", list(LEVERS))
def test_raster_samples_counts_what_the_raster_launches(name, tmp_path,
                                                       monkeypatch):
    """`raster_samples` equals the coverage samples `rasterize` scatters
    (the length of its one scatter-min) plus the dense pass's triangles x
    the pixels it z-tests."""
    clip, idx = _tiny_mesh(tmp_path)
    levers = LEVERS[name]
    scattered = []
    scatter = torch.Tensor.scatter_reduce_

    def spy(self, dim, index, src, reduce, **kw):
        scattered.append(index.numel())
        return scatter(self, dim, index, src, reduce, **kw)

    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", spy)
    mesh_lib.rasterize(clip, idx, 96, 64, **levers)
    T = idx.shape[0]
    dense = levers.get("dense_top", 0)
    if dense:
        win = levers.get("dense_window")
        rows = 64 // levers["band"][1] if "band" in levers else 64
        dense = min(dense, T) * (win * win if win else rows * 96)
    assert len(scattered) == 1
    assert mesh_lib.raster_samples(T, 96, 64, **levers) == \
        scattered[0] + dense


def test_near_ladder_sample_count_by_hand():
    """The near ladder on a 70k-triangle mesh at 2560x1440, with the
    engine's levers (culling's capacity T / 2, the 0.6 tail at 2 x 2, the
    16 dense triangles on the whole screen): ranks [16, 128) at 36 x 36,
    [128, 2048) at 10 x 10, [2048, 13992) at 4 x 4, [13992, 34980) at
    2 x 2."""
    T = 69960
    want = (112 * 36 ** 2 + 1920 * 10 ** 2 + (13992 - 2048) * 4 ** 2
            + (34980 - 13992) * 2 ** 2 + 16 * 2560 * 1440)
    assert mesh_lib.raster_samples(
        T, 2560, 1440, big_tiers=NEAR_TIERS, cull=1, capacity=T // 2,
        dense_top=16, tail=(0.6, 2)) == want


# --- (c), (d) the frame's counters, and the frame against the reference ---

def _tiny_run(tmp_path, seed, **render):
    """The cell at mvbench's tiny size (`mvbench/tests/tiny.py`), the
    render fields `render` changed -> a harness Run on the CPU."""
    from mvbench import harness
    from mvbench.tests.tiny import tiny_spec

    spec = tiny_spec(tmp_path)
    path = tmp_path / "mvbench" / "configs" / "all64_1440p.json"
    cfg = json.loads(path.read_text())
    cfg["render"].update(render)
    path.write_text(json.dumps(cfg))
    return harness.Run(spec, CELL, seed, "cpu")


def _three_frames(run):
    """Frame 0 kept as the start sample, frames 1 and 2 as window samples
    -> ([their frame records], the engine's config, its triangles)."""
    run.loop.run(frames=1, on_frame=run._keep)
    run.loop.run(frames=2, on_frame=run._offer)
    recs = [timing.SPANS.frames[i] for i in range(3)]
    return recs, run.engine.config, run.engine.state.mesh_indices.shape[0]


def _levers(cfg, far: bool, n_tris: int) -> dict:
    return dict(big_tiers=cfg.raster_far_tiers if far else NEAR_TIERS,
                cull=1, capacity=n_tris // 2, dense_top=16, tail=(0.6, 2),
                small_tiers=cfg.raster_far_small if far else None)


def test_near_path_matches_the_reference(tmp_path):
    """The tiny torus (43-55 px at 192 x 128) above a lowered
    `raster_far_bound` of 40 px, whose far ladder exists: three frames on
    the near ladder, shaded and reprojected on the whole screen, equal
    the frozen reference's (the CPU runs the plain versions, the
    reference's source), and the counters read the near ladder's samples
    and H x W twice."""
    run = _tiny_run(tmp_path, 2 ** 32 + 7, width=192, height=128,
                    raster_far_bound=40)
    try:
        recs, cfg, T = _three_frames(run)
    finally:
        run.close()
    assert cfg.raster_preset == "near" and cfg.raster_far_tiers
    h, w = cfg.height, cfg.width
    n_emit = T // 2
    # tail: one rank at 4 x 4 past the capacity; big tiers up to T
    near = (16 + 112 * 36 ** 2 + (T - 128) * 10 ** 2 + 16 * h * w)
    assert n_emit <= 2048 and T > 128
    for rec in recs:
        assert rec.counters == {"mesh.raster_samples": near,
                                "mesh.shade_px": h * w,
                                "taa.reproj_px": h * w}
        assert "mesh.near" in rec.ms("step")
    numbers = run.numbers()
    assert len(numbers["rows"]) == 3
    assert all(v == 0.0 for v in numbers["worst"].values()), numbers


@pytest.mark.parametrize("windows", [False, True],
                         ids=["default-bound", "windowed"])
def test_far_path_counters(tmp_path, windows):
    """At the default bound the tiny torus (22-27 px) stays on its far
    ladder; the 384 / 416-px windows do not fit a 96 x 64 screen, so the
    shade and the reprojection cover H x W. With a 36-px bound and
    40 / 56-px windows the dense pass and the shade cover the shade
    window and the reprojection its window. The frames equal the
    reference's."""
    render = (dict(raster_far_bound=36, mesh_shade_window=40,
                   taa_reproj_window=56) if windows else {})
    run = _tiny_run(tmp_path, 2 ** 31 + 3, **render)
    try:
        recs, cfg, T = _three_frames(run)
    finally:
        run.close()
    assert cfg.raster_preset == "far"
    h, w = cfg.height, cfg.width
    far = mesh_lib.raster_samples(T, w, h, dense_window=40 if windows
                                  else None, **_levers(cfg, True, T))
    assert far != mesh_lib.raster_samples(T, w, h, **_levers(cfg, False, T))
    for rec in recs:
        assert rec.counters == {
            "mesh.raster_samples": far,
            "mesh.shade_px": 40 * 40 if windows else h * w,
            "taa.reproj_px": 56 * 56 if windows else h * w}
        assert "mesh.near" not in rec.ms("step")
    assert all(v == 0.0 for v in run.numbers()["worst"].values())


def test_sharded_mesh_counts_each_band(tmp_path):
    """The banded raster of the sharded step: each band emits every
    triangle's samples and z-tests its own rows densely, so the count is
    rows x the emits plus the dense pass over the screen; the shade
    covers the screen once."""
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.parallel import sharding
    from multivolumes_tpu_torch.render import frame as frame_lib

    cfg = RenderConfig(width=48, height=32, grid_size=8, light_grid_size=8,
                       max_ray_samples=8, max_light_samples=4,
                       num_volumes=2, num_volume_srcs=1, cube_map_size=8,
                       shadow_map_size=32)
    eng = MultiRayCaster(cfg, device="cpu")
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 300))
    cam = cam_lib.make_camera([3.0, 1.0, -12.0], [0.0, -2.0, 0.0],
                              cfg.aspect_ratio, device="cpu")
    mesh = sharding.make_mesh(["cpu"] * 2, rows=2)
    state = sharding.shard_state(eng.state, mesh)
    frame_lib.render_frame(state, cam, eng.config, mesh=mesh)
    rec = timing.SPANS.frames[state.frame_idx]
    T = eng.state.mesh_indices.shape[0]
    kw = _levers(eng.config, False, T)
    whole = mesh_lib.raster_samples(T, 48, 32, **kw)
    bands = [mesh_lib.raster_samples(T, 48, 32, band=(r, 2), **kw)
             for r in range(2)]
    assert rec.counters["mesh.raster_samples"] == sum(bands) == \
        2 * whole - 16 * 48 * 32
    assert rec.counters["mesh.shade_px"] == 48 * 32
    assert rec.counters["taa.reproj_px"] == 48 * 32


# --- B2's exit geometry, rounded as the plain version ---------------------

def test_b2_exit_geometry_is_uncontracted():
    """`csrc/composite.cu` computes each pair's exit (the local ray, the
    exit point, its clip z and w) with products and sums rounded one by
    one in the plain version's order, so the hit, the exit face and the
    depth test are the plain version's: at 2560x1440 a fused multiply-add
    there moved a few pixels a frame across them (one volume's colour,
    up to 1.5e-2). Every such statement, and the helpers it calls, uses
    only the `__f*_rn` intrinsics."""
    import re
    from pathlib import Path

    import multivolumes_tpu_torch

    src = (Path(multivolumes_tpu_torch.__file__).parent / "csrc"
           / "composite.cu").read_text()
    for name in ("lin2_rn", "dot3_rn"):
        body = re.search(name + r"\([^)]*\) \{\n(.*?)\n\}", src, re.S)
        assert body, name
        expr = body.group(1)
        assert "__fmul_rn" in expr and "__fadd_rn" in expr
        assert not re.search(r"[^_\w]\w+(\[\d\])? [*+] ", expr), expr
    for var in ("dlx", "dly", "dlz", "qx", "qy", "qz", "hz", "hw"):
        stmts = re.findall(r"const float " + var + r" = ([^;]*);", src)
        assert len(stmts) == 1, var
        assert re.match(r"(lin2_rn|dot3_rn|__fadd_rn)\(", stmts[0]), stmts
        # no float arithmetic outside the intrinsics (a pointer offset
        # into the record is no rounding)
        expr = re.sub(r"vf \+ \d+", "vf", stmts[0])
        assert not re.search(r"\w [*+] \w", expr), stmts


# --- (e) timing.add -------------------------------------------------------

def test_add_outside_a_frame_records_nothing(monkeypatch):
    rec = timing.SpanRecorder()
    monkeypatch.setattr(timing, "SPANS", rec)
    timing.add("mesh.shade_px", 5)
    assert rec.frames == {} and rec.current is None
    with rec.frame(3):
        timing.add("mesh.shade_px", 5)
        timing.add("mesh.shade_px", 2)
        timing.add("taa.reproj_px", 1)
    timing.add("mesh.shade_px", 100)
    assert rec.frames[3].counters == {"mesh.shade_px": 7, "taa.reproj_px": 1}


# --- the benchmark's counter readers --------------------------------------

COUNTER_METRICS = {"mesh.raster_msamples": "mesh.raster_samples",
                   "mesh.shade_mpx": "mesh.shade_px",
                   "taa.reproj_mpx": "taa.reproj_px"}


def _ctx(indices):
    from mvbench.harness import Context
    from mvbench.loop import Frame

    return Context(window=[Frame(i, 0.0, 0.01, 0.02) for i in indices],
                   seconds=1.0, trace=None)


@pytest.mark.parametrize("metric", list(COUNTER_METRICS))
def test_counter_readers_average_the_window_frames(metric, monkeypatch):
    from mvbench.spec import Spec

    rec = timing.SpanRecorder()
    for i, v in ((1, 2e6), (2, 4e6), (3, None)):
        with rec.frame(i):
            if v is not None:
                rec.add(COUNTER_METRICS[metric], v)
    monkeypatch.setattr(timing, "SPANS", rec)
    reader = Spec().reader(metric)
    assert reader.read(_ctx([1, 2])) == pytest.approx(3.0)
    assert reader.read(_ctx([1, 2, 3])) == pytest.approx(2.0)
    assert reader.read(_ctx([3])) is None       # no frame ran the pass
    assert reader.read(_ctx([1, 99])) is None   # a window frame unrecorded
    assert reader.read(_ctx([])) is None


def test_counter_readers_find_nothing_in_a_program_without_counters(
        monkeypatch):
    """A program whose frame records have no counters (the recorder
    before them) gives no reading, and no error."""
    from mvbench.spec import Spec

    class Old:
        __slots__ = ("index", "spans")

    rec = timing.SpanRecorder()
    old = Old()
    old.index, old.spans = 5, []
    rec.frames[5] = old
    monkeypatch.setattr(timing, "SPANS", rec)
    for metric in COUNTER_METRICS:
        assert Spec().reader(metric).read(_ctx([5])) is None
