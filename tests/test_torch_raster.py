"""B9, the mesh layer's z-buffer raster (`ops/raster.py`, called by
`render/mesh.py:rasterize`), against its plain version
`rasterize_plain`.

On the CPU: the segment table B9 launches (`emit_segments`) covers the
coverage samples of `_emit_plan` exactly, and with the dense pass it
counts `raster_samples`, on the far, near, tail and band levers; the
dispatch rule; a CPU mesh frame that launches nothing. On the card
(marked `cuda`, skipped without one): depth and tri_id of the kernel
equal to the plain version's bit for bit (`torch.equal`) on the test
torus on the far ladder with the 384 window at 1280x800 from three orbit
eyes, on the near ladder at 2560x1440 and 1283x803, seen from a camera
with vertices behind the near plane, in two row bands (which stack to
the unbanded raster), as the depth-only shadow map at 1024^2, and on a
synthetic mesh past 2^17 triangles; the kernel run with one emit segment
left out, or without its dense pass, does not pass that check; and a mesh
frame's launches. This file imports neither JAX nor the JAX package, so
on the machine with the card

    python -m pytest --noconftest -m cuda tests/test_torch_raster.py -q
"""

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, write_test_mesh
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.ops import raster as raster_ops
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import mesh as mesh_lib
from multivolumes_tpu_torch.render.mesh import NEAR_TIERS
from multivolumes_tpu_torch.scene import io_obj

T70K = 69960     # the test torus at the demo's size


def _tiny_mesh(tmp_path, n_tris=600, eye=(2.0, 3.0, -9.0)):
    """A torus's clip positions at a 96 x 64 viewport -> (clip, indices)."""
    mesh = io_obj.load_obj(write_test_mesh(tmp_path / "m.obj", n_tris))
    v = torch.from_numpy(np.asarray(mesh.vertices, np.float32)[:, :3])
    idx = torch.from_numpy(np.asarray(mesh.indices, np.int64))
    view = math3d.look_at_lh(torch.tensor(eye), torch.zeros(3),
                             torch.tensor([0.0, 1.0, 0.0]))
    proj = math3d.perspective_fov_lh(0.8, 96 / 64, 0.1, 100.0)
    return math3d.transform_point(v, view @ proj), idx


# --- on the CPU: the segment table ------------------------------------------

# (triangles, width, height, levers): the tiny torus's levers, and the
# frames' levers on the 70k torus (the all64 frame's far ladder with its
# window, the near ladder at 1440p, a band of it)
SEG_LEVERS = {
    "far": (600, 96, 64, dict(big_tiers=((40, 9), (100, 6)), cull=1,
                              capacity=300, dense_top=16,
                              small_tiers=((200, 3), (260, 2)),
                              dense_window=40)),
    "near": (600, 96, 64, dict(big_tiers=NEAR_TIERS, cull=1, capacity=300,
                               dense_top=16, tail=(0.6, 2))),
    "tail": (600, 96, 64, dict(big_tiers=(), dense_top=16, tail=(0.5, 2))),
    "band": (600, 96, 64, dict(big_tiers=NEAR_TIERS, dense_top=16,
                               tail=(0.6, 2), band=(1, 2))),
    "unordered": (600, 96, 64, dict(big_tiers=(), k=3)),
    "far-70k": (T70K, 1280, 800, dict(big_tiers=((1153, 6),), cull=1,
                                      capacity=T70K // 2, dense_top=16,
                                      tail=(0.6, 2),
                                      small_tiers=((4066, 3), (7049, 2)),
                                      dense_window=384)),
    "near-70k": (T70K, 2560, 1440, dict(big_tiers=NEAR_TIERS, cull=1,
                                        capacity=T70K // 2, dense_top=16,
                                        tail=(0.6, 2))),
    "band-70k": (T70K, 2560, 1440, dict(big_tiers=NEAR_TIERS, cull=1,
                                        capacity=T70K // 2, dense_top=16,
                                        tail=(0.6, 2), band=(0, 2))),
}
_EMIT_KEYS = ("k", "big_tiers", "capacity", "dense_top", "tail",
              "small_tiers")


def _segments(n_tris, levers):
    kw = {key: levers.get(key, default) for key, default in zip(
        _EMIT_KEYS, (4, mesh_lib._BIG_TIERS, None, 0, None, None))}
    return mesh_lib.emit_segments(n_tris, **kw), kw


@pytest.mark.parametrize("name", list(SEG_LEVERS))
def test_segment_table_covers_the_emit_plan(name):
    """Each sample of the table is one (rank, kk) sample of `_emit_plan`
    and each of those is one of the table's: the plan's slices of the
    ranks (`order[lo:hi]`, or every triangle in index order), each rank
    kk^2 times, against the table's segments, numbered back to back; with
    the dense pass's triangles x pixels the total is `raster_samples`."""
    n_tris, width, height, levers = SEG_LEVERS[name]
    (ordered, segments), kw = _segments(n_tris, levers)
    ordered_plan, plan = mesh_lib._emit_plan(n_tris, **kw)
    assert ordered == ordered_plan
    want = []
    for lo, hi, kk in plan:
        by_rank = lo is not None
        for r in range(n_tris)[slice(lo, hi)]:
            want.append((by_rank, r, kk))
    got, start = [], 0
    for lo, count, kk, by_rank, seg_start in segments:
        assert seg_start == start and count > 0
        got += [(bool(by_rank), r, kk) for r in range(lo, lo + count)]
        start += count * kk * kk
    assert sorted(got) == sorted(want)
    assert start == sum(kk * kk for _b, _r, kk in want)
    dense = 0
    if levers.get("dense_top") and ordered:
        win, band = levers.get("dense_window"), levers.get("band")
        rows = height // band[1] if band else height
        dense = min(levers["dense_top"], n_tris) * (
            win * win if win and not band else rows * width)
    assert start + dense == mesh_lib.raster_samples(n_tris, width, height,
                                                    **levers)


@pytest.mark.parametrize("name", [n for n in SEG_LEVERS if "70k" not in n])
def test_segment_table_is_what_the_plain_raster_scatters(name, tmp_path,
                                                         monkeypatch):
    """The table's sample total is the length of the plain version's one
    scatter-min on the tiny torus."""
    n_tris, width, height, levers = SEG_LEVERS[name]
    clip, idx = _tiny_mesh(tmp_path, n_tris)
    (_ordered, segments), _kw = _segments(idx.shape[0], levers)
    scattered = []
    scatter = torch.Tensor.scatter_reduce_

    def spy(self, dim, index, src, reduce, **kw):
        scattered.append(index.numel())
        return scatter(self, dim, index, src, reduce, **kw)

    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", spy)
    mesh_lib.rasterize(clip, idx, width, height, **levers)
    lo, count, kk, _by_rank, start = segments[-1]
    assert scattered == [start + count * kk * kk]


# --- on the CPU: the dispatch rule -------------------------------------------

def test_raster_dispatch_rule_on_cpu(tmp_path):
    """CPU tensors take the plain version unchanged; impl="kernel" on the
    CPU raises, so does the wrapper itself; nothing launches."""
    clip, idx = _tiny_mesh(tmp_path)
    levers = dict(SEG_LEVERS["far"][3])
    ops.reset_launches()
    want = mesh_lib.rasterize_plain(clip, idx, 96, 64, **levers)
    for impl in (None, "plain"):
        got = mesh_lib.rasterize(clip, idx, 96, 64, impl=impl, **levers)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((want[1] >= 0).any()) and bool((want[1] < 0).any())
    with pytest.raises(ValueError, match="CUDA"):
        mesh_lib.rasterize(clip, idx, 96, 64, impl="kernel", **levers)
    with pytest.raises(ValueError, match="impl"):
        mesh_lib.rasterize(clip, idx, 96, 64, impl="fast", **levers)
    (ordered, segments), _kw = _segments(idx.shape[0], levers)
    with pytest.raises(ValueError, match="CUDA"):
        raster_ops.raster(clip, idx, segments, ordered=ordered, width=96,
                          height=64, want_ids=True, cull=1, dense_top=16,
                          dense_window=40, band=None)
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_cpu_mesh_frame_launches_no_raster(tmp_path):
    cfg = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                       max_ray_samples=16, max_light_samples=8, num_volumes=4,
                       num_volume_srcs=2, cube_map_size=32,
                       shadow_map_size=64)
    eng = MultiRayCaster(cfg, device="cpu")
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 500))
    cam = cam_lib.orbit_camera(0.3, cfg.aspect_ratio, device="cpu")
    calls = []
    orig = mesh_lib.rasterize_plain

    def spy(*a, **k):
        calls.append((a[2], a[3]))
        return orig(*a, **k)

    mesh_lib.rasterize_plain = spy
    try:
        ops.reset_launches()
        frame_lib.render_frame(eng.state, cam, eng.config)
    finally:
        mesh_lib.rasterize_plain = orig
    assert calls == [(96, 64)]
    assert ops.LAUNCHES["raster"] == 0
    assert all(v == 0 for v in ops.LAUNCHES.values())


# --- on the card ------------------------------------------------------------

def _engine(dev, width, height, path, shadow=256):
    cfg = RenderConfig(width=width, height=height, grid_size=16,
                       light_grid_size=8, max_ray_samples=16,
                       max_light_samples=8, num_volumes=4, num_volume_srcs=2,
                       cube_map_size=32, shadow_map_size=shadow)
    eng = MultiRayCaster(cfg, device=dev)
    eng.set_mesh(write_test_mesh(path, T70K))
    return eng


def _frame_raster(eng, eye, focus=(0.0, 0.0, 0.0)):
    """-> (clip, indices, width, height, levers) of the frame's raster from
    `eye`, the preset picked as the app picks it."""
    eng.select_raster_preset(eye, focus)
    cfg = eng.config
    cam = cam_lib.make_camera(list(eye), list(focus), cfg.aspect_ratio,
                              device=eng.state.mesh_verts.device)
    op = mesh_lib._frame_operands(eng.state, cam, cfg)
    levers = dict(op.raster_kw, dense_window=(
        cfg.mesh_shade_window if mesh_lib._window_fits(cfg) else None))
    return op.clip_jit, eng.state.mesh_indices, cfg.width, cfg.height, levers


def _equal(name, clip, idx, width, height, levers):
    """B9 against the plain version on the same CUDA inputs: depth and
    tri_id equal (`torch.equal`), one launch -> the plain (depth,
    tri_id)."""
    ops.reset_launches()
    got = mesh_lib.rasterize(clip, idx, width, height, impl="kernel",
                             **levers)
    assert ops.LAUNCHES["raster"] == 1
    want = mesh_lib.rasterize(clip, idx, width, height, impl="plain",
                              **levers)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("depth", "tri_id")):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, what)
        n = int((g != w).sum())
        print(f"{name} {what}: {n} of {w.numel()} elements differ")
        assert torch.equal(g, w), (name, what, n)
    assert bool((want[0] < 1.0).any()), name
    return want


ORBIT_EYES = [(60.0 * np.sin(a), 6.0, 60.0 * np.cos(a))
              for a in (0.0, 2.1, 4.2)]


@pytest.mark.cuda
def test_b9_far_ladder_on_card(tmp_path):
    """The all64 frame's raster: the far ladder with the 384 dense window
    at 1280x800, from three orbit eyes. A kernel without one emit
    segment, or without its dense pass, fails the check: each segment's
    triangles and the dense ones win pixels of the plain raster."""
    dev = cuda_device()
    eng = _engine(dev, 1280, 800, tmp_path / "torus.obj")
    for i, eye in enumerate(ORBIT_EYES):
        clip, idx, w, h, levers = _frame_raster(eng, eye)
        assert eng.config.raster_preset == "far"
        assert levers["dense_window"] == 384 and levers["small_tiers"]
        want = _equal(f"far eye {i}", clip, idx, w, h, levers)
        if i:
            continue
        ordered, segments = mesh_lib.emit_segments(
            idx.shape[0], 4, levers["big_tiers"], levers["capacity"],
            levers["dense_top"], levers["tail"], levers["small_tiers"])
        assert len(segments) >= 3
        kw = dict(ordered=ordered, width=w, height=h, want_ids=True,
                  cull=levers["cull"], dense_window=384, band=None)
        for drop in range(len(segments)):
            cut = segments[:drop] + segments[drop + 1:]
            start, fixed = 0, []
            for lo, count, kk, by_rank, _s in cut:
                fixed.append((lo, count, kk, by_rank, start))
                start += count * kk * kk
            got = raster_ops.raster(clip, idx, tuple(fixed), dense_top=16,
                                    **kw)
            assert not torch.equal(got[1], want[1]), ("segment", drop)
        got = raster_ops.raster(clip, idx, segments, dense_top=0, **kw)
        assert not torch.equal(got[1], want[1]), "dense pass"


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(2560, 1440), (1283, 803)],
                         ids=["2560x1440", "1283x803"])
def test_b9_near_ladder_on_card(size, tmp_path):
    """The near ladder over the full screen (the 1440p frame's raster),
    and at an odd size from closer."""
    dev = cuda_device()
    eng = _engine(dev, *size, tmp_path / "torus.obj")
    eye = (0.0, 6.0, 60.0) if size[0] == 2560 else (14.0, 0.0, -30.0)
    clip, idx, w, h, levers = _frame_raster(eng, eye)
    assert eng.config.raster_preset == "near"
    assert levers["dense_window"] is None
    _equal(f"near {size}", clip, idx, w, h, levers)


@pytest.mark.cuda
def test_b9_behind_the_near_plane_on_card(tmp_path):
    """A camera inside the torus's ring, close to the tube: some vertices
    are behind the camera (clip w <= 1e-6), some in front."""
    dev = cuda_device()
    eng = _engine(dev, 1280, 800, tmp_path / "torus.obj")
    clip, idx, w, h, levers = _frame_raster(eng, (2.0, -5.0, 1.0),
                                            (6.0, -6.0, 4.0))
    assert bool((clip[:, 3] <= 1e-6).any()) and bool((clip[:, 3] > 1.0).any())
    _equal("behind", clip, idx, w, h, levers)


@pytest.mark.cuda
def test_b9_row_bands_on_card(tmp_path):
    """Two row bands of the near ladder at 1280x800, each equal to the
    plain band; stacked, the unbanded raster."""
    dev = cuda_device()
    eng = _engine(dev, 1280, 800, tmp_path / "torus.obj")
    clip, idx, w, h, levers = _frame_raster(eng, (14.0, 0.0, -30.0),
                                            (0.0, -7.0, 0.0))
    assert levers["dense_window"] is None
    bands = [_equal(f"band {r}", clip, idx, w, h, dict(levers, band=(r, 2)))
             for r in range(2)]
    whole = mesh_lib.rasterize(clip, idx, w, h, impl="kernel", **levers)
    for i in range(2):
        assert torch.equal(torch.cat([b[i] for b in bands]), whole[i])


@pytest.mark.cuda
def test_b9_shadow_map_on_card(tmp_path):
    """The depth-only light-view raster at 1024^2 on the near ladder, as
    `render_shadow_map` runs it; the engine's cached map is B9's."""
    dev = cuda_device()
    eng = _engine(dev, 1280, 800, tmp_path / "torus.obj", shadow=1024)
    state, cfg = eng.state, eng.config
    clip = math3d.transform_point(
        state.mesh_verts[:, :3],
        state.mesh_world @ mesh_lib.shadow_view_proj(state))
    levers = dict(big_tiers=NEAR_TIERS, want_ids=False, cull=1,
                  capacity=T70K // 2, dense_top=16, tail=cfg.raster_tail)
    depth, tri = _equal("shadow map", clip, state.mesh_indices, 1024, 1024,
                        levers)
    assert bool((tri == -1).all())
    assert torch.equal(mesh_lib.render_shadow_map(state, cfg), depth)


@pytest.mark.cuda
@pytest.mark.parametrize("want_ids", [True, False], ids=["ids", "depth"])
def test_b9_past_2_17_triangles_on_card(want_ids):
    """A synthetic mesh of 140,000 triangles, scattered over a 320 x 240
    screen: ids past 2^17 take the id pass over the depth winners (no
    dense pass), the depth-only raster its dense pass; on the far-like
    levers and on the default ladder."""
    dev = cuda_device()
    g = np.random.default_rng(2147483901)
    n = 140_000
    centre = g.uniform(-1.1, 1.1, (n, 1, 2))
    pts = centre + g.normal(0.0, 0.03, (n, 3, 2))
    z = g.uniform(0.05, 0.95, (n, 1, 1)) + g.normal(0.0, 0.01, (n, 3, 1))
    w = g.uniform(0.5, 2.0, (n, 3, 1))
    clip = np.concatenate([pts * w, z * w, w], -1).reshape(-1, 4)
    clip = torch.tensor(clip, dtype=torch.float32, device=dev)
    idx = torch.arange(3 * n, device=dev).reshape(n, 3)
    for name, levers in (
            ("tiers", dict(big_tiers=((2048, 8), (128, 24)), dense_top=16,
                           tail=(0.5, 2), want_ids=want_ids)),
            ("default", dict(want_ids=want_ids))):
        _depth, tri = _equal(f"{n} tris {name} ids={want_ids}", clip, idx,
                             320, 240, levers)
        if want_ids:
            assert int(tri.max()) >= 1 << 17


@pytest.mark.cuda
@pytest.mark.parametrize("eye", [(0.0, 6.0, 60.0), (14.0, 0.0, -30.0)],
                         ids=["far", "near"])
def test_b9_in_the_mesh_frame_on_card(eye, tmp_path):
    """A 1280x800 mesh frame on the far and the near ladder: B9 launches
    once and its plain version is not called; under impl="plain" it does
    not launch."""
    dev = cuda_device()
    eng = _engine(dev, 1280, 800, tmp_path / "torus.obj")
    preset = eng.select_raster_preset(eye)
    assert preset == ("far" if eye[2] > 0 else "near")
    cam = cam_lib.make_camera(list(eye), [0.0, 0.0, 0.0],
                              eng.config.aspect_ratio, device=dev)
    calls = []
    orig = mesh_lib.rasterize_plain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    mesh_lib.rasterize_plain = spy
    try:
        for impl in (None, "plain"):
            ops.reset_launches()
            frame_lib.render_frame(eng.state, cam, eng.config, impl=impl)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["raster"] == (1 if impl is None else 0)
            assert len(calls) == (0 if impl is None else 1)
    finally:
        mesh_lib.rasterize_plain = orig
