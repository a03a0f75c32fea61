"""B8, the mesh layer's deferred shade (`ops/mesh_shade.py`, called by
`render/mesh.py:deferred_shade`), against its plain version.

On the CPU: the dispatch rule, a CPU mesh frame that launches nothing,
and the plain route against the shade `render_mesh` and
`render_mesh_sharded` ran inline before B8 (the `_shader` closure on the
rectangle's pixels, pasted into the screen for a window), bit for bit:
the full screen, a window, a window clipped at a screen edge, a row band
and a band's rows of the window, with and without the light probe. On
the card (marked `cuda`, skipped without one): the kernel against the
plain version at 1280x800 with the 384 window, 2560x1440 and 1283x803
full screen, a window clipped at the edge, without the light probe and
on the pieces of 2 row bands, every colour and velocity element within
1e-4 + 1e-4 relative and `valid` equal; and a mesh frame's launches.
This file imports neither JAX nor the JAX package, so on the machine with
the card

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_shade.py -q
"""

import pytest
import torch
from torch_parity import cuda_device, write_test_mesh
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.ops import mesh_shade as shade_ops
from multivolumes_tpu_torch.ops.mesh_shade import Span
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import mesh as mesh_lib

W, H, WIN = 96, 64, 32          # the CPU screen and its shade window


def _scene(dev, width, height, n_tris, probe, path, win=384,
           eye=(6.0, -2.0, -22.0), focus=(0.0, -7.0, 0.0)):
    """(engine state, camera, config, frame operands, tri_id) of the test
    torus at the demo placement, seen from `eye`, rasterized on the near
    ladder; the config's shade window is `win`."""
    cfg = RenderConfig(width=width, height=height, grid_size=16,
                       light_grid_size=8, max_ray_samples=16,
                       max_light_samples=8, num_volumes=4, num_volume_srcs=2,
                       cube_map_size=32, shadow_map_size=256,
                       has_light_probe=probe)
    eng = MultiRayCaster(cfg, device=dev)
    eng.set_mesh(write_test_mesh(path, n_tris))
    cfg = eng.config.with_(mesh_shade_window=win)
    cam = cam_lib.make_camera(list(eye), list(focus), cfg.aspect_ratio,
                              device=dev)
    op = mesh_lib._frame_operands(eng.state, cam, cfg)
    _depth, tri = mesh_lib.rasterize(op.clip_jit, eng.state.mesh_indices,
                                     width, height, **op.raster_kw)
    return eng.state, cam, cfg, op, tri


@pytest.fixture(scope="module", params=[True, False], ids=["probe",
                                                           "no-probe"])
def cpu_scene(request, tmp_path_factory):
    return _scene("cpu", W, H, 600, request.param,
                  tmp_path_factory.mktemp("mesh") / "torus.obj", win=WIN)


def _edge_op(op, height):
    """The frame operands with the mesh's screen centre moved below the
    screen, so the window is clipped at its lower edge and still holds
    the lower part of the mesh."""
    return op._replace(center=(op.center[0], op.center[1] * 0
                               + (height + 9.0)))


def _old_window(op, cfg, dev):
    """(ys, xs) of the shade window, as the mesh pass found them before
    B8."""
    win = cfg.mesh_shade_window
    return (mesh_lib.window_index(op.center[1], win, cfg.height, dev),
            mesh_lib.window_index(op.center[0], win, cfg.width, dev))


def _old_paste(shaded, ys, xs, height, width, dev):
    """The window's ((r, g, b), (vx, vy), valid) pasted into the screen
    field by field, as the mesh pass did before B8."""
    def paste(field, dtype=torch.float32):
        out = torch.zeros((height, width), dtype=dtype, device=dev)
        out[ys[:, None], xs[None, :]] = field
        return out

    col, vel, valid = shaded
    return (tuple(paste(c) for c in col), tuple(paste(c) for c in vel),
            paste(valid, torch.bool))


def _old_shade(state, cam, cfg, op, tri, case):
    """The deferred shade as `render_mesh` / `render_mesh_sharded` ran it
    before B8 -> ((r, g, b), (vx, vy), valid)."""
    dev = tri.device
    height, width = cfg.height, cfg.width
    shade = mesh_lib._shader(state, cam, cfg, op)
    if case == "full":
        return shade(tri, torch.arange(width, device=dev),
                     torch.arange(height, device=dev))
    if case in ("window", "window-edge"):
        ys, xs = _old_window(op, cfg, dev)
        return _old_paste(shade(tri[ys[:, None], xs[None, :]], xs, ys),
                          ys, xs, height, width, dev)
    if case[0] == "band":
        # a row band of the full-screen shade, from the band's own ids
        _, r, rows = case
        out_h = height // rows
        return shade(tri[r * out_h:(r + 1) * out_h],
                     torch.arange(width, device=dev),
                     r * out_h + torch.arange(out_h, device=dev))
    # a band's rows of the window
    r, rows = case
    wb = cfg.mesh_shade_window // rows
    ys, xs = _old_window(op, cfg, dev)
    ys = ys[r * wb:(r + 1) * wb]
    return shade(tri[ys[:, None], xs[None, :]], xs, ys)


def _new_shade(state, cam, cfg, op, tri, case, impl):
    """The same rectangle through `deferred_shade` (B8 on the card) ->
    (fields, valid)."""
    height, width, win = cfg.height, cfg.width, cfg.mesh_shade_window
    cx, cy = op.center
    if case == "full":
        return mesh_lib.deferred_shade(state, cam, cfg, op, tri,
                                       Span(0, height), Span(0, width),
                                       impl=impl)
    if case in ("window", "window-edge"):
        return mesh_lib.deferred_shade(state, cam, cfg, op, tri,
                                       Span(0, win, cy), Span(0, win, cx),
                                       paste=True, impl=impl)
    if case[0] == "band":
        _, r, rows = case
        out_h = height // rows
        return mesh_lib.deferred_shade(
            state, cam, cfg, op, tri[r * out_h:(r + 1) * out_h],
            Span(r * out_h, out_h), Span(0, width), tri_row0=r * out_h,
            impl=impl)
    r, rows = case
    wb = win // rows
    return mesh_lib.deferred_shade(state, cam, cfg, op, tri,
                                   Span(r * wb, wb, cy), Span(0, win, cx),
                                   impl=impl)


def test_mesh_shade_dispatch_rule_on_cpu(cpu_scene):
    state, cam, cfg, op, tri = cpu_scene
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        _new_shade(state, cam, cfg, op, tri, "full", "kernel")
    with pytest.raises(ValueError, match="impl"):
        _new_shade(state, cam, cfg, op, tri, "full", "fast")
    a = _new_shade(state, cam, cfg, op, tri, "window", None)
    b = _new_shade(state, cam, cfg, op, tri, "window", "plain")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the kernel wrapper itself takes CUDA tensors alone
    with pytest.raises(ValueError, match="CUDA"):
        shade_ops.mesh_shade(
            tri, Span(0, cfg.height), Span(0, cfg.width), op.clip_jit,
            state.mesh_verts, state.mesh_indices, state.mesh_world, op.s_vp,
            op.wvp, state.mesh_prev_wvp, cam.eye, state.light_pos,
            state.light_color, state.ambient, state.sh_coeffs,
            state.mesh_shadow_map, height=cfg.height, width=cfg.width,
            window=cfg.mesh_shade_window,
            has_light_probe=cfg.has_light_probe)
    assert ops.LAUNCHES["mesh_shade"] == 0


CASES = ["full", "window", "window-edge", ("band", 0, 2), ("band", 1, 2),
         (0, 2), (1, 2)]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_route_is_the_old_shade(cpu_scene, case):
    """`deferred_shade`'s plain route gives, bit for bit, the fields the mesh
    pass computed inline before B8: colour and velocity stacked in one
    (5, h, w) buffer, valid beside it; each case holds mesh pixels and
    empty ones."""
    state, cam, cfg, op, tri = cpu_scene
    if case == "window-edge":
        op = _edge_op(op, cfg.height)
        ys, _xs = _old_window(op, cfg, "cpu")
        assert int(ys[-1]) == cfg.height - 1
    col, vel, valid = _old_shade(state, cam, cfg, op, tri, case)
    fields, got_valid = _new_shade(state, cam, cfg, op, tri, case, None)
    assert fields.dtype == torch.float32 and got_valid.dtype == torch.bool
    assert torch.equal(got_valid, valid)
    assert torch.equal(fields, torch.stack(col + vel))
    assert bool(valid.any()) and not bool(valid.all())


@pytest.mark.parametrize("preset", ["near", "far"])
def test_render_mesh_shades_as_before(cpu_scene, preset):
    """`render_mesh` end to end: the full-screen shade on the near preset,
    the pasted window under the far preset with a window that fits;
    colour, velocity and valid as the old inline shade gave them, views
    of one (5, H, W) buffer."""
    state, cam, cfg, _op, _tri = cpu_scene
    if preset == "far":
        cfg = cfg.with_(raster_preset="far", raster_far_tiers=((64, 8),),
                        raster_far_small=None, raster_far_bound=20)
        assert mesh_lib._shade_window(cfg) == WIN
    else:
        assert mesh_lib._shade_window(cfg) == 0
    seen = {}
    orig = mesh_lib.rasterize

    def spy(*a, **k):
        seen["out"] = orig(*a, **k)
        return seen["out"]

    mesh_lib.rasterize = spy
    try:
        out = mesh_lib.render_mesh(state, cam, cfg)
    finally:
        mesh_lib.rasterize = orig
    op = mesh_lib._frame_operands(state, cam, cfg)
    col, vel, valid = _old_shade(state, cam, cfg, op, seen["out"][1],
                                 "window" if preset == "far" else "full")
    assert torch.equal(out.valid, valid)
    for got, want in zip(out.color + out.velocity, col + vel):
        assert got.shape == (cfg.height, cfg.width)
        assert torch.equal(got, want)
    assert out.color[0].untyped_storage().data_ptr() == \
        out.velocity[1].untyped_storage().data_ptr()


def test_cpu_mesh_frame_launches_no_mesh_shade(tmp_path):
    cfg = RenderConfig(width=W, height=H, grid_size=16, light_grid_size=8,
                       max_ray_samples=16, max_light_samples=8, num_volumes=4,
                       num_volume_srcs=2, cube_map_size=32,
                       shadow_map_size=64)
    eng = MultiRayCaster(cfg, device="cpu")
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 500))
    cam = cam_lib.orbit_camera(0.3, cfg.aspect_ratio, device="cpu")
    calls = []
    orig = mesh_lib.shade_plain

    def spy(*a, **k):
        calls.append(a[4].shape)
        return orig(*a, **k)

    mesh_lib.shade_plain = spy
    try:
        ops.reset_launches()
        frame_lib.render_frame(eng.state, cam, eng.config)
    finally:
        mesh_lib.shade_plain = orig
    assert calls == [(H, W)]
    assert all(v == 0 for v in ops.LAUNCHES.values())


# --- on the card ------------------------------------------------------------

REL = ATOL = 1e-4
# (width, height, rectangle, light probe, camera eye): the demo's window
# at 1280x800 from the orbit's first pose, 2560x1440 and an odd size full
# screen from closer, a window clipped at the screen's corner
CARD_CASES = {
    "1280x800-window": (1280, 800, "window", True, (0.0, 6.0, 60.0)),
    "1280x800-window-no-probe": (1280, 800, "window", False,
                                 (0.0, 6.0, 60.0)),
    "2560x1440-full": (2560, 1440, "full", True, (14.0, 0.0, -30.0)),
    "1283x803-full": (1283, 803, "full", True, (14.0, 0.0, -30.0)),
    "1283x803-window-edge": (1283, 803, "window-edge", True,
                             (14.0, 0.0, -30.0)),
    "1280x800-bands": (1280, 800, "bands", True, (14.0, 0.0, -30.0)),
}


def _held(name, got, want):
    """B8's (fields, valid) against the plain version's: valid equal,
    every element within ATOL + REL relative; prints the elements that
    differ at all -> their count."""
    (gf, gv), (wf, wv) = got, want
    assert torch.equal(gv, wv), (name, int((gv != wv).sum()))
    diff = (gf - wf).abs()
    n = int((diff > 0).sum())
    worst = float(diff.max())
    beyond = int((diff > ATOL + REL * wf.abs()).sum())
    print(f"{name}: {n} of {gf.numel()} elements differ, max abs "
          f"{worst:.3e}, {beyond} beyond {ATOL} + {REL} rel; "
          f"{int(gv.sum())} mesh pixels")
    assert bool(torch.isfinite(gf).all())
    assert beyond == 0, (name, beyond, worst)
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_b8_matches_plain_on_card(case, tmp_path):
    dev = cuda_device()
    width, height, rect, probe, eye = CARD_CASES[case]
    state, cam, cfg, op, tri = _scene(
        dev, width, height, 69960, probe, tmp_path / "torus.obj", eye=eye,
        focus=(0.0, -7.0, 0.0) if eye[2] < 0 else (0.0, 0.0, 0.0))
    assert bool((tri >= 0).any()) and bool((tri < 0).any())
    shadow = state.mesh_shadow_map
    assert bool((shadow < 1.0).any())
    if rect == "window-edge":
        op = _edge_op(op, height)
    cases = ([("band", r, 2) for r in range(2)] + [(r, 2) for r in range(2)]
             if rect == "bands" else [rect])
    for c in cases:
        ops.reset_launches()
        got = _new_shade(state, cam, cfg, op, tri, c, "kernel")
        assert ops.LAUNCHES["mesh_shade"] == 1
        want = _new_shade(state, cam, cfg, op, tri, c, "plain")
        torch.cuda.synchronize()
        assert bool(want[1].any())
        _held(f"{case} {c}", got, want)
    if rect == "bands":
        # the two band pieces stacked are the full-screen launch
        full = _new_shade(state, cam, cfg, op, tri, "full", "kernel")
        bands = [_new_shade(state, cam, cfg, op, tri, ("band", r, 2),
                            "kernel") for r in range(2)]
        assert torch.equal(torch.cat([b[0] for b in bands], 1), full[0])
        assert torch.equal(torch.cat([b[1] for b in bands], 0), full[1])


@pytest.mark.cuda
@pytest.mark.parametrize("eye", [(0.0, 6.0, 60.0), (14.0, 0.0, -30.0)],
                         ids=["far", "near"])
def test_b8_in_the_mesh_frame_on_card(eye, tmp_path):
    """A 1280x800 mesh frame, on the far preset with its window and on
    the near one: B8 launches once (two kernels) and its plain version is
    not called; under impl="plain" it does not launch."""
    dev = cuda_device()
    cfg = RenderConfig(width=1280, height=800, grid_size=16,
                       light_grid_size=8, max_ray_samples=16,
                       max_light_samples=8, num_volumes=8, num_volume_srcs=2,
                       cube_map_size=32)
    eng = MultiRayCaster(cfg, device=dev)
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 69960))
    preset = eng.select_raster_preset(eye)
    assert preset == ("far" if eye[2] > 0 else "near")
    assert bool(mesh_lib._shade_window(eng.config)) == (preset == "far")
    cam = cam_lib.make_camera(list(eye), [0.0, 0.0, 0.0], cfg.aspect_ratio,
                              device=dev)
    calls = []
    orig = mesh_lib.shade_plain

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    mesh_lib.shade_plain = spy
    try:
        for impl in (None, "plain"):
            ops.reset_launches()
            frame_lib.render_frame(eng.state, cam, eng.config, impl=impl)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["mesh_shade"] == (1 if impl is None else 0)
            assert len(calls) == (0 if impl is None else 1)
    finally:
        mesh_lib.shade_plain = orig
