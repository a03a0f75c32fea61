"""The port's hand kernels against their plain PyTorch versions on the
card, and the dispatch rule on the CPU.

The card tests are marked `cuda` and skip without a CUDA device. This file
imports neither JAX nor the JAX package's renderer, so on the machine with
the card it runs without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch
from torch_parity import (clone_state, cuda_device, image_stats,
                          taa_operands, write_test_mesh)
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.ops import composite as composite_ops
from multivolumes_tpu_torch.ops import lightsweep as light_ops
from multivolumes_tpu_torch.ops import raster_bin
from multivolumes_tpu_torch.ops import sweep as sweep_ops
from multivolumes_tpu_torch.ops import taa as taa_ops
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import sweep as sweep_lib
from multivolumes_tpu_torch.render import tilecast
from multivolumes_tpu_torch.scene import state as state_lib
from multivolumes_tpu_torch.tools.raster_bin_microbench import eval_inputs

SMALL = RenderConfig(width=160, height=96, grid_size=16, light_grid_size=8,
                     max_ray_samples=24, max_light_samples=8, num_volumes=10,
                     num_volume_srcs=2, cube_map_size=32)
# the kernels of a frame without the opaque mesh
NO_MESH = ("sweep", "composite", "light_self_scan", "light_advect_mul", "taa")


def _scan_case(device, c=4, l=24, seed=0):
    rng = np.random.RandomState(seed)
    arrs = (rng.rand(c, l, l, l), rng.uniform(-1.5, 1.5, c),
            rng.uniform(-1.5, 1.5, c), rng.uniform(0.3, 2.0, c),
            rng.rand(c, l, l))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in arrs)


def _b1_case(device, dtype, seed=0, n_src=2, d=12, dl=8, s=16):
    rng = np.random.RandomState(seed)
    vols = torch.tensor(rng.rand(n_src, d, d, d, 4), dtype=dtype)
    light = torch.tensor(rng.rand(4, dl, dl, dl, 4), dtype=dtype)
    light[..., 3] = 0
    eye_local = torch.tensor([[0.3, -0.4, -2.5], [0.2, 0.1, 0.3],
                              [1.7, 1.1, 0.4]])
    n_eff = torch.tensor([s, s // 2, s], dtype=torch.float32)
    eye_faces = sweep_lib.eye_to_face_frames(eye_local)
    u = (torch.arange(s)[None] + 0.5) / n_eff[:, None] * 2.0 - 1.0
    u6 = u.repeat_interleave(6, dim=0)
    p = sweep_lib.face_ray_params(eye_faces.reshape(-1, 3), u6, -u6)
    params = sweep_lib.SweepParams(*(x.reshape(3, 6, s, s) for x in p))
    run = torch.ones((3, 6), dtype=torch.bool)
    run[0, 3] = False
    args = (vols, light, torch.tensor([1, 0, 1]), eye_faces, params,
            torch.tensor([12, 30, 24], dtype=torch.int32), run, s, s)

    def to(x):
        if isinstance(x, sweep_lib.SweepParams):
            return sweep_lib.SweepParams(*(y.to(device) for y in x))
        return x.to(device) if isinstance(x, torch.Tensor) else x

    kw = dict(n_eff_b=n_eff, light_ids=torch.tensor([2, 0, 3]))
    return ([to(a) for a in args], {k: to(v) for k, v in kw.items()})


def test_dispatch_rule_on_cpu():
    rho, du, dv, f, _t = _scan_case("cpu", c=1, l=6)
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        light_ops.light_self_scan(rho, du, dv, f, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        light_ops.light_self_scan(rho, du, dv, f, impl="fast")
    a = light_ops.light_self_scan(rho, du, dv, f)
    b = light_ops.light_self_scan(rho, du, dv, f, impl="plain")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sm = _sm_case("cpu", 1, 6)
    with pytest.raises(ValueError, match="CUDA"):
        light_ops.light_self_scan(rho, du, dv, f, *sm, impl="kernel")
    with pytest.raises(ValueError, match="together"):
        light_ops.light_self_scan(rho, du, dv, f, sm_vol=sm[0])
    a = light_ops.light_self_scan(rho, du, dv, f, *sm)
    assert not torch.equal(a[0], b[0])   # the shadow term took effect
    # plain versions are not kernel launches
    assert all(v == 0 for v in ops.LAUNCHES.values())
    args, kw = _b1_case("cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        sweep_ops.sweep_march(*args, **kw, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        taa_ops.taa_resolve(*taa_operands("cpu", 8, 8), impl="kernel")
    cur, hist, blur = taa_operands("cpu", 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        taa_ops.taa_resolve_band(cur, hist[:, 1:-1], blur[1:-1],
                                 impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        raster_bin.raster_bin_eval(*eval_inputs(2, 2, "cpu"), 2,
                                   impl="kernel")
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.cuda
def test_b5_kernel_matches_plain_on_card():
    dev = cuda_device()
    for h, w in ((72, 200), (52, 100), (800, 1280)):
        cur, hist, blur = taa_operands(dev, h, w)
        out_k, img_k = taa_ops.taa_resolve(cur, hist, blur, tonemap=True,
                                           impl="kernel")
        out_p, img_p = taa_ops.taa_resolve(cur, hist, blur, tonemap=True,
                                           impl="plain")
        torch.testing.assert_close(out_k, out_p, atol=2e-5, rtol=0)
        torch.testing.assert_close(img_k, img_p, atol=2e-5, rtol=0)
        torch.testing.assert_close(
            taa_ops.taa_resolve(cur, hist, blur, impl="kernel"), out_k,
            atol=0, rtol=0)


@pytest.mark.cuda
def test_b5_band_kernel_matches_plain_on_card():
    """B5': a band with its halo rows equals the plain version, and the
    bands of a mesh's rows equal B5 on the whole image bit for bit."""
    from multivolumes_tpu_torch.parallel import sharding

    dev = cuda_device()
    for h, w, rows in ((72, 200, 3), (50, 100, 2), (800, 1280, 2)):
        cur, hist, blur = taa_operands(dev, h, w)
        whole = taa_ops.taa_resolve(cur, hist, blur, impl="kernel")
        mesh = sharding.make_mesh([dev] * rows, rows=rows)
        ops.reset_launches()
        got = taa_ops.taa_resolve_sharded(mesh, cur, hist, blur,
                                          impl="kernel")
        assert ops.LAUNCHES["taa_band"] == rows
        torch.testing.assert_close(got, whole, atol=0, rtol=0)
        torch.testing.assert_close(
            got, taa_ops.taa_resolve_sharded(mesh, cur, hist, blur,
                                             impl="plain"),
            atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_b6_kernel_matches_plain_on_card():
    dev = cuda_device()
    for n_c, n_t in ((8, 3), (600, 150)):
        operands = eval_inputs(n_c, n_t, dev)
        ops.reset_launches()
        got = raster_bin.raster_bin_eval(*operands, n_t, impl="kernel")
        assert ops.LAUNCHES["raster_bin_eval"] == 1
        want = raster_bin.raster_bin_eval(*operands, n_t, impl="plain")
        assert torch.equal(got, want)
        assert int((got != raster_bin.EMPTY).sum()) > 0


# cohort sizes x light grid sides of the self scan: one volume (the frame's
# refresh, a cluster of 8 CTAs at L = 96), a few, and a full refresh of 64
# (clusters of 2); L = 20 is one CTA per volume
SCAN_SHAPES = [(c, l) for l in (96, 20) for c in (1, 5, 64)]


@pytest.mark.cuda
def test_b3_b4_kernels_match_plain_on_card():
    dev = cuda_device()
    for c, l in SCAN_SHAPES:
        rho, du, dv, f, t_in = _scan_case(dev, c=c, l=l)
        ops.reset_launches()
        here_k, sout_k = light_ops.light_self_scan(rho, du, dv, f,
                                                   impl="kernel")
        assert ops.LAUNCHES["light_self_scan"] == 1
        here_p, sout_p = light_ops.light_self_scan(rho, du, dv, f,
                                                   impl="plain")
        torch.testing.assert_close(here_k, here_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(sout_k, sout_p, atol=1e-5, rtol=0)
    for c, l in ((1, 96), (4, 24)):
        rho, du, dv, f, t_in = _scan_case(dev, c=c, l=l)
        here_p, _ = light_ops.light_self_scan(rho, du, dv, f, impl="plain")
        torch.testing.assert_close(
            light_ops.light_advect_mul(here_p, t_in, du, dv, impl="kernel"),
            light_ops.light_advect_mul(here_p, t_in, du, dv, impl="plain"),
            atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_b4_kernel_matches_plain_on_card():
    """B4 is the banded scan with the carry started from t_in: cohorts of 1
    (the frame's refresh), 8 and 64 (the full refresh) at L = 96 (clusters
    of 8 and 2 CTAs, bulk stores) and L = 20 (one CTA, direct stores),
    with a t_in that varies over the plane, so that a kernel which started
    its carry from 1, or from another band's rows, would fail."""
    dev = cuda_device()
    assert light_ops.scan_launch_info(1, 96, advect=True)["cluster"] == 8
    assert light_ops.scan_launch_info(64, 96, advect=True)["cluster"] == 2
    for c, l in [(c, l) for l in (96, 20) for c in (1, 8, 64)]:
        rho, du, dv, f, t_in = _scan_case(dev, c=c, l=l, seed=c + l)
        t_in = 0.2 + 0.8 * t_in
        here, _ = light_ops.light_self_scan(rho, du, dv, f, impl="plain")
        ops.reset_launches()
        got = light_ops.light_advect_mul(here, t_in, du, dv, impl="kernel")
        assert ops.LAUNCHES["light_advect_mul"] == 1
        want = light_ops.light_advect_mul(here, t_in, du, dv, impl="plain")
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        flat = light_ops.light_advect_mul(
            here, torch.full_like(t_in, float(t_in.mean())), du, dv,
            impl="plain")
        assert float((flat - want).abs().max()) > 1e-3


@pytest.mark.cuda
def test_b3_cluster_plan_on_card():
    """The scan's launch shape follows the cohort: a cluster of 8 CTAs for
    one 96^3 volume, of 2 for 64 of them, one CTA for a 20^3 volume; a
    side that is no multiple of 4 (no bulk stores) and a ragged last band
    (L = 100 on 8 bands of 13 rows) still match the plain version."""
    dev = cuda_device()
    assert light_ops.scan_launch_info(1, 96)["cluster"] == 8
    assert light_ops.scan_launch_info(1, 96, True)["cluster"] == 8
    assert light_ops.scan_launch_info(64, 96, True)["cluster"] == 2
    assert light_ops.scan_launch_info(1, 20)["cluster"] == 1
    for c, l in ((2, 100), (3, 34), (2, 10)):
        rho, du, dv, f, _t = _scan_case(dev, c=c, l=l)
        sm = _sm_case(dev, c, l)
        for extra in ((), sm):
            got = light_ops.light_self_scan(rho, du, dv, f, *extra,
                                            impl="kernel")
            want = light_ops.light_self_scan(rho, du, dv, f, *extra,
                                             impl="plain")
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def _sm_case(device, c, l, seed=1):
    """Shadow-map operands with a penumbra: the compared planes differ by
    less than a few slices of depth."""
    rng = np.random.RandomState(seed)
    sm = 0.4 + 0.05 * rng.rand(c, l, l)
    z = 0.4 + 0.05 * rng.rand(c, l, l)
    dz = rng.uniform(2e-4, 1e-3, c) * np.where(rng.rand(c) < 0.5, -1, 1)
    arrs = (sm, z, dz, np.maximum(np.abs(dz), 1e-6))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in arrs)


@pytest.mark.cuda
def test_b3_shadow_map_kernel_matches_plain_on_card():
    dev = cuda_device()
    for c, l in SCAN_SHAPES:
        rho, du, dv, f, _t = _scan_case(dev, c=c, l=l)
        sm = _sm_case(dev, c, l)
        ops.reset_launches()
        here_k, sout_k = light_ops.light_self_scan(rho, du, dv, f, *sm,
                                                   impl="kernel")
        assert ops.LAUNCHES["light_self_scan_sm"] == 1
        here_p, sout_p = light_ops.light_self_scan(rho, du, dv, f, *sm,
                                                   impl="plain")
        lit = here_p / torch.clamp(
            light_ops.light_self_scan(rho, du, dv, f, impl="plain")[0],
            min=1e-30)
        assert bool(((lit > 0.01) & (lit < 0.99)).any())  # a penumbra
        torch.testing.assert_close(here_k, here_p, atol=1e-5, rtol=0)
        torch.testing.assert_close(sout_k, sout_p, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_b2_depth_kernel_matches_plain_on_card(tmp_path):
    """B2's depth variant on the operands of a frame with the mesh, on a
    screen whose tiles mix mesh and non-mesh pixels; its band launch."""
    dev = cuda_device()
    cfg = SMALL.with_(shadow_map_size=64, width=320, height=200)
    eng = MultiRayCaster(cfg, device=dev)
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 2000))
    cam = cam_lib.make_camera([10.0, -4.0, -35.0], [0.0, -2.0, 5.0],
                              cfg.aspect_ratio, device=dev)
    captured = {}
    orig = tilecast.tile_composite

    def spy(*a, **k):
        captured.setdefault("args", (a, k))
        return orig(*a, **k)

    tilecast.tile_composite = spy
    try:
        frame_lib.render_frame(eng.state, cam, eng.config, impl="plain")
    finally:
        tilecast.tile_composite = orig
    a, k = captured["args"]
    k = {key: v for key, v in k.items() if key != "impl"}
    assert k["depth_sel"] is not None
    # the screen's tiles mix: some hold a mesh pixel, some do not
    on = composite_ops.mesh_tiles(a[1], a[6], a[7])
    assert bool(on.any()) and not bool(on.all()), on
    ops.reset_launches()
    got = orig(*a, **k, impl="kernel")
    assert ops.LAUNCHES["composite_depth"] == 1
    want = orig(*a, **k, impl="plain")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # the depth weights move some pixels (a kernel that skipped them fails)
    plain_warp = orig(*a, **dict(k, depth_sel=None), impl="kernel")
    assert float((got - plain_warp).abs().max()) > 1e-3
    # a band of tile rows equals the unbanded launch bit for bit
    (color, scene, tlist, counts, vol_flt, face_flt, th, tw, tiles_x, kl,
     width, height) = a
    r0 = scene.shape[0] // th // 2
    band = orig(color, scene[r0 * th:], tlist[r0 * tiles_x:],
                counts[r0 * tiles_x:], vol_flt, face_flt, th, tw, tiles_x,
                kl, width, height, depth_sel=k["depth_sel"], tile_row0=r0,
                impl="kernel")
    assert ops.LAUNCHES["composite_depth_band"] == 1
    torch.testing.assert_close(band, got[:, r0 * th:], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("with_zmax", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_kernel_matches_plain_on_card(dtype, with_zmax):
    """Eyes outside, inside and grazing the cube, a volume at n_eff < S
    whose rays beyond the corner stay active, a face that does not run,
    with and without the transparent-slab skip; in bf16 the faces stage
    their slabs in shared memory at this size, in f32 they march by the
    direct fetch."""
    dev = cuda_device()
    args, kw = _b1_case(dev, dtype)
    zmax = state_lib.slab_density_max(args[0]) if with_zmax else None
    info = sweep_ops.sweep_launch_info(args[8], args[7], args[0].shape[1],
                                       args[1].shape[1],
                                       dtype == torch.bfloat16)
    assert info["stages"] == int(dtype == torch.bfloat16), info
    ops.reset_launches()
    got = sweep_ops.sweep_march(*args, **kw, vol_zmax=zmax, impl="kernel")
    assert ops.LAUNCHES["sweep"] == 1
    want = sweep_ops.sweep_march(*args, **kw, impl="plain")
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-2)
    rays = sweep_ops.sweep_march_rays_plain(*args, **kw)
    torch.testing.assert_close(got, rays, atol=2e-3, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("use_bf16", [False, True])
def test_b1_whole_bucket_on_card(use_bf16):
    """B1 on the whole buckets of a frame (8 volumes at S = 64, which
    stage in bf16, and 24 at S = 32, which march by the direct fetch): the
    march's
    interval and density tests are discontinuous, so the texels beyond
    atol 2e-3 + rtol 2e-2 are counted, at most 1e-5 of them and each
    within 5e-2."""
    dev = cuda_device()
    cfg = RenderConfig(width=640, height=400, grid_size=64,
                       light_grid_size=48, max_ray_samples=128,
                       max_light_samples=48, num_volumes=32,
                       num_volume_srcs=4, cube_map_size=64,
                       use_bf16=use_bf16)
    st = state_lib.create_scene(cfg, dev)
    cam = cam_lib.orbit_camera(0.3, cfg.aspect_ratio, device=dev)
    calls = []
    orig = sweep_lib.sweep_march

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    sweep_lib.sweep_march = spy
    try:
        frame_lib.render_frame(st, cam, cfg, impl="kernel")
    finally:
        sweep_lib.sweep_march = orig
    assert [a[8] for a, _k in calls] == [64, 32], [a[8] for a, _k in calls]
    for a, k in calls:
        k = {key: v for key, v in k.items() if key != "impl"}
        got = orig(*a, **k, impl="kernel")
        want = orig(*a, **k, impl="plain")
        assert float(want.abs().max()) > 0.05
        err = (got - want).abs()
        bad = err > 2e-3 + 2e-2 * want.abs()
        assert int(bad.sum()) <= 1e-5 * bad.numel(), int(bad.sum())
        assert not bool(bad.any()) or float(err[bad].max()) <= 5e-2


@pytest.mark.cuda
def test_b2_kernel_matches_plain_on_card():
    dev = cuda_device()
    st = state_lib.create_scene(SMALL, dev)
    cam = cam_lib.orbit_camera(0.3, SMALL.aspect_ratio, device=dev)
    captured = {}
    orig = tilecast.tile_composite

    def spy(*a, **k):
        captured.setdefault("args", (a, k))
        return orig(*a, **k)

    tilecast.tile_composite = spy
    try:
        frame_lib.render_frame(st, cam, SMALL, impl="plain")
    finally:
        tilecast.tile_composite = orig
    a, k = captured["args"]
    k = {key: v for key, v in k.items() if key != "impl"}
    got = orig(*a, **k, impl="kernel")
    want = orig(*a, **k, impl="plain")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # a band of tile rows (`tile_row0`): the lower tile row of two
    (color, scene, tlist, counts, vol_flt, face_flt, th, tw, tiles_x, kl,
     width, height) = a
    assert scene.shape[0] == 2 * th
    ops.reset_launches()
    band = orig(color, scene[th:], tlist[tiles_x:], counts[tiles_x:],
                vol_flt, face_flt, th, tw, tiles_x, kl, width, height,
                tile_row0=1, impl="kernel")
    assert ops.LAUNCHES["composite_band"] == 1
    torch.testing.assert_close(band, got[:, th:], atol=0, rtol=0)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_b2_plain_ndc_is_correctly_rounded(device, monkeypatch):
    """B2's plain version takes each pixel's NDC from `pixel_ndc`, whose
    division (x + 0.5) / size is the correctly rounded f32 quotient, as
    the kernel's, in every column of a 1280-wide and every row of an
    800-high screen. Divided by a host scalar, PyTorch on the card
    multiplies by its reciprocal instead, one ulp off in 256 of the 1280
    columns. The quotient is taken in f64 and rounded once to f32, which
    is the correctly rounded f32 quotient (53 >= 2 * 24 + 2 bits)."""
    dev = cuda_device() if device == "cuda" else torch.device(device)
    for size in (1280, 800):
        idx = torch.arange(size, device=dev)
        q = ((np.arange(size) + 0.5) / size).astype(np.float32)
        want = torch.from_numpy(q * np.float32(2.0) - np.float32(1.0))
        got = composite_ops.pixel_ndc(idx, size).cpu()
        assert got.dtype == torch.float32
        differ = got != want
        assert not bool(differ.any()), (
            f"{int(differ.sum())} of {size} NDC values differ")
    # the plain version's x and y NDC both come from pixel_ndc
    sizes = []
    orig = composite_ops.pixel_ndc
    monkeypatch.setattr(composite_ops, "pixel_ndc", lambda i, s, *a: (
        sizes.append(s), orig(i, s, *a))[1])
    st = state_lib.create_scene(SMALL, dev)
    frame_lib.render_frame(st, cam_lib.orbit_camera(
        0.3, SMALL.aspect_ratio, device=dev), SMALL, impl="plain")
    assert sizes == [SMALL.width, SMALL.height]


@pytest.mark.cuda
@pytest.mark.parametrize("use_bf16", [False, True])
def test_frame_kernels_match_plain_on_card(use_bf16):
    dev = cuda_device()
    cfg = SMALL.with_(use_bf16=use_bf16)
    st = state_lib.create_scene(cfg, dev)
    cam = cam_lib.orbit_camera(0.3, cfg.aspect_ratio, device=dev)
    copy = clone_state(st)
    ops.reset_launches()
    img_k = frame_lib.render_frame(st, cam, cfg, impl="kernel").image
    assert all(ops.LAUNCHES[k] > 0 for k in NO_MESH), ops.LAUNCHES
    img_p = frame_lib.render_frame(copy, cam, cfg, impl="plain").image
    mean, p999, mx = image_stats(img_k, img_p, 99.9)
    assert mean < 2e-3 and p999 < 3e-2, (mean, p999, mx)
