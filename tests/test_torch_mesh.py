"""The port's mesh pass against the JAX package, on a procedural closed
mesh (`torch_parity.write_test_mesh`, about 2k triangles) loaded through
both engines' `set_mesh`.

Tolerances, each with its source:
* raster (`rasterize`, `render_shadow_map`): depth within one 15-bit
  quantisation step (2^-15) wherever both cover, and the triangle ids
  (or coverage) equal on every pixel either covers (the measured share
  is 1.0 on both presets and on the shadow map, so the tests hold
  exactly that);
* `render_mesh`: colour and velocity at atol 1e-4 where the two rasters
  agree (same depth word);
* the scene-depth occlusion bound and the sweep with a depth map: B1's
  atol 2e-3, rtol 2e-2 (tests/test_pallas_sweep.py);
* B2's depth variant: mean < 3e-3, p99.5 < 3e-2 (tests/test_warp.py:
  172-173), against the Pallas kernel in interpret mode;
* B3's shadow-map variant: atol 1e-5 against the JAX twin and the Pallas
  kernel in interpret mode (tests/test_lightsweep.py:349-378); on the
  sweeps along x, y and z under lights whose shadow reaches the volumes,
  all but at most 2 shadow-boundary texels at 1e-5 and those within 5e-5
  (the JAX twin and the Pallas kernel differ from each other by up to
  1.3e-5 there: `lit` divides by a softness of about 1e-4, ROADMAP.md
  section C);
* the windowed TAA reprojection: atol 2e-5 (tests/test_pallas_taa.py);
* whole frames: the golden limits, mean < 2e-3 and p99.9 < 3e-2.

The JAX reference renders with `light_axis` baked (ROADMAP.md, section C).
The configuration is small (160 x 120, 4 volumes, shadow map 64) with a
far-preset bound of 80 px, at which the test mesh has a far ladder, and
shade / reprojection windows that cover the preset pick's hysteresis
ceiling (ceil(1.05 x 80) = 84 px, + 16 for the reprojection)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (image_stats, jax_state_dict, n, port_camera,
                          port_config, port_cull, port_per_object, t,
                          write_test_mesh)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.engine import MultiRayCaster as JaxEngine
from multivolumes_tpu.ops.pallas.composite_kernel import tile_composite_pallas
from multivolumes_tpu.render import cull as jcull
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu.render import lightsweep as jls
from multivolumes_tpu.render import mesh as jmesh
from multivolumes_tpu.render import sweep as jsw
from multivolumes_tpu.render import taa as jtaa
from multivolumes_tpu.render import tilecast as jtile
from multivolumes_tpu.render import warp as jwarp
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu_torch.ops import composite as pcomp_ops
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.render import lightsweep as pls
from multivolumes_tpu_torch.render import mesh as pmesh
from multivolumes_tpu_torch.render import sweep as psw
from multivolumes_tpu_torch.render import taa as ptaa
from multivolumes_tpu_torch.scene import state as pstate

CFG = RenderConfig(width=160, height=120, grid_size=16, light_grid_size=8,
                   max_ray_samples=24, max_light_samples=8, num_volumes=4,
                   num_volume_srcs=2, cube_map_size=32, shadow_map_size=64,
                   use_bf16=False, light_axis=2, raster_far_bound=80,
                   mesh_shade_window=96, taa_reproj_window=112)
ZSTEP = 2.0 ** -15
TIMES = (0.3, 0.32, 0.34)


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX engine with the test mesh: (config with the far ladder,
    state, mesh path)."""
    path = write_test_mesh(tmp_path_factory.mktemp("mesh") / "torus.obj",
                           2000)
    je = JaxEngine(CFG)
    je.set_mesh(path)
    assert je.config.raster_far_tiers, "the test mesh needs a far ladder"
    return je.config, je.state, path


def _far(cfg):
    return cfg.with_(raster_preset="far")


def _clip(st, cam):
    wvp = st.mesh_world @ cam.view_proj
    return np.asarray(jm.transform_point(st.mesh_verts[:, :3], wvp))


def _raster_kw(cfg, far: bool, t_count: int):
    dw = cfg.mesh_shade_window if far else None
    return dict(big_tiers=cfg.raster_far_tiers if far else jmesh.NEAR_TIERS,
                cull=1, capacity=t_count // 2, dense_top=16,
                tail=cfg.raster_tail,
                small_tiers=cfg.raster_far_small if far else None,
                dense_window=dw)


def _agreement(tj, tp):
    either = (tj >= 0) | (tp >= 0)
    return float((tj == tp)[either].mean()), int(either.sum())


@pytest.mark.parametrize("preset", ["near", "far"])
def test_rasterize_matches_jax(jax_mesh, preset):
    cfg, st, _ = jax_mesh
    cam = jcam.orbit_camera(0.3, cfg.aspect_ratio)
    clip = _clip(st, cam)
    idx = np.asarray(st.mesh_indices)
    kw = _raster_kw(cfg, preset == "far", idx.shape[0])
    dj, tj = jax.jit(lambda v: jmesh.rasterize(
        v, jnp.asarray(idx), cfg.width, cfg.height, **kw))(jnp.asarray(clip))
    dp, tp = pmesh.rasterize(t(clip), torch.from_numpy(idx.astype(np.int64)),
                             cfg.width, cfg.height, **kw)
    tj, tp = np.asarray(tj), tp.numpy()
    share, covered = _agreement(tj, tp)
    print(f"{preset}: tri_id agrees on {share:.6f} of {covered} pixels")
    assert covered > 200 and share == 1.0
    both = (tj >= 0) & (tp >= 0)
    assert np.abs(n(dp)[both] - n(dj)[both]).max() <= ZSTEP


def test_chip_smoke_writes_the_test_mesh(tmp_path):
    """chip_smoke.py keeps its own copy of the test-mesh writer (it
    imports nothing of the tests): both write the same file."""
    import chip_smoke

    a = write_test_mesh(tmp_path / "a.obj", 2000)
    b = chip_smoke.write_torus_obj(tmp_path / "b.obj", 2000)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


def _synthetic_cases():
    tri = ([[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0],
            [0.0, 0.6, 0.5, 1.0]], [[0, 1, 2]], 32, dict(k=32))
    depth = ([[-0.9, -0.9, 0.8, 1.0], [0.9, -0.9, 0.8, 1.0],
              [0.0, 0.9, 0.8, 1.0], [-0.9, -0.9, 0.3, 1.0],
              [0.9, -0.9, 0.3, 1.0], [0.0, 0.9, 0.3, 1.0]],
             [[0, 1, 2], [3, 4, 5]], 16, dict(k=16))
    quad = ([[-0.8, -0.8, 0.5, 1.0], [0.8, -0.8, 0.5, 1.0],
             [0.8, 0.8, 0.5, 1.0], [-0.8, 0.8, 0.5, 1.0]],
            [[0, 1, 2], [0, 2, 3]], 320, {})
    box = ([[-0.5, -0.5, 0.3, 1.0], [0.5, -0.5, 0.3, 1.0],
            [0.5, 0.5, 0.3, 1.0], [-0.5, 0.5, 0.3, 1.0],
            [-0.7, -0.7, 0.8, 1.0], [0.7, -0.7, 0.8, 1.0],
            [0.7, 0.7, 0.8, 1.0], [-0.7, 0.7, 0.8, 1.0]],
           [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7]], 160,
           dict(cull=1, capacity=3, dense_top=0))
    return {"single": tri, "depth_test": depth, "large_quad": quad,
            "cull_capacity": box}


@pytest.mark.parametrize("case", sorted(_synthetic_cases()))
def test_rasterize_synthetic_cases_match_jax(case):
    """The synthetic cases of tests/test_passes.py:63-228, equal."""
    verts, idx, size, kw = _synthetic_cases()[case]
    v = np.asarray(verts, np.float32)
    dj, tj = jmesh.rasterize(jnp.asarray(v), jnp.asarray(idx, jnp.int32),
                             size, size, **kw)
    dp, tp = pmesh.rasterize(t(v), torch.tensor(idx), size, size, **kw)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(n(dp), n(dj))
    assert (tp.numpy() >= 0).any()


def test_shadow_map_matches_jax(jax_mesh):
    cfg, st, _ = jax_mesh
    ps = pstate.state_from_numpy(jax_state_dict(st))
    got = pmesh.render_shadow_map(ps, port_config(cfg)).numpy()
    want = np.asarray(st.mesh_shadow_map)   # set_mesh's render_shadow_map
    cj, cp = want < 1.0, got < 1.0
    share = float((cj == cp)[cj | cp].mean())
    print(f"shadow map coverage agrees on {share:.6f} of {(cj | cp).sum()}")
    assert cj.sum() > 100 and share == 1.0
    both = cj & cp
    assert np.abs(got[both] - want[both]).max() <= ZSTEP
    np.testing.assert_allclose(n(pmesh.shadow_view_proj(ps)),
                               n(jmesh.shadow_view_proj(st)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("preset", ["near", "far"])
def test_render_mesh_matches_jax(jax_mesh, preset):
    """Full-screen shade (near) and the windowed dense pass + shade
    (far)."""
    cfg, st, _ = jax_mesh
    cfg = _far(cfg) if preset == "far" else cfg
    cam = jcam.orbit_camera(0.3, cfg.aspect_ratio)
    mj = jax.jit(lambda s, c: jmesh.render_mesh(s, c, cfg))(st, cam)
    ps = pstate.state_from_numpy(jax_state_dict(st))
    mp = pmesh.render_mesh(ps, port_camera(cam), port_config(cfg))
    vj, vp = np.asarray(mj.valid), mp.valid.numpy()
    share = float((vj == vp)[vj | vp].mean())
    assert vj.sum() > 200 and share >= 0.999, share
    same = vj & vp & (n(mp.depth) == np.asarray(mj.depth))
    assert same.sum() >= 0.99 * vj.sum()
    for got, want in zip(mp.color + mp.velocity, mj.color + mj.velocity):
        np.testing.assert_allclose(n(got)[same], np.asarray(want)[same],
                                   atol=1e-4)
    assert np.abs(np.asarray(mj.velocity[0])[same]).max() > 0  # moving
    for got, want in zip(mp.screen_center, mj.screen_center):
        assert abs(float(got) - float(want)) < 1e-3
    np.testing.assert_allclose(n(mp.new_prev_wvp), n(mj.new_prev_wvp),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def sweep_case(jax_mesh):
    """A mesh frame's JAX operands and its LOD sweep with the scene depth
    (cube maps 64, buckets of 1, 1 and 2 volumes: the quarter-, half- and
    full-resolution bounds), Pallas in interpret mode. The camera looks
    past the mesh at the volumes' lower halves, so the mesh occludes
    them."""
    cfg, st, _ = jax_mesh
    s = 64
    caps = (1, 1, 1 << 30)
    cam = jcam.make_camera(jnp.array([10.0, -4.0, -35.0]),
                           jnp.array([0.0, -2.0, 5.0]), cfg.aspect_ratio)
    po = jbpo(st.volume_worlds, cam.view_proj)
    cull = jcull.cull_volumes(po, cam.eye,
                              jnp.array([cfg.width, cfg.height], jnp.float32),
                              cfg.max_ray_samples, s, cfg.num_cube_mips)
    lod_cull = cull._replace(use_cube_map=cull.visible)
    basis = jwarp.screen_basis(jm.inverse(cam.view_proj), cam.eye)
    depth = jax.jit(lambda a, c: jmesh.render_mesh(a, c, cfg).depth)(st, cam)
    out = jax.jit(lambda a: jsw.ray_march_view_sweep_lod(
        a.volumes_oriented, a.vol_tex_ids, a.light_maps_oriented, po,
        lod_cull, cam.eye, depth, s, dtype=jnp.float32, bucket_caps=caps,
        pack=False, light_w=cfg.light_grid_size, vol_zmax=a.vol_zmax,
        sorted_output=True, swap_basis=basis))(st)
    return cfg, st, cam, po, lod_cull, basis, depth, s, caps, out


def test_occlusion_bound_matches_jax(sweep_case):
    cfg, st, cam, po, lod_cull, _b, depth, s, _c, _out = sweep_case
    eye_local = jm.transform_point3(cam.eye, po.world_i)
    n_eff = jnp.full((po.world.shape[0],), float(s // 2))
    sj, zj = jsw._occlusion_s_max(po, eye_local, None,
                                  jsw._pool2_max(depth), s // 2, n_eff)
    sp, zp = psw._occlusion_s_max(port_per_object(po), t(eye_local),
                                  psw._pool2_max(t(depth)), s // 2,
                                  t(n_eff))
    sj, sp = np.asarray(sj), n(sp)
    np.testing.assert_array_equal(n(zp), np.asarray(zj))
    finite = sj < 1e30
    np.testing.assert_array_equal(sp < 1e30, finite)
    assert 0 < finite.sum() < finite.size     # the mesh occludes some rays
    np.testing.assert_allclose(sp[finite], sj[finite], atol=2e-3, rtol=2e-2)
    for fn in ("_dilate3_max", "_pool2_max"):
        x = np.random.RandomState(0).rand(2, 6, 8, 8).astype(np.float32)
        arg = x if fn == "_dilate3_max" else x[0, 0]
        np.testing.assert_array_equal(n(getattr(psw, fn)(t(arg))),
                                      np.asarray(getattr(jsw, fn)(arg)))
    x = np.random.RandomState(1).rand(3, 4, 4).astype(np.float32)
    np.testing.assert_array_equal(
        n(psw._upsample2_nearest(t(x), 8)),
        np.asarray(jsw._upsample2_nearest(jnp.asarray(x), 8)))


def test_sweep_with_depth_map_matches_jax(sweep_case):
    cfg, st, cam, po, lod_cull, basis, depth, s, caps, out = sweep_case
    maps, mips, order, swap = out
    ps = pstate.state_from_numpy(jax_state_dict(st))
    got = psw.ray_march_view_sweep_lod(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep,
        port_per_object(po), port_cull(lod_cull), t(cam.eye), s, t(basis),
        bucket_caps=caps, vol_zmax=ps.vol_zmax, depth_map=t(depth))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(got.swap.numpy(), np.asarray(swap))
    np.testing.assert_allclose(n(got.cube_maps.color), n(maps.color),
                               atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(n(got.cube_maps.depth), n(maps.depth),
                               atol=2e-3, rtol=2e-2)
    # the bound cut rays: the same frame without the depth map differs
    free = psw.ray_march_view_sweep_lod(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep,
        port_per_object(po), port_cull(lod_cull), t(cam.eye), s, t(basis),
        bucket_caps=caps, vol_zmax=ps.vol_zmax)
    assert float((free.cube_maps.color - got.cube_maps.color).abs().max()) \
        > 1e-2


def test_b2_depth_plain_matches_pallas_interpret(sweep_case):
    """B2's depth variant (plain version) against the Pallas kernel's
    with_depth path on the JAX tile prep of a mesh frame."""
    cfg, st, cam, po, lod_cull, basis, depth, s, caps, out = sweep_case
    maps, mips, order, swap = out
    cull_c = lod_cull._replace(mip_level=mips)
    (jcolor, jdep, jscene, jtl, jcnt, jvol, jface, s_, th, tw, tiles_x,
     k) = jtile._tile_prep(maps, po, cull_c, cam.eye,
                           jm.inverse(cam.view_proj), depth, cfg.width,
                           cfg.height, num_layers=8, order=order,
                           swap_sorted=swap)
    assert jdep is not None
    want = tile_composite_pallas(jcolor, jscene, jtl, jcnt, jvol, jface,
                                 s=s_, th=th, tw=tw, tiles_x=tiles_x,
                                 k_layers=k, width=cfg.width,
                                 height=cfg.height, interpret=True,
                                 depth_sel=jdep)
    args = (t(jcolor)[..., :s_], t(jscene), torch.from_numpy(
        np.asarray(jtl)), torch.from_numpy(np.asarray(jcnt)), t(jvol),
        t(jface), th, tw, tiles_x, k, cfg.width, cfg.height)
    got = pcomp_ops.tile_composite(*args, depth_sel=t(jdep)[..., :s_])
    plain = pcomp_ops.tile_composite(*args)
    h, w = cfg.height, cfg.width
    mesh_tiles = pcomp_ops.mesh_tiles(t(jscene), th, tw)
    assert bool(mesh_tiles.any())
    seam = (got - plain)[:, :h, :w].abs().amax(0) > 1e-3
    print(f"mesh tiles {int(mesh_tiles.sum())} of {mesh_tiles.numel()}, "
          f"{int(seam.sum())} pixels moved by the depth weights")
    assert int(seam.sum()) > 0
    mean, p995, mx = image_stats(got[:, :h, :w],
                                 jnp.asarray(want)[:, :h, :w], 99.5)
    print(f"B2 depth plain vs Pallas: mean {mean:.2e} p99.5 {p995:.2e} "
          f"max {mx:.2e}")
    assert mean < 3e-3 and p995 < 3e-2, (mean, p995, mx)


def test_b3_shadow_map_plain_matches_jax(jax_mesh):
    """B3's shadow-map variant, through `light_transmittance`, against the
    JAX twin and the Pallas kernel in interpret mode, with the test
    mesh's shadow map (non-trivial: the maps change with it)."""
    cfg, st, _ = jax_mesh
    po = jbpo(st.volume_worlds, jnp.eye(4, dtype=jnp.float32))
    light_dir = st.light_pos[:3] / jnp.linalg.norm(st.light_pos[:3])
    rho = st.rho_light[st.vol_tex_ids]
    svp = jmesh.shadow_view_proj(st)
    sm = st.mesh_shadow_map
    step = 0.2165
    ps = pstate.state_from_numpy(jax_state_dict(st))
    pld = ps.light_pos[:3] / torch.linalg.norm(ps.light_pos[:3])
    ppo = port_per_object(po)
    got, _ = pls.light_transmittance(
        t(rho), ppo, pld, step, 2, shadow_map=ps.mesh_shadow_map,
        shadow_vp=t(svp))
    free, _ = pls.light_transmittance(t(rho), ppo, pld, step, 2)
    moved = float((free - got).abs().max())
    print(f"shadow moves the transmittance by up to {moved:.3f}")
    assert moved > 0.1
    for impl in ("xla", "pallas"):
        want = jax.jit(lambda r: jls.light_transmittance(
            r, po, light_dir, step, shadow_map=sm, shadow_vp=svp,
            impl=impl, static_axis=2))(rho)
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5,
                                   err_msg=impl)


# a light per sweep axis whose shadow of the test mesh reaches the volumes
AXIS_LIGHTS = {0: (75.0, -20.0, -30.0), 1: (20.0, -75.0, -20.0),
               2: (75.0, -30.0, -75.0)}


@pytest.mark.parametrize("light_axis", [0, 1, 2])
def test_b3_shadow_map_light_axes_match_jax(jax_mesh, light_axis):
    """B3's shadow-map variant on a light sweep along each axis (the
    lateral planes permute with it), against the JAX twin and the Pallas
    kernel in interpret mode."""
    import dataclasses

    cfg, st, _ = jax_mesh
    st = dataclasses.replace(st, light_pos=jnp.array(
        [*AXIS_LIGHTS[light_axis], 1.0], jnp.float32))
    sm = jmesh.render_shadow_map(st, cfg)
    st = dataclasses.replace(st, mesh_shadow_map=sm)
    po = jbpo(st.volume_worlds, jnp.eye(4, dtype=jnp.float32))
    light_dir = st.light_pos[:3] / jnp.linalg.norm(st.light_pos[:3])
    rho = st.rho_light[st.vol_tex_ids]
    svp = jmesh.shadow_view_proj(st)
    step = 0.2165
    ps = pstate.state_from_numpy(jax_state_dict(st))
    assert pls.light_axis(ps.light_pos) == light_axis
    pld = ps.light_pos[:3] / torch.linalg.norm(ps.light_pos[:3])
    ppo = port_per_object(po)
    got, _ = pls.light_transmittance(
        t(rho), ppo, pld, step, light_axis, shadow_map=ps.mesh_shadow_map,
        shadow_vp=t(svp))
    free, _ = pls.light_transmittance(t(rho), ppo, pld, step, light_axis)
    moved = (free - got).abs()
    print(f"axis {light_axis}: the shadow moves {int((moved > 1e-3).sum())} "
          f"texels, by up to {float(moved.max()):.3f}")
    assert float(moved.max()) > 0.1 and int((moved > 1e-3).sum()) > 50
    wants = {}
    for impl in ("xla", "pallas"):
        wants[impl] = np.asarray(jax.jit(lambda r: jls.light_transmittance(
            r, po, light_dir, step, shadow_map=sm, shadow_vp=svp,
            impl=impl, static_axis=light_axis))(rho))
        d = np.abs(n(got) - wants[impl])
        print(f"axis {light_axis} vs {impl}: max {d.max():.3e}, "
              f"{int((d > 1e-5).sum())} texels beyond 1e-5")
        assert int((d > 1e-5).sum()) <= 2 and d.max() < 5e-5, impl
    print(f"axis {light_axis}: JAX twin vs Pallas max "
          f"{np.abs(wants['xla'] - wants['pallas']).max():.3e}")


def test_windowed_reprojection_matches_jax():
    """The TAA history reprojection inside a window around the mesh
    centre (one window inside the screen, one clipped at its corner),
    against the JAX Pallas path (interpret mode on the CPU)."""
    rng = np.random.RandomState(3)
    h, w, win = 72, 96, 40
    cur = [rng.rand(h, w).astype(np.float32) * 2.0 for _ in range(3)]
    cur.append(np.where(rng.rand(h, w) < 0.5, 1.0, 0.5).astype(np.float32))
    hist = rng.rand(4, h, w).astype(np.float32)
    vel = [((rng.rand(h, w) - 0.5) * 0.02).astype(np.float32)
           for _ in range(2)]
    for centre in ((41.3, 30.7), (90.0, 4.0)):
        rgb_p, nh_p = ptaa.temporal_aa(
            [t(x) for x in cur], t(hist), [t(x) for x in vel],
            reproj_center=tuple(torch.tensor(c) for c in centre),
            reproj_window=win)
        (_r, _g, _b), nh_j = jtaa.temporal_aa(
            tuple(jnp.asarray(x) for x in cur), jnp.asarray(hist),
            tuple(jnp.asarray(x) for x in vel), use_pallas=True,
            reproj_center=tuple(jnp.float32(c) for c in centre),
            reproj_window=win)
        np.testing.assert_allclose(n(nh_p), np.asarray(nh_j), atol=2e-5)
        full, _ = ptaa.temporal_aa([t(x) for x in cur], t(hist),
                                   [t(x) for x in vel])
        assert float((full[0] - rgb_p[0]).abs().max()) > 1e-3  # windowed


@pytest.mark.parametrize("preset", ["near", "far"])
def test_mesh_frames_match_jax(jax_mesh, preset):
    """Three frames with TAA and the mesh from the same carried state
    (the windowed shade and reprojection under the far preset)."""
    cfg, st, _ = jax_mesh
    cfg = _far(cfg) if preset == "far" else cfg
    pcfg = port_config(cfg)
    step = jax.jit(lambda s, c: jframe.render_frame(s, c, cfg,
                                                    use_taa=True))
    ps = pstate.state_from_numpy(jax_state_dict(st))
    for tm in TIMES:
        cam = jcam.orbit_camera(tm, cfg.aspect_ratio)
        out_j = step(st, cam)
        out_p = pframe.render_frame(ps, port_camera(cam), pcfg)
        st, ps = out_j.state, out_p.state
        mean, p999, mx = image_stats(out_p.image, out_j.image, 99.9)
        print(f"{preset} t={tm}: mean {mean:.2e} p99.9 {p999:.2e} "
              f"max {mx:.2e}")
        assert mean < 2e-3 and p999 < 3e-2, (tm, mean, p999, mx)
        np.testing.assert_allclose(n(ps.mesh_prev_wvp),
                                   np.asarray(st.mesh_prev_wvp), rtol=1e-5,
                                   atol=1e-6)
        mean, p999, mx = image_stats(ps.taa_history[:3],
                                     st.taa_history[:3], 99.9)
        assert mean < 2e-3 and p999 < 3e-2, (tm, mean, p999, mx)
        np.testing.assert_allclose(n(ps.light_maps),
                                   np.asarray(st.light_maps), atol=1e-4,
                                   rtol=1e-5)
    # the mesh is on screen, opaque
    assert float((out_p.hdr[..., 3] > 0.999).float().mean()) > 0.01
