"""The port's gather and warp composites and the sweep's other output
contracts against the JAX package: `pack_cube_f16` / `unpack_cube_f16`
bit for bit, `_select_layers` on ties, `cube_cast_soa`, `composite_oit`
(with and without the per-pixel march, with a scene depth), `warp_face`
(both pass-2 forms), `composite_oit_warp` (with LOD classes and
without), the un-bucketed sweep `ray_march_view_sweep` (through the plain
B1 version) against JAX's and against the reference march, and the LOD
sweep's unsorted and packed outputs.

Tolerances: the CubeCast filter and the composites built on it at rtol
2e-4 + atol 2e-4 (`tests/test_warp.py:372-426`, the gather twin against
its numpy port), widened to the march's 2e-3 (`tests/test_raymarch.py:
91`) where the per-pixel march runs; the un-bucketed sweep at
`tests/test_sweep.py:47-84`'s limits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (jax_state_dict, n,  # noqa: F401
                          one_torch_thread, port_cull, port_per_object, t)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.render import composite as jcomp
from multivolumes_tpu.render import cull as jcull
from multivolumes_tpu.render import raymarch as jrm
from multivolumes_tpu.render import sweep as jsw
from multivolumes_tpu.render import warp as jwarp
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch.render import composite as pcomp
from multivolumes_tpu_torch.render import raymarch as prm
from multivolumes_tpu_torch.render import sweep as psw
from multivolumes_tpu_torch.render import warp as pwarp
from multivolumes_tpu_torch.scene import state as pstate

CFG = RenderConfig(width=128, height=96, grid_size=16, light_grid_size=8,
                   max_ray_samples=24, max_light_samples=8, num_volumes=8,
                   num_volume_srcs=2, cube_map_size=32, shadow_map_size=32,
                   use_bf16=False, light_axis=2)


def _ids(x):
    return torch.from_numpy(np.array(x).astype(np.int64))


@pytest.fixture(scope="module")
def case():
    """A JAX scene, an orbit camera and its per-object data and cull, and
    a scene depth that occludes part of the volumes."""
    st = jstate.create_scene(CFG)
    cam = jcam.orbit_camera(0.3, CFG.aspect_ratio)
    po = jbpo(st.volume_worlds, cam.view_proj)
    cull = jcull.cull_volumes(po, cam.eye, jnp.array([128.0, 96.0]),
                              CFG.max_ray_samples, CFG.cube_map_size,
                              CFG.num_cube_mips)
    yy, xx = np.mgrid[0:96, 0:128].astype(np.float32)
    depth = np.where(xx - yy > 40, 0.98, 1.0).astype(np.float32)
    return st, cam, po, cull, depth


def test_pack_cube_f16_bit_exact():
    rng = np.random.RandomState(0)
    x = rng.normal(size=(2, 6, 4, 5, 7)).astype(np.float32) * 3.0
    flat = x.reshape(-1)
    flat[:8] = [0.0, -0.0, np.inf, -np.inf, 1e-6, -3e-7, 65504.0, 7e4]
    want = np.asarray(jcomp.pack_cube_f16(jnp.asarray(x)))
    got = pcomp.pack_cube_f16(t(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    back_j = np.asarray(jcomp.unpack_cube_f16(jnp.asarray(want)))
    back_p = pcomp.unpack_cube_f16(got).numpy()
    np.testing.assert_array_equal(back_p.view(np.uint32),
                                  back_j.view(np.uint32))
    # pack -> unpack is exact on f16 values
    h = x.astype(np.float16).astype(np.float32)
    assert torch.equal(pcomp.unpack_cube_f16(pcomp.pack_cube_f16(t(h))),
                       t(h))
    nan = t(np.full((1, 1, 4, 1, 1), np.nan, np.float32))
    assert bool(pcomp.unpack_cube_f16(pcomp.pack_cube_f16(nan)).isnan()
                .all())


def test_select_layers_takes_the_first_minimum():
    key = np.array([[[3.0, 1.0]], [[1.0, 1.0]], [[1.0, 2.0]]], np.float32)
    kj, ij = jcomp._select_layers(jnp.asarray(key), 3)
    kp, ip = pcomp._select_layers(t(key), 3)
    np.testing.assert_array_equal(n(kp), n(kj))
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    assert ip[0, 0].tolist() == [1, 0]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("has_depth", [False, True])
def test_cube_cast_matches_jax(packed, has_depth):
    rng = np.random.default_rng(7)
    s, r = 16, 300
    n_eff = rng.choice([4, 8, 16], r).astype(np.int32)
    color = rng.uniform(0.0, 1.0, (r, 6, 4, s, s)).astype(np.float32)
    depth = np.clip(rng.uniform(0.3, 0.8, (r, 1, 1, 1))
                    + rng.uniform(-0.05, 0.05, (r, 6, s, s)), 0.0,
                    1.0).astype(np.float32)
    pos = rng.uniform(-1.0, 1.0, (3, r)).astype(np.float32)
    axis = rng.integers(0, 3, r)
    pos[axis, np.arange(r)] = rng.choice([-1.0, 1.0], r)
    d = rng.normal(size=(3, r)).astype(np.float32)
    base = rng.uniform(0.3, 0.8, r).astype(np.float32)
    cj = jnp.asarray(color)
    if packed:
        cj = jcomp.pack_cube_f16(cj)
    want = jcomp.cube_cast_soa(cj, jnp.asarray(depth), jnp.arange(r),
                               jnp.asarray(n_eff), *pos, *d,
                               jnp.asarray(base), has_depth=has_depth)
    cp = pcomp.pack_cube_f16(t(color)) if packed else t(color)
    got = pcomp.cube_cast_soa(cp, t(depth), torch.arange(r),
                              _ids(n_eff), *map(t, pos), *map(t, d), t(base),
                              has_depth=has_depth)
    np.testing.assert_allclose(np.stack([n(g) for g in got]),
                               np.stack([n(w) for w in want]), rtol=2e-4,
                               atol=2e-4)


def test_sample_cube_and_ray_box_exit_match_jax():
    rng = np.random.default_rng(3)
    color = rng.uniform(0.0, 1.0, (5, 6, 4, 16, 16)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    vid = rng.integers(0, 5, 200)
    n_eff = rng.choice([4, 8, 16], 200).astype(np.int32)
    want = jcomp.sample_cube(jnp.asarray(color), jnp.asarray(vid),
                             jnp.asarray(d), jnp.asarray(n_eff))
    got = pcomp.sample_cube(t(color), _ids(vid), t(d), _ids(n_eff))
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)
    o = rng.uniform(-3.0, 3.0, (200, 3)).astype(np.float32)
    hit_j, t_j = jcomp.ray_box_exit(jnp.asarray(o), jnp.asarray(d))
    hit_p, t_p = pcomp.ray_box_exit(t(o), t(d))
    np.testing.assert_array_equal(hit_p.numpy(), np.asarray(hit_j))
    assert 0 < int(hit_p.sum()) < 200
    np.testing.assert_allclose(n(t_p), n(t_j), rtol=1e-6)


@pytest.mark.parametrize("use_raycast", [False, True])
def test_composite_oit_matches_jax(case, use_raycast):
    """The gather composite on the reference march's maps (its per-pixel
    march for the volumes off the cube-map path) or on packed maps of
    the whole-resolution march, with a scene depth."""
    st, cam, po, cull, depth = case
    lm_last = jnp.moveaxis(st.light_maps, 1, -1)
    if not use_raycast:
        cull = cull._replace(use_cube_map=cull.visible,
                             mip_level=jnp.zeros_like(cull.mip_level))
    maps = jax.jit(lambda: jrm.ray_march_view(
        st.volumes, st.vol_tex_ids, lm_last, po, cull, cam.eye,
        jnp.asarray(depth), CFG.cube_map_size, CFG.max_ray_samples))()
    if not use_raycast:
        maps = maps._replace(color=jcomp.pack_cube_f16(maps.color))
    want = jax.jit(lambda m: jcomp.composite_oit(
        m, st.volumes, st.vol_tex_ids, lm_last, po, cull, cam.eye,
        jm.inverse(cam.view_proj), jnp.asarray(depth), 128, 96,
        CFG.max_ray_samples, use_raycast=use_raycast, has_depth=True))(maps)
    got = pcomp.composite_oit(
        prm.CubeMaps(color=t(maps.color), depth=t(maps.depth)),
        t(st.volumes), _ids(st.vol_tex_ids), t(lm_last),
        port_per_object(po), port_cull(cull), t(cam.eye),
        t(jm.inverse(cam.view_proj)), t(depth), 128, 96,
        CFG.max_ray_samples, use_raycast=use_raycast, has_depth=True)
    if use_raycast:
        assert not bool(np.asarray(cull.use_cube_map).all())
    assert float(np.asarray(want[3]).max()) > 0.3
    tol = dict(atol=2e-3) if use_raycast else dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.stack([n(g) for g in got]),
                               np.stack([n(w) for w in want]), **tol)


@pytest.mark.parametrize("face", [2, 4])
def test_warp_face_matches_jax(face):
    """Both pass-2 forms: the face's own orientation (rows along v, the
    piecewise-rectified form) and the transposed one, whose rows vary
    with screen x (the dense form)."""
    s = 16
    cam = jcam.default_camera(1.0)
    w = np.eye(4, dtype=np.float32) * 8.0
    w[3] = [0.0, 0.0, 0.0, 1.0]
    po = jbpo(jnp.asarray(w[None]), cam.view_proj)
    a_mat = jwarp.screen_basis(jm.inverse(cam.view_proj), cam.eye)
    b_mat = a_mat @ po.world_i[0, :3, :3]
    o = jm.transform_point3(cam.eye, po.world_i)[0]
    img = np.random.RandomState(face).rand(4, s, s).astype(np.float32)
    xg = np.linspace(-0.3, 0.3, 48).astype(np.float32)
    yg = np.linspace(0.3, -0.3, 32).astype(np.float32)
    nu, nv, den = jwarp.face_homography(b_mat, o, face)
    p_u, p_v = s * nu - 0.5 * den, s * nv - 0.5 * den
    forms = []
    for pu, pv, im in ((p_u, p_v, img), (p_v, p_u, img.swapaxes(-1, -2))):
        want = np.asarray(jax.jit(jwarp.warp_face)(jnp.asarray(im), pu, pv,
                                                   den, xg, yg))
        forms.append(bool(pwarp.rectified_ok(t(pv), t(den), t(xg),
                                             t(yg))))
        got = pwarp.warp_face(t(im), t(pu), t(pv), t(den), t(xg), t(yg))
        np.testing.assert_allclose(n(got), want, rtol=2e-4, atol=2e-4)
    assert forms == [True, False]


@pytest.mark.parametrize("lod", [False, True])
def test_composite_oit_warp_matches_jax(case, lod):
    st, cam, po, cull, depth = case
    lod_cull = cull._replace(use_cube_map=cull.visible)
    if lod:
        out = jax.jit(lambda s_: jsw.ray_march_view_sweep_lod(
            s_.volumes_oriented, s_.vol_tex_ids, s_.light_maps_oriented, po,
            lod_cull, cam.eye, None, CFG.cube_map_size, dtype=jnp.float32,
            pack=False, light_w=CFG.light_grid_size))(st)
        maps, mips = out
        cull_c = lod_cull._replace(mip_level=mips)
        order, buckets = jsw.lod_partition(lod_cull, CFG.num_volumes,
                                           CFG.cube_map_size, (2, 3, 1 << 30))
        kw = dict(lod_order=order, lod_buckets=buckets)
        pkw = dict(lod_order=_ids(order), lod_buckets=buckets)
    else:
        cull_c = lod_cull._replace(mip_level=jnp.zeros_like(cull.mip_level))
        maps = jax.jit(lambda: jrm.ray_march_view(
            st.volumes, st.vol_tex_ids, jnp.moveaxis(st.light_maps, 1, -1),
            po, cull_c, cam.eye, None, CFG.cube_map_size,
            CFG.max_ray_samples))()
        kw = pkw = {}
    s2w = jm.inverse(cam.view_proj)
    # a tile below the screen size, so the _NUM_BIG split runs
    want = jwarp.composite_oit_warp(maps, po, cull_c, cam.eye, s2w,
                                    jnp.asarray(depth), 128, 96, 8, tile=64,
                                    **kw)
    got = pwarp.composite_oit_warp(
        prm.CubeMaps(color=t(maps.color), depth=None), port_per_object(po),
        port_cull(cull_c), t(cam.eye), t(s2w), t(depth), 128, 96, 8,
        tile=64, **pkw)
    assert float(np.asarray(want[3]).max()) > 0.3
    np.testing.assert_allclose(np.stack([n(g) for g in got]),
                               np.stack([n(w) for w in want]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("with_depth", [False, True])
def test_ray_march_view_sweep_matches_jax(case, with_depth):
    """The un-bucketed sweep through the plain B1 version against JAX's
    (its XLA twin), on 8 volumes, with and without a scene depth."""
    st, cam, po, cull, depth = case
    depth = jnp.asarray(depth) if with_depth else None
    cull_c = cull._replace(use_cube_map=cull.visible,
                           mip_level=jnp.zeros_like(cull.mip_level))
    want = jax.jit(lambda s_, d_: jsw.ray_march_view_sweep(
        s_.volumes_oriented, s_.vol_tex_ids, s_.light_maps_oriented, po,
        cull_c, cam.eye, d_, CFG.cube_map_size, num_planes=24,
        dtype=jnp.float32, impl="xla", light_w=CFG.light_grid_size))(
        st, depth)
    ps = pstate.state_from_numpy(jax_state_dict(st))
    got = psw.ray_march_view_sweep(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep,
        port_per_object(po), port_cull(cull_c), t(cam.eye),
        None if depth is None else t(depth), CFG.cube_map_size,
        num_planes=24, vol_zmax=ps.vol_zmax)
    assert float(np.asarray(want.color)[:, :, 3].max()) > 0.5
    np.testing.assert_allclose(n(got.color), n(want.color), atol=2e-3,
                               rtol=2e-2)
    np.testing.assert_array_equal(n(got.depth), n(want.depth))


def test_ray_march_view_sweep_matches_reference_march():
    """`tests/test_sweep.py:test_sweep_matches_reference_march` on the
    port: its config, camera and limits, the sweep through the plain B1
    version against the port's reference march."""
    from multivolumes_tpu_torch.config import RenderConfig as PConfig
    from multivolumes_tpu_torch.core import camera as pcam
    from multivolumes_tpu_torch.render import cull as pcull
    from multivolumes_tpu_torch.render.perframe import build_per_object

    cfg = PConfig(width=160, height=120, grid_size=16, light_grid_size=8,
                  max_ray_samples=32, num_volumes=1, num_volume_srcs=1,
                  cube_map_size=16)
    ps = pstate.create_scene(cfg, device="cpu")
    cam = pcam.make_camera([2.0, 10.0, -40.0], [0.0, 0.0, 0.0], 160 / 120,
                           device="cpu")
    po = build_per_object(ps.volume_worlds, cam.view_proj)
    cull = pcull.cull_volumes(po, cam.eye, [160.0, 120.0], 32, 16, 5,
                              adaptive=False)
    depth = torch.ones((120, 160))
    ref = prm.ray_march_view(ps.volumes, ps.vol_tex_ids,
                             ps.light_maps.movedim(1, -1), po, cull, cam.eye,
                             depth, 16, 32, adaptive=False)
    # f32 stacks, as the JAX test's
    sw = psw.ray_march_view_sweep(
        ps.volumes, ps.vol_tex_ids,
        pstate.to_light_sweep(ps.light_maps, torch.float32), po, cull,
        cam.eye, depth, 16, num_planes=32)
    r, s = n(ref.color), n(sw.color)
    mask = r[:, :, 3] > 0.02
    assert mask.any()
    diff = np.abs(r - s)
    assert diff.mean() < 2e-3
    assert np.percentile(np.max(diff, axis=2)[mask], 99) < 0.05
    assert r[0, 4, 3, 8, 8] > 0.9 and s[0, 4, 3, 8, 8] > 0.9


@pytest.mark.parametrize("pack", [False, True])
def test_lod_sweep_unsorted_contracts_match_jax(case, pack):
    """The LOD sweep's outputs for the warp (volume order, unswapped) and
    for the gather (the same, f16-pair packed), with a scene depth."""
    st, cam, po, cull, depth = case
    lod_cull = cull._replace(use_cube_map=cull.visible)
    caps = (2, 3, 1 << 30)
    maps, mips = jax.jit(lambda s_: jsw.ray_march_view_sweep_lod(
        s_.volumes_oriented, s_.vol_tex_ids, s_.light_maps_oriented, po,
        lod_cull, cam.eye, jnp.asarray(depth), CFG.cube_map_size,
        dtype=jnp.float32, bucket_caps=caps, impl="xla", pack=pack,
        light_w=CFG.light_grid_size))(st)
    ps = pstate.state_from_numpy(jax_state_dict(st))
    got = psw.ray_march_view_sweep_lod(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep,
        port_per_object(po), port_cull(lod_cull), t(cam.eye),
        CFG.cube_map_size, None, bucket_caps=caps, vol_zmax=ps.vol_zmax,
        depth_map=t(depth), sorted_output=False, pack=pack)
    np.testing.assert_array_equal(got.mips.numpy(), np.asarray(mips))
    assert got.swap is None and got.order.tolist() == list(range(8))
    g, w = got.cube_maps.color, jnp.asarray(maps.color)
    if pack:
        assert g.shape[2] == 2
        g, w = pcomp.unpack_cube_f16(g), jcomp.unpack_cube_f16(w)
    np.testing.assert_allclose(n(g), n(w), atol=2e-3, rtol=2e-2)
    np.testing.assert_array_equal(n(got.cube_maps.depth), n(maps.depth))
