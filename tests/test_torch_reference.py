"""The port's reference-semantics twins against the JAX package: the
texture sampler, the view march (`render/raymarch.py:ray_march_view`,
adaptive and not, with and without a scene depth), the gather light march
(`render/lightmarch.py:ray_march_light`, directional and point light,
with and without the light probe, with a shadow map, in z slabs), the
reference light mode's scene, the whole reference-semantics frame, and
the port's counterpart of the fidelity gate (`tests/test_fidelity.py:
46-81`): the port's fast frame against its own reference frame.

Tolerances: the view march at atol 2e-3, the limit the JAX march is held
to against its numpy twin (`tests/test_raymarch.py:91`); the light maps
at atol 1e-4 (transmittance to 1e-5 scaled by the light's 3 pi, as the
sweep maps are, ROADMAP.md section C); frames at the golden limits (mean
< 2e-3, p99.9 < 3e-2, `tests/test_goldens.py:37-41`); the fidelity gate
at the JAX test's thresholds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (image_stats, jax_state_dict, n,  # noqa: F401
                          one_torch_thread, port_camera, port_config,
                          port_cull, port_per_object, t)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.ops import trilinear as jtri
from multivolumes_tpu.render import cull as jcull
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu.render import lightmarch as jlm
from multivolumes_tpu.render import raymarch as jrm
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.ops import trilinear as ptri
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.render import lightmarch as plm
from multivolumes_tpu_torch.render import raymarch as prm
from multivolumes_tpu_torch.scene import state as pstate

CFG = RenderConfig(width=160, height=96, grid_size=16, light_grid_size=8,
                   max_ray_samples=24, max_light_samples=8, num_volumes=6,
                   num_volume_srcs=2, cube_map_size=16, shadow_map_size=64,
                   use_bf16=False, light_axis=2)
REF = CFG.with_(march_mode="reference", light_mode="reference",
                composite_mode="gather", packed_composite=False,
                light_axis=None)


@pytest.fixture(scope="module")
def scene():
    """A JAX scene with swept light maps (so the march's light taps are
    not all ones), an orbit camera and its per-object data and cull."""
    st = jstate.create_scene(CFG)
    cam = jcam.orbit_camera(0.3, CFG.aspect_ratio)
    po = jbpo(st.volume_worlds, cam.view_proj)
    cull = jcull.cull_volumes(po, cam.eye, jnp.array([160.0, 96.0]),
                              CFG.max_ray_samples, CFG.cube_map_size,
                              CFG.num_cube_mips)
    return st, cam, po, cull


def test_samplers_match_jax():
    rng = np.random.RandomState(0)
    stack = rng.rand(3, 5, 6, 7, 4).astype(np.float32)
    u, v, w = rng.uniform(-0.2, 1.2, (3, 40)).astype(np.float32)
    idx = rng.randint(0, 3, 40).astype(np.int32)
    want = jtri.indexed_trilinear_soa(stack, idx, u, v, w)
    got = ptri.indexed_trilinear_soa(t(stack), torch.from_numpy(idx), t(u),
                                     t(v), t(w))
    np.testing.assert_allclose(np.stack([n(g) for g in got]),
                               np.stack([n(x) for x in want]), atol=1e-6)
    np.testing.assert_allclose(
        n(ptri.indexed_trilinear_channel(t(stack), 3, torch.from_numpy(idx),
                                         t(u), t(v), t(w))), n(want[3]),
        atol=1e-6)


def test_get_step_and_target_hit_match_jax():
    rng = np.random.RandomState(1)
    a = [rng.uniform(-1.0, 1.0, 64).astype(np.float32) for _ in range(9)]
    a[1] = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        n(prm.get_step(t(a[0]) * 1e-2, t(a[1]), t(a[2]), 0.1)),
        n(jrm.get_step(a[0] * 1e-2, a[1], a[2], 0.1)), rtol=1e-6)
    np.testing.assert_allclose(
        n(prm.compute_target_hit_soa(*map(t, a))),
        n(jrm.compute_target_hit_soa(*a)), rtol=1e-5, atol=1e-5)


def _march_inputs(scene, with_depth):
    st, cam, po, cull = scene
    depth = None
    if with_depth:
        # a clip depth that occludes part of the scene (the volumes lie
        # near z_clip 0.984)
        yy, xx = np.mgrid[0:96, 0:160].astype(np.float32)
        depth = np.where(xx + yy > 120, 0.98, 1.0).astype(np.float32)
    return st, cam, po, cull, depth


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("with_depth", [False, True])
def test_ray_march_view_matches_jax(scene, adaptive, with_depth):
    st, cam, po, cull, depth = _march_inputs(scene, with_depth)
    # every visible volume on the cube-map path (at this screen size the
    # adaptive scheme sends them all to the per-pixel march)
    cull = cull._replace(use_cube_map=cull.visible)
    lm_last = jnp.moveaxis(st.light_maps, 1, -1)
    want = jax.jit(lambda d: jrm.ray_march_view(
        st.volumes, st.vol_tex_ids, lm_last, po, cull, cam.eye, d,
        CFG.cube_map_size, CFG.max_ray_samples, adaptive=adaptive))(depth)
    got = prm.ray_march_view(
        t(st.volumes), torch.from_numpy(np.array(st.vol_tex_ids)),
        t(lm_last), port_per_object(po), port_cull(cull), t(cam.eye),
        None if depth is None else t(depth), CFG.cube_map_size,
        CFG.max_ray_samples, adaptive=adaptive)
    assert float(np.asarray(want.color)[:, :, 3].max()) > 0.5
    np.testing.assert_allclose(n(got.color), n(want.color), atol=2e-3)
    np.testing.assert_allclose(n(got.depth), n(want.depth), atol=0)


def test_march_scatter_compaction_is_exact(scene):
    """A march that looks at its done mask (and drops the done rays)
    every step equals one that looks every 8, and both the JAX march."""
    st, cam, po, cull, _d = _march_inputs(scene, False)
    vol = st.volumes
    rng = np.random.RandomState(2)
    o = rng.uniform(-1.0, 1.0, (3, 500)).astype(np.float32)
    d = rng.normal(size=(3, 500)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tex = (np.arange(500) % 2).astype(np.int32)
    active = rng.rand(500) < 0.8
    smp = rng.randint(4, 24, 500).astype(np.int32)
    ss = (jrm.MAX_DIST / smp).astype(np.float32)
    tmax = rng.uniform(0.5, 3.0, 500).astype(np.float32)
    lm = np.full((2, 2, 2, 2, 3), 1.5, np.float32)

    tex_j, lm_j = jnp.asarray(tex), jnp.asarray(lm)
    want = jax.jit(lambda: jrm.march_scatter(
        lambda u, v, w: jtri.indexed_trilinear_soa(vol, tex_j, u, v, w),
        lambda u, v, w: jtri.indexed_trilinear_soa(lm_j, tex_j, u, v, w),
        tuple(o), tuple(d), tmax, smp, ss, 24, active))()
    tex_p = torch.from_numpy(tex)
    outs = []
    for every in (1, 8):
        outs.append(prm.march_scatter(
            lambda u, v, w, r: ptri.indexed_trilinear_soa(
                t(vol), tex_p[r], u, v, w),
            lambda u, v, w, r: ptri.indexed_trilinear_soa(
                t(lm), tex_p[r], u, v, w),
            tuple(map(t, o)), tuple(map(t, d)), t(tmax),
            torch.from_numpy(smp), t(ss), 24, torch.from_numpy(active),
            check_every=every))
    for got in outs:
        for c in "rgba":
            np.testing.assert_allclose(n(getattr(got, c)),
                                       n(getattr(want, c)), atol=2e-3)
    for c in "rgba":
        assert torch.equal(getattr(outs[0], c), getattr(outs[1], c))


def test_select_update_volume_matches_jax():
    rng = np.random.RandomState(3)
    for trial in range(6):
        vis = rng.rand(7) < (0.0 if trial == 0 else 0.5)
        for f in (0, 1, 5, 13):
            want = int(jlm.select_update_volume(jnp.asarray(vis), f))
            got = plm.select_update_volume(torch.from_numpy(vis), f)
            assert int(got) == want, (vis, f)


def _shadow(cfg):
    """A shadow map with an occluder over part of the light's view."""
    sm = np.ones((cfg.shadow_map_size,) * 2, np.float32)
    sm[:, : cfg.shadow_map_size // 2] = 0.3
    return sm


@pytest.mark.parametrize("point_light,probe,shadow", [
    (False, True, False), (False, False, False), (True, True, False),
    (True, False, False), (False, True, True)])
def test_ray_march_light_matches_jax(scene, point_light, probe, shadow):
    st, cam, po, cull = scene
    from multivolumes_tpu.render import mesh as jmesh

    sm = jnp.asarray(_shadow(CFG)) if shadow else None
    svp = np.asarray(jmesh.shadow_view_proj(st))
    light = np.array([30.0, 40.0, -20.0, 1.0], np.float32)
    for frame_idx in (0, 3):
        want = jax.jit(lambda s_, f_: jlm.ray_march_light(
            s_.volumes, s_.vol_tex_ids, s_.light_maps, po, cull, f_,
            sm, svp, light, s_.light_color, s_.ambient, s_.sh_coeffs,
            CFG.max_light_samples, has_light_probe=probe,
            point_light=point_light))(st, frame_idx)
        got = plm.ray_march_light(
            t(st.volumes), torch.from_numpy(np.array(st.vol_tex_ids)),
            t(st.light_maps), port_per_object(po), port_cull(cull),
            frame_idx, None if sm is None else t(sm), t(svp), t(light),
            t(st.light_color), t(st.ambient), t(st.sh_coeffs),
            CFG.max_light_samples, has_light_probe=probe,
            point_light=point_light)
        vid = int(jlm.select_update_volume(cull.visible, frame_idx))
        changed = np.abs(n(want)[vid] - n(st.light_maps)[vid]).max()
        assert changed > 1e-2       # the march did move the map
        err = np.abs(n(got) - n(want))
        if shadow:
            # on the shadow map's edge the PCF weight is fractional and
            # amplifies the f32 rounding of the light-space position (the
            # two shadow tests differ by up to 1.9e-6): 8 of the map's
            # 1536 texels x 3 differ by up to 1.08e-4 (1.1e-5 of the
            # transmittance)
            assert (err > 1e-4).mean() < 2e-3 and err.max() < 2e-4, (
                (err > 1e-4).sum(), err.max())
        else:
            assert err.max() < 1e-4, err.max()


def test_ray_march_light_z_slabs_equal_whole(scene):
    st, cam, po, cull = scene
    args = (t(st.volumes), torch.from_numpy(np.array(st.vol_tex_ids)))
    rest = (port_per_object(po), port_cull(cull), 2, None, None,
            t(st.light_pos), t(st.light_color), t(st.ambient),
            t(st.sh_coeffs), CFG.max_light_samples)
    whole = plm.ray_march_light(*args, t(st.light_maps), *rest)
    slabs = t(st.light_maps)
    for z0 in range(0, CFG.light_grid_size, 3):
        zc = min(3, CFG.light_grid_size - z0)
        plm.ray_march_light(*args, slabs, *rest, z_slab=(z0, zc))
    assert torch.equal(whole, slabs)


def test_create_scene_reference_light_matches_jax():
    cfg = REF
    js = jstate.create_scene(cfg)
    ps = pstate.create_scene(port_config(cfg), device="cpu")
    d = jax_state_dict(js)
    for name in ("light_maps", "light_sout", "volumes", "volume_worlds",
                 "vol_zmax"):
        np.testing.assert_array_equal(n(getattr(ps, name)), d[name], name)
    assert torch.equal(ps.light_sweep, pstate.to_light_sweep(
        ps.light_maps, ps.light_sweep.dtype))


def _jax_frames(cfg, times, warm=0):
    st = jstate.create_scene(cfg)
    step = jax.jit(lambda s, c: jframe.render_frame(s, c, cfg, use_taa=True))
    for f in range(warm):
        st = step(st, jcam.orbit_camera(f / 60.0, cfg.aspect_ratio)).state
    st0 = st
    outs = []
    for tm in times:
        out = step(st, jcam.orbit_camera(tm, cfg.aspect_ratio))
        outs.append((np.asarray(out.image), jax_state_dict(out.state)))
        st = out.state
    return st0, outs


def test_reference_frame_matches_jax():
    """Two reference-semantics frames (gather march, gather light march,
    gather composite with its per-pixel march) from a JAX state whose
    light maps are all marched, against the JAX frames."""
    times = (0.3, 0.55)
    st0, outs = _jax_frames(REF, times, warm=REF.num_volumes)
    ps = pstate.state_from_numpy(jax_state_dict(st0))
    pcfg = port_config(REF)
    for tm, (img_j, st_j) in zip(times, outs):
        out = pframe.render_frame(
            ps, port_camera(jcam.orbit_camera(tm, REF.aspect_ratio)), pcfg)
        ps = out.state
        mean, p999, mx = image_stats(out.image, img_j, 99.9)
        assert mean < 2e-3 and p999 < 3e-2, (tm, mean, p999, mx)
        np.testing.assert_allclose(n(ps.light_maps), st_j["light_maps"],
                                   atol=1e-4)
        assert ps.frame_idx == int(st_j["frame_idx"])
    assert float(out.hdr[..., 3].max()) > 0.2


def _port_render(cfg, warmup, camera):
    """tests/test_fidelity.py:_render on the port, on the CPU."""
    state = pstate.create_scene(cfg, device="cpu")
    for f in range(warmup):
        state = pframe.render_frame(
            state, pcam.orbit_camera(f / 60.0, cfg.aspect_ratio,
                                     device="cpu"), cfg,
            use_taa=False).state
    return pframe.render_frame(state, camera, cfg, use_taa=False).image \
        .numpy()


def test_port_fast_vs_reference_semantics():
    """The port's counterpart of `test_full_frame_fast_vs_reference_
    semantics`: its own fast frame (sweep march, sweep light, tile
    composite) against its own reference frame, and the mixed sub-gate
    (fast march, reference light), at the JAX test's thresholds."""
    from test_fidelity import _FAST

    fast_cfg = port_config(_FAST)
    ref_cfg = fast_cfg.with_(march_mode="reference", light_mode="reference",
                             composite_mode="gather",
                             packed_composite=False, use_bf16=False)
    camera = pcam.orbit_camera(0.35, fast_cfg.aspect_ratio, device="cpu")
    ref = _port_render(ref_cfg, ref_cfg.num_volumes, camera)
    fast = _port_render(fast_cfg, 0, camera)
    diff = np.abs(fast - ref)
    assert diff.mean() < 1e-2, diff.mean()
    assert np.percentile(diff, 99) < 8e-2, np.percentile(diff, 99)
    assert (diff.max(-1) > 0).mean() > 0.05
    mix = _port_render(fast_cfg.with_(light_mode="reference",
                                      use_bf16=False),
                       fast_cfg.num_volumes, camera)
    diff_m = np.abs(mix - ref)
    assert diff_m.mean() < 1e-3, diff_m.mean()
    assert np.percentile(diff_m, 99) < 1e-2, np.percentile(diff_m, 99)
