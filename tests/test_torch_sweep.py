"""Parity of the port's LOD cube-map sweep with the JAX package: the plain
version of kernel B1 against the JAX twin `sweep.sweep_batched` and the
Pallas kernel in interpret mode, the LOD bucket order, and the whole
`ray_march_view_sweep_lod` (maps, mips, order, Catmull-Smith flags).
Tolerance atol=2e-3, rtol=2e-2 (tests/test_pallas_sweep.py); order,
mips and flags exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (jax_lod_case, jax_state_dict, n,
                          one_torch_thread, port_cull, port_per_object, t)

from multivolumes_tpu.ops.pallas.sweep_kernel import sweep_batched_pallas
from multivolumes_tpu.render import sweep as jsw
from multivolumes_tpu.render.cull import CullResult as JCull
from multivolumes_tpu_torch.ops import sweep as psw_ops
from multivolumes_tpu_torch.render import sweep as psw
from multivolumes_tpu_torch.render import warp as pwarp
from multivolumes_tpu_torch.scene import state as pstate

assert one_torch_thread  # the module-wide fixture, used by every test

TOL = dict(atol=2e-3, rtol=2e-2)


def _b1_case(seed=0, n_vol=3, n_src=2, d=12, dl=8, s=8):
    rng = np.random.RandomState(seed)
    vols = rng.rand(n_src, d, d, d, 4).astype(np.float32)
    lights = rng.rand(n_vol + 1, 3, dl, dl, dl).astype(np.float32)
    tex = rng.randint(0, n_src, n_vol).astype(np.int32)
    # eyes outside, inside and grazing the unit box
    eye_local = np.array([[0.3, -0.4, -2.5], [0.2, 0.1, 0.3],
                          [1.7, 1.1, 0.4]], np.float32)[:n_vol]
    n_eff = np.array([s, s // 2, s], np.float32)[:n_vol]
    light_ids = np.array([2, 0, 3], np.int32)[:n_vol]
    eye_faces = jsw.eye_to_face_frames(jnp.asarray(eye_local))
    u = (np.arange(s, dtype=np.float32)[None] + 0.5) / n_eff[:, None] \
        * 2.0 - 1.0
    u6 = jnp.asarray(np.repeat(u, 6, axis=0))
    params = jsw.face_ray_params(eye_faces.reshape(n_vol * 6, 3), u6, -u6)
    params = jsw.SweepParams(*(x.reshape(n_vol, 6, s, s) for x in params))
    smp = jnp.asarray(rng.randint(8, 40, n_vol), jnp.int32)
    run = np.ones((n_vol, 6), bool)
    run[0, 3] = False
    return vols, lights, tex, eye_faces, params, smp, jnp.asarray(run), \
        n_eff, light_ids, s


def _port_light(lights_cf):
    """(N, 3, L, L, L) channel-mid -> the port's (N, L, L, L, 4) stack."""
    return pstate.to_light_sweep(t(lights_cf), torch.float32)


def test_face_frames_and_ray_params_match_jax():
    (_v, _l, _x, eye_faces, params, *_rest, n_eff, _ids, s) = _b1_case()
    eye_local = np.array([[0.3, -0.4, -2.5], [0.2, 0.1, 0.3],
                          [1.7, 1.1, 0.4]], np.float32)
    ef = psw.eye_to_face_frames(t(eye_local))
    np.testing.assert_array_equal(n(ef), n(eye_faces))
    u = (torch.arange(s)[None] + 0.5) / t(n_eff)[:, None] * 2.0 - 1.0
    u6 = u.repeat_interleave(6, dim=0)
    pp = psw.face_ray_params(ef.reshape(-1, 3), u6, -u6)
    for name, a, b in zip(pp._fields, pp, params):
        np.testing.assert_allclose(n(a).reshape(b.shape), n(b), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_b1_plain_matches_jax_twin_and_pallas(dtype):
    (vols, lights, tex, eye_faces, params, smp, run, n_eff, light_ids,
     s) = _b1_case()
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    pdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    vol_or = jsw.orient_variants(jnp.asarray(vols, jdt))
    light_or = jsw.orient_variants_cf(jnp.asarray(lights, jdt))
    args = (jnp.asarray(tex), eye_faces, params, smp, run, s, s)
    kw = dict(n_eff_b=jnp.asarray(n_eff), light_ids=jnp.asarray(light_ids))
    want = jax.jit(lambda a, b: jsw.sweep_batched(a, b, *args, dtype=jdt,
                                                  **kw))(vol_or, light_or)
    got = psw_ops.sweep_march(
        t(vols, pdt), _port_light(lights).to(pdt),
        torch.from_numpy(tex), t(eye_faces),
        psw.SweepParams(*(torch.from_numpy(np.asarray(x)) for x in params)),
        torch.from_numpy(np.asarray(smp)), torch.from_numpy(np.asarray(run)),
        s, s, n_eff_b=t(n_eff), light_ids=torch.from_numpy(light_ids))
    np.testing.assert_allclose(n(got), n(want), **TOL)
    if dtype == "f32":
        pal = sweep_batched_pallas(vol_or, light_or, *args, dtype=jdt,
                                   interpret=True, **kw)
        np.testing.assert_allclose(n(got), n(pal), **TOL)


def test_b1_sample_counts_bound_the_work():
    """The counts behind B1's bound (`chip_smoke.bound_sweep`): per ray,
    `live` (the samples the plain march composites) and `needed` (those
    met while its transmittance is still >= 0.01, where the kernel stops
    a face), and the distinct texels the needed samples read. needed <=
    live <= the samples inside the ray's [s_in, s_end] window; needed ==
    live on every ray whose transmittance ends above 0.01; a ray that
    composites anything needs a sample; the early exit cuts some rays of
    this case (eyes outside, inside and grazing the box, densities up to
    1); the texels read are some, not all, of the referenced stacks';
    and the scatter is the plain version's."""
    (vols, lights, tex, eye_faces, params, smp, run, n_eff, light_ids,
     s) = _b1_case()
    eye_f = t(eye_faces)
    pp = psw.SweepParams(*(torch.from_numpy(np.array(x)) for x in params))
    run = torch.from_numpy(np.array(run))
    args = (t(vols), _port_light(lights), torch.from_numpy(tex), eye_f, pp,
            torch.from_numpy(np.array(smp)), run, s, s)
    kw = dict(n_eff_b=t(n_eff), light_ids=torch.from_numpy(light_ids))
    acc, counts = psw_ops.sweep_march_plain(*args, **kw, sample_counts=True)
    live, needed = counts["live"], counts["needed"]
    # the window: the planes whose sample lies in [s_in, s_end], at the
    # march's own sample positions
    ew = eye_f[..., 2][:, :, None, None]
    ew_c = torch.clamp(ew, -1.0, 1.0)
    delta = (1.0 - ew_c) / s
    inv_gz = 1.0 / torch.clamp(1.0 - ew, min=1e-6)
    ray_ok = pp.active & run[:, :, None, None]
    window = torch.zeros_like(live)
    for k in range(s):
        sk = (ew_c + (k + 0.5) * delta - ew) * inv_gz
        window += ray_ok & (sk >= pp.s_in) & (sk <= pp.s_end)
    assert bool((needed <= live).all()) and bool((live <= window).all())
    alpha = acc[:, :, 3]
    clear = alpha < 0.985                   # transmittance stays >= 0.015
    assert torch.equal(needed[clear], live[clear])
    assert bool((needed[alpha > 0.0] >= 1).all())
    assert int(needed.sum()) < int(live.sum()) <= int(window.sum())
    n_src, n_light = len(set(tex.tolist())), len(set(light_ids.tolist()))
    assert 0 < counts["vol_texels"] < n_src * vols.shape[1] ** 3
    assert 0 < counts["light_texels"] < n_light * lights.shape[-1] ** 3
    assert torch.equal(acc, psw_ops.sweep_march_plain(*args, **kw))


def test_lod_partition_order_matches_jax():
    rng = np.random.RandomState(3)
    nv = 40
    cull = JCull(
        visible=jnp.asarray(rng.rand(nv) < 0.7),
        mip_level=jnp.asarray(rng.randint(0, 3, nv), jnp.int32),
        smp_count=jnp.zeros((nv,), jnp.int32),
        face_mask=jnp.ones((nv, 6), bool),
        use_cube_map=jnp.ones((nv,), bool),
        # few distinct edge lengths: many equal sort keys
        max_edge_px=jnp.asarray(rng.randint(10, 14, nv).astype(np.float32)))
    caps = (8, 24, 1 << 30)
    oj, bj = jsw.lod_partition(cull, nv, 128, caps)
    op, bp = psw.lod_partition(port_cull(cull), nv, 128, caps)
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    assert bp == bj


@pytest.fixture(scope="module")
def lod_case():
    return jax_lod_case()


def test_ray_march_view_sweep_lod_matches_jax(lod_case):
    cfg, st, cam, po, lod_cull, basis, (maps, mips, order, swap) = lod_case
    ps = pstate.state_from_numpy(jax_state_dict(st))
    got = psw.ray_march_view_sweep_lod(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep,
        port_per_object(po), port_cull(lod_cull), t(cam.eye), 32, t(basis),
        vol_zmax=ps.vol_zmax)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(got.mips.numpy(), np.asarray(mips))
    np.testing.assert_array_equal(got.swap.numpy(), np.asarray(swap))
    assert len(set(np.asarray(mips).tolist())) > 1  # several LOD buckets
    np.testing.assert_allclose(n(got.cube_maps.color), n(maps.color), **TOL)


def test_sweep_flags_are_the_shared_function(lod_case):
    """The sweep's flags are `warp.catmull_swap_flags` of the sorted rows.
    The tile prep packs its face rows by them as given and picks none of
    its own, so this is the one guard that the frame's faces are oriented
    by the shared rule."""
    cfg, st, cam, po, lod_cull, basis, _out = lod_case
    ps = pstate.state_from_numpy(jax_state_dict(st))
    ppo = port_per_object(po)
    got = psw.ray_march_view_sweep_lod(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep, ppo,
        port_cull(lod_cull), t(cam.eye), 32, t(basis))
    pos = ppo.take(got.order)
    from multivolumes_tpu_torch.core import math3d as pm

    n_eff = (32 >> got.mips[got.order]).float()
    flags = pwarp.catmull_swap_flags(
        t(basis), pos.world_i, pos.world_view_proj,
        pm.transform_point3(t(cam.eye), pos.world_i), n_eff)
    assert torch.equal(flags, got.swap)


def test_bucket_mips_clamps_without_a_floor_upload():
    """`bucket_mips` clamps x = projected mip + scheme offset straight into
    [mip_b, max_mip]. Over a grid of projected mips, cube-map routes,
    bucket levels and deepest mips it equals the form it replaced,
    clamp(max(x, mip_b), mip_b, max_mip) with mip_b uploaded as a device
    tensor, value and dtype."""
    from multivolumes_tpu_torch.render.cull import CullResult

    mips = torch.arange(-1, 7, dtype=torch.int32).repeat_interleave(2)
    use = torch.tensor([True, False]).repeat(8)
    k = mips.shape[0]
    cull = CullResult(torch.ones(k, dtype=torch.bool), mips,
                      torch.zeros(k, dtype=torch.int32),
                      torch.ones((k, 6), dtype=torch.bool), use,
                      torch.zeros(k))
    ids = torch.arange(k)
    for mip_b in range(6):
        for max_mip in range(6):
            x = torch.clamp(mips, 0, max_mip) + (~use).int()
            want = torch.clamp(torch.maximum(x, torch.tensor(mip_b)),
                               mip_b, max_mip).int()
            got = psw.bucket_mips(cull, ids, mip_b, max_mip)
            assert got.dtype == want.dtype and torch.equal(got, want), (
                mip_b, max_mip)


def test_flip_proofs_bisect_every_ray_at_once():
    """`tools/sweep_outliers.one_sample_flips` (what `chip_smoke.py:
    flip_tol` proves B1's outlier rays with) against the same bisection
    made ray by ray with `cut_march`, on a stand-in for the kernel: the
    plain version on densities 0.3% higher, so that samples at the 0.01
    threshold flip. The batched proof finds the plane and the side of
    each ray as the single-ray one does, and reports the rays that first
    part where both sides composite (the higher densities build up)."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as pcam
    from multivolumes_tpu_torch.render import frame as pframe
    from multivolumes_tpu_torch.tools import sweep_outliers as so

    cfg = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                       max_ray_samples=16, max_light_samples=8,
                       num_volumes=4, num_volume_srcs=2, cube_map_size=16,
                       shadow_map_size=32, light_axis=2, lod_bucket_caps=None)
    state = pstate.create_scene(cfg, device="cpu")
    calls, orig = [], psw.sweep_march

    def record(*a, **k):
        calls.append((a, {n_: x for n_, x in k.items() if n_ != "impl"}))
        return orig(*a, **k)

    def stand_in(*a, impl=None, **k):
        if impl == "kernel":
            a = (a[0] * 1.003,) + a[1:]
        return orig(*a, **k, impl="plain")

    psw.sweep_march = record
    try:
        pframe.render_frame(state, pcam.orbit_camera(
            0.3, cfg.aspect_ratio, device="cpu"), cfg)
        a, k = calls[0]
        psw.sweep_march = stand_in
        got, want = (stand_in(*a, **k, impl=i) for i in ("kernel", "plain"))
        bad = (got - want).abs() > 2e-3 + 2e-2 * want.abs()
        rays = sorted({tuple(x[:2] + x[3:]) for x in bad.nonzero().tolist()})
        assert len(rays) >= 2
        proofs = so.one_sample_flips(a, k, rays)

        def one_ray(ray, dtype=a[0].dtype):
            lo, hi = -1, a[7] - 1
            rows_lo, rows_hi = (so.cut_march(a, k, ray, dtype, m)
                                for m in (lo, hi))
            while hi - lo > 1:
                mid = (lo + hi) // 2
                rows = so.cut_march(a, k, ray, dtype, mid)
                if so._parted(rows):
                    hi, rows_hi = mid, rows
                else:
                    lo, rows_lo = mid, rows
            grew = rows_hi - rows_lo
            still = grew.abs().amax(1) <= 1e-6
            for side, other, name in ((1, 0, "kernel"), (0, 1, "plain")):
                if bool(still[side]) and float(grew[other, 3]) > 1e-4:
                    return hi, name
            return hi, None

        assert proofs == [one_ray(r) for r in rays]
        assert any(side is None for _m, side in proofs)
        assert any(side == "kernel" for _m, side in proofs)
    finally:
        psw.sweep_march = orig
