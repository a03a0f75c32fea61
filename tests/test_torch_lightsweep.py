"""Parity of the port's light sweep with the JAX package: the plain
versions of kernels B3 (self scan) and B4 (advect-multiply) against the
JAX scans (impl="xla") and the Pallas kernels in interpret mode, both
inter-volume chain branches (full refresh: cumulative product; cohort of
one: masked product), the static precompute and the shaded maps.
Tolerance atol=1e-5 (tests/test_lightsweep.py: Pallas vs scan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, port_per_object, t

from multivolumes_tpu.config import RenderConfig, SharedConsts
from multivolumes_tpu.ops.pallas import lightsweep_kernel as jker
from multivolumes_tpu.render import lightsweep as jls
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch.ops import lightsweep as pops
from multivolumes_tpu_torch.render import lightsweep as pls

ATOL = 1e-5
CFG = RenderConfig(width=64, height=48, grid_size=16, light_grid_size=12,
                   max_ray_samples=16, max_light_samples=12, num_volumes=5,
                   num_volume_srcs=2, cube_map_size=16, shadow_map_size=32)
STEP = SharedConsts.MAX_DIST / CFG.max_light_samples
# light directions whose dominant axis is x, y and z
DIRS = {0: [0.9, 0.3, -0.2], 1: [-0.2, 0.9, 0.3], 2: [0.3, -0.2, -0.9]}


@pytest.fixture(scope="module")
def scene():
    st = jstate.create_scene(CFG)
    return st, jbpo(st.volume_worlds, jnp.eye(4, dtype=jnp.float32))


def _scan_case(c=3, l=12, seed=0):
    rng = np.random.RandomState(seed)
    rho = rng.rand(c, l, l, l).astype(np.float32)
    du = rng.uniform(-1.5, 1.5, c).astype(np.float32)
    dv = rng.uniform(-1.5, 1.5, c).astype(np.float32)
    f = rng.uniform(0.3, 2.0, c).astype(np.float32)
    t_in = rng.rand(c, l, l).astype(np.float32)
    return rho, du, dv, f, t_in


def test_interp_matrix_shift_matches_jax():
    shifts = np.array([-1.7, -0.25, 0.0, 0.6, 2.3], np.float32)
    want = np.stack([np.asarray(jls._interp_matrix_shift(9, s))
                     for s in shifts])
    np.testing.assert_array_equal(n(pops.interp_matrix_shift(9, t(shifts))),
                                  want)


def test_b3_b4_plain_match_pallas_interpret():
    rho, du, dv, f, t_in = _scan_case()
    c, l = rho.shape[:2]
    mv = jnp.stack([jls._interp_matrix_shift(l, s) for s in dv])
    mu = jnp.stack([jls._interp_matrix_shift(l, s) for s in du])
    ones = jnp.ones((c, l, l), jnp.float32)
    here_j, sout_j = jker.light_self_scan_pallas(
        jnp.asarray(rho), mv, mu, ones, ones, jnp.asarray(f),
        jnp.zeros((c,)), jnp.ones((c,)), has_sm=False, interpret=True)
    here_p, sout_p = pops.light_self_scan(t(rho), t(du), t(dv), t(f))
    np.testing.assert_allclose(n(here_p), n(here_j), atol=ATOL)
    np.testing.assert_allclose(n(sout_p), n(sout_j), atol=ATOL)
    out_j = jker.light_advect_mul_pallas(here_j, jnp.asarray(t_in), mv, mu,
                                         interpret=True)
    out_p = pops.light_advect_mul(here_p, t(t_in), t(du), t(dv))
    np.testing.assert_allclose(n(out_p), n(out_j), atol=ATOL)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("branch", ["full", "cohort"])
def test_light_transmittance_matches_xla(scene, axis, branch):
    st, po = scene
    ld = np.asarray(DIRS[axis], np.float32)
    ld /= np.linalg.norm(ld)
    if branch == "full":
        sub, cache = None, None
        rho = st.rho_light[st.vol_tex_ids]
    else:  # a cohort of one: 4 * 1 <= 5 volumes takes the masked product
        sub = jnp.array([3], jnp.int32)
        cache = jnp.asarray(np.random.RandomState(axis).uniform(
            0.2, 1.0, (CFG.num_volumes, 12, 12)).astype(np.float32))
        rho = st.rho_light[st.vol_tex_ids[sub]]
    tj, sj = jax.jit(lambda r: jls.light_transmittance(
        r, po, jnp.asarray(ld), STEP, sub_ids=sub, sout_cache=cache,
        return_sout=True, impl="xla", static_axis=axis))(rho)
    tp, sp = pls.light_transmittance(
        t(rho), port_per_object(po), t(ld), STEP, axis,
        sub_ids=None if sub is None else torch.tensor([3]),
        sout_cache=None if cache is None else t(cache))
    np.testing.assert_allclose(n(tp), n(tj), atol=ATOL)
    np.testing.assert_allclose(n(sp), n(sj), atol=ATOL)


def test_light_transmittance_matches_pallas_path(scene):
    """The JAX production path (Pallas kernels in interpret mode)."""
    st, po = scene
    ld = np.asarray(DIRS[2], np.float32)
    ld /= np.linalg.norm(ld)
    rho = st.rho_light[st.vol_tex_ids]
    tj = jax.jit(lambda r: jls.light_transmittance(
        r, po, jnp.asarray(ld), STEP, impl="pallas", static_axis=2))(rho)
    tp, _ = pls.light_transmittance(t(rho), port_per_object(po), t(ld),
                                    STEP, 2)
    np.testing.assert_allclose(n(tp), n(tj), atol=ATOL)


def test_precompute_static_matches_jax(scene):
    st, _ = scene
    got = pls.precompute_static(t(st.volumes), 12, 12)
    want = jax.jit(jls.precompute_static, static_argnums=(1, 2))(
        st.volumes, 12, 12)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), atol=ATOL)


@pytest.mark.parametrize("probe", [True, False])
def test_light_maps_match_jax(scene, probe):
    """Shaded maps of a full refresh (`ray_march_light_sweep_update`)."""
    st, po = scene
    args = (st.rho_light, st.ao_static, st.grad_dir, st.vol_tex_ids, po)
    maps_j, sout_j = jax.jit(lambda: jls.ray_march_light_sweep_update(
        *args, None, None, st.light_pos, st.light_color, st.ambient,
        st.sh_coeffs, CFG.max_light_samples, has_light_probe=probe,
        impl="xla", static_axis=2))()
    maps_p, sout_p = pls.ray_march_light_sweep_update(
        t(st.rho_light), t(st.ao_static), t(st.grad_dir),
        torch.from_numpy(np.asarray(st.vol_tex_ids).astype(np.int64)),
        port_per_object(po), t(st.light_pos), t(st.light_color),
        t(st.ambient), t(st.sh_coeffs), CFG.max_light_samples, 2,
        has_light_probe=probe)
    np.testing.assert_allclose(n(maps_p), n(maps_j), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(n(sout_p), n(sout_j), atol=ATOL)


# --- what the cluster-banded self scan (csrc/lightsweep.cu) relies on -------

@pytest.mark.parametrize("n_bands", [1, 2, 8])
@pytest.mark.parametrize("l", [16, 20])
@pytest.mark.parametrize("shift", [-1.0, -0.37, 0.0, 0.5, 1.0, 2.6])
def test_bshift_lerp_by_row_bands_is_the_whole_plane(shift, l, n_bands):
    """Each band of rows computed from its own rows plus the rows its taps
    name, fetched from their owner band, equals the whole-plane lerp bit
    for bit (L = 20 on 8 bands is ragged: bands of 3 rows, the last of 2,
    one empty)."""
    rng = np.random.RandomState(int(l * 10 + n_bands))
    x = t(rng.rand(2, l, l))
    dv = t(np.array([shift, -shift], np.float32))
    du = t(np.array([0.3 * shift, shift], np.float32))
    taps_v, taps_u = pops.shift_taps(l, dv), pops.shift_taps(l, du)
    rows = pops.band_rows(l, n_bands)
    assert rows[0][0] == 0 and max(hi for _lo, hi in rows) == l
    assert all(a[1] == b[0] or b[0] == l for a, b in zip(rows, rows[1:]))
    whole = pops.bshift_lerp(x, taps_v, taps_u)
    banded = pops.bshift_lerp_bands(x, taps_v, taps_u, n_bands)
    assert torch.equal(whole, banded)
    # and it is the shear itself
    mv, mu = pops.interp_matrix_shift(l, dv), pops.interp_matrix_shift(l, du)
    np.testing.assert_allclose(n(banded), n(pops._bshift(x, mv, mu)),
                               atol=1e-6)


def test_attenuation_ahead_is_the_per_slice_attenuation():
    """The attenuation taken out of the serial chain: computed for all
    slices before the scan it equals the per-slice value bit for bit, and
    a scan that only multiplies by it equals the plain scan bit for bit."""
    rho, du, dv, f, _t = _scan_case(c=3, l=12, seed=4)
    rho[0, :, :2] = 1.0          # 1 - 0.8 rho = 0.2
    rho[1, 3] = 1.25             # the clamp max(1 - 0.8 rho, 1e-7)
    ahead = pops.atten_ahead(t(rho), t(f))
    for k in range(rho.shape[1]):
        assert torch.equal(ahead[:, k], pops._atten(t(rho)[:, k], t(f)))
    assert float(ahead.min()) < 1e-3 and float(ahead.max()) > 0.99
    l = rho.shape[1]
    mu, mv = pops.interp_matrix_shift(l, t(du)), \
        pops.interp_matrix_shift(l, t(dv))
    s = torch.ones((3, l, l))
    here = torch.empty((3, l, l, l))
    for k in range(l):
        here[:, k] = pops._bshift(s, mv, mu)
        s = here[:, k] * ahead[:, k]
    here_p, sout_p = pops.light_self_scan_plain(t(rho), t(du), t(dv), t(f))
    assert torch.equal(here, here_p) and torch.equal(s, sout_p)


# --- what the cluster-banded advect-multiply (B4) relies on -----------------

@pytest.mark.parametrize("n_bands", [1, 2, 8])
@pytest.mark.parametrize("l", [16, 20])
def test_advect_mul_by_row_bands_matches_plain(l, n_bands):
    """B4 as the kernel's cluster evaluates it: the carry started from the
    bands of a t_in that varies over the plane, sheared band by band in
    the 2-tap order, times here_k, equals `light_advect_mul_plain` (the
    dense matrix products) at the kernel's tolerance; shifts negative,
    fractional and beyond one texel, one per cohort volume."""
    shifts = np.array([-2.6, -1.0, -0.37, 0.0, 0.5, 1.7], np.float32)
    rng = np.random.RandomState(l + n_bands)
    c = shifts.shape[0]
    here = t(rng.rand(c, l, l, l))
    t_in = t(0.2 + 0.8 * rng.rand(c, l, l))
    du, dv = t(0.6 * shifts[::-1].copy()), t(shifts)
    want = pops.light_advect_mul_plain(here, t_in, du, dv)
    got = pops.advect_mul_bands(here, t_in, du, dv, n_bands)
    np.testing.assert_allclose(n(got), n(want), atol=ATOL)
    # the carry's start matters: from 1 instead of t_in it is another field
    ones = pops.advect_mul_bands(here, torch.ones_like(t_in), du, dv, n_bands)
    assert float((ones - want).abs().max()) > 1e-2
