"""B10 and B11, the light cohort update's prologue and epilogue around B3 /
B4 (`ops/lightsweep_prep.py`), against the plain version.

On the CPU: the dispatch rule (CPU tensors take the plain path unchanged,
`impl="kernel"` raises, a CPU frame counts no B10 / B11 launch), the
stores of `store=`, and the kernels' rules stated in PyTorch (the light
rank by counting, the entry and exit taps, the occlusion chain by taps)
against the plain version's `argsort`, `_resample_matrix` and products.

On the card (marked `cuda`, skipped without one), at the demo's sizes (N
= 64 and 16, L = 96, a cohort of one and the full refresh): the cohort
update through B10 -> B3 / B3' -> B10b -> B4 -> B11 against the plain glue
around the same B3 / B4 kernels and the plain stores, for a cohort volume
first, in the middle and last in light order, without a shadow map, with
the test torus's 1024^2 map and with a map that cuts through the volumes,
along all three sweep axes in both directions. Bit-equal: the geometry
scalars, B3's density and shadow scalars, the footprint cache and B11 on
the same fields; held to 1e-4 + 1e-4 rel: sm_vol, z_entry, t_ins and the
maps. The checks fail for a prologue without the volumes ahead or without
the shadow entry and for an epilogue without the AO / SH term. This file
imports neither JAX nor the JAX package, so on the machine with the card

    python -m pytest --noconftest -m cuda tests/test_torch_light_prep.py -q -s
"""

import contextlib
import dataclasses

import pytest
import torch
from torch_parity import cuda_device, write_test_mesh
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig, SharedConsts
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.ops import lightsweep as light_ops
from multivolumes_tpu_torch.ops import lightsweep_prep as prep_ops
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import lightsweep as ls
from multivolumes_tpu_torch.render import mesh as mesh_lib
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene import state as state_lib

LIMIT = (1e-4, 1e-4)     # atol, rtol where the plain version is a product
TINY = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=12,
                    max_ray_samples=16, max_light_samples=12, num_volumes=9,
                    num_volume_srcs=2, cube_map_size=16, shadow_map_size=64)
# light positions: each sweep axis, toward + (a flipped sweep) and -
LIGHTS = {"z+": (20.0, 30.0, 90.0), "z-": (-20.0, 30.0, -90.0),
          "y+": (20.0, 90.0, -30.0), "y-": (20.0, -90.0, 30.0),
          "x+": (90.0, 20.0, 30.0), "x-": (-90.0, 20.0, -30.0)}
KERNELS = ("light_prologue", "light_occlusion", "light_epilogue")


def _update(st, po, light_pos, axis, ids=None, sout=None, sm=None, vp=None,
            **kw):
    return ls.ray_march_light_sweep_update(
        st.rho_light, st.ao_static, st.grad_dir, st.vol_tex_ids, po,
        light_pos, st.light_color, st.ambient, st.sh_coeffs,
        TINY.max_light_samples, axis,
        sub_ids=ids, sout_cache=sout, shadow_map=sm, shadow_vp=vp, **kw)


@pytest.fixture(scope="module")
def tiny():
    st = state_lib.create_scene(TINY, device="cpu")
    return st, build_per_object(st.volume_worlds, torch.eye(4))


# --- the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("mesh", [False, True], ids=["free", "shadow"])
def test_cpu_takes_the_plain_path(tiny, mesh):
    st, po = tiny
    sm = torch.rand(64, 64, generator=torch.Generator().manual_seed(3))
    vp = torch.eye(4) * 0.02
    vp[3, 2], vp[3, 3] = 0.5, 1.0
    args = dict(sm=sm, vp=vp) if mesh else {}
    ids = torch.tensor([4])
    ops.reset_launches()
    a = _update(st, po, st.light_pos, 2, ids, st.light_sout.clone(), **args)
    b = _update(st, po, st.light_pos, 2, ids, st.light_sout.clone(),
                impl="plain", **args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES
    with pytest.raises(ValueError):
        _update(st, po, st.light_pos, 2, ids, st.light_sout.clone(),
                impl="kernel", **args)


def test_the_wrappers_refuse_cpu_tensors(tiny):
    st, po = tiny
    with pytest.raises(ValueError, match="CUDA"):
        prep_ops.light_prologue(st.rho_light, st.vol_tex_ids,
                                torch.tensor([0]), po, torch.ones(3) / 3,
                                0.3, 2)


def test_a_cpu_frame_counts_no_light_kernel(tiny):
    st, _po = tiny
    cam = cam_lib.orbit_camera(0.0, TINY.aspect_ratio, device="cpu")
    own = dataclasses.replace(st, light_maps=st.light_maps.clone(),
                              light_sweep=st.light_sweep.clone(),
                              light_sout=st.light_sout.clone())
    ops.reset_launches()
    frame_lib.render_frame(own, cam, TINY.with_(light_axis=2))
    assert all(ops.LAUNCHES[k] == 0 for k in KERNELS), ops.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_store_writes_the_cohort_rows(tiny, dtype):
    st, po = tiny
    ids = torch.tensor([2, 7])
    want, sout_w = _update(st, po, st.light_pos, 2, ids,
                           st.light_sout.clone())
    maps = torch.rand_like(st.light_maps)
    sweep = torch.rand(st.light_sweep.shape).to(dtype)
    keep_m, keep_s = maps.clone(), sweep.clone()
    got, sout = _update(st, po, st.light_pos, 2, ids, st.light_sout.clone(),
                        store=(maps, sweep, ids))
    assert got is None and torch.equal(sout, sout_w)
    assert torch.equal(maps[ids], want)
    assert torch.equal(sweep[ids], state_lib.to_light_sweep(want, dtype))
    rest = torch.ones(maps.shape[0], dtype=torch.bool)
    rest[ids] = False
    assert torch.equal(maps[rest], keep_m[rest])
    assert torch.equal(sweep[rest], keep_s[rest])


@pytest.mark.parametrize("case", ["random", "ties", "signed-zeros"])
def test_light_ranks_by_counting_equal_argsort(case):
    g = torch.Generator().manual_seed(7)
    key = torch.randn(40, generator=g)
    if case == "ties":
        key = torch.round(key * 2.0) / 2.0
    elif case == "signed-zeros":
        key[::3] = 0.0
        key[1::6] = -0.0
    want = torch.argsort(torch.argsort(key, stable=True), stable=True)
    assert torch.equal(prep_ops.light_ranks(key), want)


def _geometry(po, light_pos, axis, l):
    ld = torch.tensor(light_pos, dtype=torch.float32)
    return ls.shear_geometry(po, ld / ld.norm(), 0.3, axis, l)


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_light_ranks_of_the_scene_equal_the_plain_order(tiny, light):
    _st, po = tiny
    axis = "xyz".index(light[0])
    ld = torch.tensor(LIGHTS[light])
    ld = ld / ld.norm()
    geo = ls.shear_geometry(po, ld, 0.3, axis, 12)
    w = po.world[:, 3, :3]
    key = -(w[:, 0] * ld[0] + w[:, 1] * ld[1] + w[:, 2] * ld[2])
    assert torch.equal(prep_ops.light_ranks(key),
                       torch.argsort(geo.order, stable=True))


@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_entry_and_exit_taps_equal_the_resample_rows(tiny, light):
    _st, po = tiny
    l, g = 12, 24
    geo = _geometry(po, LIGHTS[light], "xyz".index(light[0]), l)
    i0, w0, w1 = prep_ops.entry_taps(l, g, geo.sv, geo.ov)
    dense = torch.zeros(i0.shape[0], l, g)
    dense.scatter_(2, i0[..., None], w0[..., None])
    dense.scatter_add_(2, torch.clamp(i0 + 1, max=g - 1)[..., None],
                       w1[..., None])
    assert torch.equal(dense, ls._resample_matrix(l, g, geo.sv, geo.ov))
    i0, w0, w1 = prep_ops.exit_taps(g, l, geo.su, geo.ou_o)
    rows = torch.arange(g, dtype=torch.float32)[:, None]
    cols = torch.arange(l, dtype=torch.float32)[None, :]
    want = torch.clamp(1.0 - ((rows - geo.ou_o[:, None, None])
                              / geo.su[:, None, None] - cols).abs(), min=0.0)
    dense = torch.zeros(i0.shape[0], g, l + 2)     # a column either side
    dense.scatter_(2, torch.clamp(i0 + 1, 0, l + 1)[..., None],
                   w0[..., None])
    dense.scatter_add_(2, torch.clamp(i0 + 2, 0, l + 1)[..., None],
                       w1[..., None])
    assert torch.equal(dense[..., 1:l + 1], want)
    assert (want.sum(-1) > 0).any() and (want.sum(-1) == 0).any()


@pytest.mark.parametrize("cohort", ["one", "three", "all"])
@pytest.mark.parametrize("light", ["z-", "z+", "x+"])
def test_occlusion_by_taps_matches_the_plain_chain(tiny, light, cohort):
    _st, po = tiny
    l, g = 12, 24
    geo = _geometry(po, LIGHTS[light], "xyz".index(light[0]), l)
    ranks = torch.argsort(geo.order, stable=True)
    sub = {"one": geo.order[-1:], "three": geo.order[[0, 4, 8]],
           "all": torch.arange(9)}[cohort]
    sout = 0.1 + 0.8 * torch.rand(9, l, l,
                                  generator=torch.Generator().manual_seed(5))
    mu = ls._resample_matrix(l, g, geo.su[sub], geo.ou[sub])
    mv = ls._resample_matrix(l, g, geo.sv[sub], geo.ov[sub])
    want = ls.occlusion_entry(geo, sout, sub, mv, mu)
    got = prep_ops.occlusion_by_taps(
        sout, ranks, sub, geo.su, geo.sv, geo.ou_o, geo.ov_o, geo.su[sub],
        geo.ou[sub], geo.sv[sub], geo.ov[sub], l)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert float(want.min()) < 0.9     # the volumes ahead occlude
    # without the volumes ahead the chain is not the plain one
    free = prep_ops.occlusion_by_taps(
        sout, torch.zeros_like(ranks), sub, geo.su, geo.sv, geo.ou_o,
        geo.ov_o, geo.su[sub], geo.ou[sub], geo.sv[sub], geo.ov[sub], l)
    assert not torch.allclose(free, want, atol=1e-3)


# --- the card --------------------------------------------------------------

DEMO = dict(width=1280, height=800, grid_size=128, light_grid_size=96,
            max_ray_samples=256, max_light_samples=96, num_volume_srcs=10,
            cube_map_size=128, shadow_map_size=1024)


def _step():
    return SharedConsts.MAX_DIST / DEMO["max_light_samples"]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """{n: (engine state, per_object)} of the demo at N = 64 and 16 with
    the test torus (its shadow map, the default light), on the card."""
    dev = cuda_device()
    mesh = write_test_mesh(tmp_path_factory.mktemp("mesh") / "torus.obj",
                           69960)
    out = {}
    for n in (64, 16):
        eng = MultiRayCaster(RenderConfig(**DEMO, num_volumes=n), device=dev)
        eng.set_mesh(mesh)
        st = eng.state
        out[n] = (st, build_per_object(st.volume_worlds, torch.eye(
            4, device=dev)), mesh_lib.shadow_view_proj(st))
    return out


@contextlib.contextmanager
def _recorded():
    """Record B3's and B4's operands and outputs on the path's calls."""
    rec = {}
    scan, advect = light_ops.light_self_scan, light_ops.light_advect_mul

    def scan_rec(rho_o, du, dv, f_corr, impl=None, **sm):
        out = scan(rho_o, du, dv, f_corr, impl=impl, **sm)
        rec["scan"] = dict(rho_o=rho_o.clone(), du=du.clone(),
                           dv=dv.clone(), f_corr=f_corr.clone(),
                           **{k: v.clone() for k, v in sm.items()})
        rec["here"], rec["s_out"] = (x.clone() for x in out)
        return out

    def advect_rec(here, t_in, du, dv, impl=None):
        out = advect(here, t_in, du, dv, impl=impl)
        rec["t_ins"], rec["fields"] = t_in.clone(), out.clone()
        return out

    light_ops.light_self_scan = scan_rec
    light_ops.light_advect_mul = advect_rec
    try:
        yield rec
    finally:
        light_ops.light_self_scan, light_ops.light_advect_mul = scan, advect


def _explain_by_e0(rep, sp, rerun, want):
    """Maps beyond the limit must come from e0 alone: B3' divides e by
    soft (about 1e-4 of light-space depth), so an ulp of e0 moves lit by
    ~1e-3 where a voxel straddles the mesh's depth. e0 must be within 4
    ulps of its largest value, and with the plain version's sm_vol and
    z_entry in B10's place (`rerun`) every element within the limit."""
    assert "e0" in rep, rep
    assert rep["e0"] <= 4 * float(torch.finfo(torch.float32).eps) \
        * float(sp["sm_vol"].abs().max()), rep
    with _with_plain_entry(sp):
        got = rerun()
    assert _beyond(got, want)[0] == 0, rep


@contextlib.contextmanager
def _with_plain_entry(sp):
    """B3' takes the plain version's sm_vol and z_entry in place of
    B10's."""
    scan = light_ops.light_self_scan

    def swapped(rho_o, du, dv, f_corr, impl=None, **sm):
        if sm:
            sm = dict(sm, sm_vol=sp["sm_vol"], z_entry=sp["z_entry"])
        return scan(rho_o, du, dv, f_corr, impl=impl, **sm)

    light_ops.light_self_scan = swapped
    try:
        yield
    finally:
        light_ops.light_self_scan = scan


def _cut_map(st, po, light_pos, axis, ids, vp):
    """A shadow map whose depths are drawn (seeded) across the cohort
    volume's light-space depth range, so that the compare of B3' lights part
    of it and shadows the rest."""
    size = DEMO["shadow_map_size"]
    probe = torch.full((size, size), 1.0, device=vp.device)
    with _recorded() as rec:
        _plain(st, po, light_pos, axis, ids, probe, vp,
               st.light_sout.clone())
    z = rec["scan"]["z_entry"]
    far = z + DEMO["light_grid_size"] * rec["scan"]["dz_slice"][:, None,
                                                               None]
    lo = float(torch.minimum(z, far).min())
    hi = float(torch.maximum(z, far).max())
    g = torch.Generator(device=vp.device).manual_seed(11)
    return lo + (hi - lo) * torch.rand((size, size), generator=g,
                                       device=vp.device)


def _plain(st, po, light_pos, axis, ids, sm=None, vp=None, sout=None,
           maps=None, sweep=None):
    """The parent's cohort update: the plain glue around the B3 / B4
    kernels, the plain shade and the frame's stores."""
    ld = light_pos[:3] / torch.linalg.norm(light_pos[:3])
    tex = st.vol_tex_ids if ids is None else st.vol_tex_ids[ids]
    rho = st.rho_light[tex]
    shadow, sout = ls.light_transmittance(
        rho, po, ld, _step(), axis, sub_ids=ids,
        sout_cache=sout, shadow_map=sm, shadow_vp=vp)
    out = ls._shade_light_fields(shadow, rho, tex, st.ao_static,
                                 st.grad_dir, st.sh_coeffs, st.ambient,
                                 st.light_color, True)
    if maps is not None:
        maps[ids] = out
        sweep[ids] = state_lib.to_light_sweep(out, sweep.dtype)
    return out, sout


def _kernel(st, po, light_pos, axis, ids, sm=None, vp=None, sout=None,
            store=None, sh=None):
    return ls.ray_march_light_sweep_update(
        st.rho_light, st.ao_static, st.grad_dir, st.vol_tex_ids, po,
        light_pos, st.light_color, st.ambient,
        st.sh_coeffs if sh is None else sh, DEMO["max_light_samples"], axis,
        sub_ids=ids,
        sout_cache=sout, shadow_map=sm, shadow_vp=vp, store=store)


def _beyond(got, want):
    """Elements of `got` beyond 1e-4 + 1e-4 |want| of `want`, max error."""
    err = (got - want).abs()
    return int((err > LIMIT[0] + LIMIT[1] * want.abs()).sum()), \
        float(err.max())


def _maps_pass(got, want) -> bool:
    return _beyond(got, want)[0] == 0


def _light(name, dev):
    return torch.tensor([*LIGHTS[name], 1.0], device=dev)


def _cohort_case(st, po, vp, light_pos, axis, ids, mesh):
    """One cohort update both ways -> its error report; asserts the
    rounding rule."""
    sm = None
    if mesh == "torus":
        sm = st.mesh_shadow_map
    elif mesh == "cut":
        sm = _cut_map(st, po, light_pos, axis, ids, vp)
    vp_ = None if sm is None else vp
    maps_p, sweep_p = st.light_maps.clone(), st.light_sweep.clone()
    maps_k, sweep_k = st.light_maps.clone(), st.light_sweep.clone()
    sout_p, sout_k = st.light_sout.clone(), st.light_sout.clone()
    with _recorded() as rp:
        _plain(st, po, light_pos, axis, ids, sm, vp_, sout_p, maps_p,
               sweep_p)
    ops.reset_launches()
    with _recorded() as rk:
        got, sout = _kernel(st, po, light_pos, axis, ids, sm, vp_, sout_k,
                            store=(maps_k, sweep_k, ids))
    torch.cuda.synchronize()
    assert got is None and sout is sout_k
    assert all(ops.LAUNCHES[k] == 1 for k in KERNELS), ops.LAUNCHES
    sp, sk = rp["scan"], rk["scan"]
    assert sp.keys() == sk.keys()
    for k in ("rho_o", "du", "dv", "f_corr", "dz_slice", "soft"):
        if k in sp:
            assert torch.equal(sk[k], sp[k]), k
    rep = {}
    for k in ("sm_vol", "z_entry"):
        if k in sp:
            n_out, rep[k] = _beyond(sk[k], sp[k])
            assert n_out == 0, (k, rep[k])
    if "sm_vol" in sp:
        rep["e0"] = float(((sk["sm_vol"] - sk["z_entry"])
                           - (sp["sm_vol"] - sp["z_entry"])).abs().max())
    n_out, rep["t_ins"] = _beyond(rk["t_ins"], rp["t_ins"])
    assert n_out == 0, rep
    # the footprint cache: B3's rows at the cohort, the rest untouched
    assert torch.equal(sout_k[ids], rk["s_out"])
    rest = torch.ones(sout_k.shape[0], dtype=torch.bool, device=ids.device)
    rest[ids] = False
    assert torch.equal(sout_k[rest], st.light_sout[rest])
    assert torch.equal(sout_p[ids], rp["s_out"])
    # the maps: within the limit, the other rows untouched; the sweep rows
    # the cast of the f32 rows, channel 3 zero
    rep["maps_beyond"], rep["maps"] = _beyond(maps_k[ids], maps_p[ids])
    if rep["maps_beyond"]:
        def again():
            out = st.light_maps.clone()
            _kernel(st, po, light_pos, axis, ids, sm, vp_,
                    st.light_sout.clone(),
                    store=(out, st.light_sweep.clone(), ids))
            return out[ids]

        _explain_by_e0(rep, sp, again, maps_p[ids])
    assert torch.equal(maps_k[rest], st.light_maps[rest])
    assert torch.equal(sweep_k[rest], st.light_sweep[rest])
    assert torch.equal(sweep_k[ids], state_lib.to_light_sweep(
        maps_k[ids], sweep_k.dtype))
    # B11 alone on the plain path's own B4 output: bit-equal
    prep = prep_ops.light_prologue(
        st.rho_light, st.vol_tex_ids, ids, po,
        light_pos[:3] / torch.linalg.norm(light_pos[:3]),
        _step(), axis)
    m2, s2 = st.light_maps.clone(), st.light_sweep.clone()
    prep_ops.light_epilogue(rp["fields"], prep, st.rho_light, st.ao_static,
                            st.grad_dir, st.vol_tex_ids, st.sh_coeffs,
                            st.ambient, st.light_color, True,
                            store=(m2, s2, ids))
    assert torch.equal(m2, maps_p) and torch.equal(s2, sweep_p)
    rep["equal_here"] = bool(torch.equal(rk["here"], rp["here"]))
    return rep


def _order(po, light_pos, axis):
    ld = light_pos[:3] / torch.linalg.norm(light_pos[:3])
    return ls.shear_geometry(po, ld, 1.0, axis,
                             DEMO["light_grid_size"]).order


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 16])
def test_cohort_update_matches_plain(demo, n):
    st, po, vp = demo[n]
    dev = st.rho_light.device
    cases = [("default", st.light_pos, 2, "torus")]
    cases += [(name, _light(name, dev), "xyz".index(name[0]), mesh)
              for name in sorted(LIGHTS) for mesh in ("none", "cut")]
    worst = {}
    for name, light_pos, axis, mesh in cases:
        order = _order(po, light_pos, axis)
        for where, at in (("first", 0), ("middle", n // 2), ("last", -1)):
            ids = order[at:at + 1] if at != -1 else order[-1:]
            rep = _cohort_case(st, po, vp, light_pos, axis, ids, mesh)
            print(f"[light] N={n} {name} {mesh} {where}: {rep}")
            for k, v in rep.items():
                if isinstance(v, float):
                    worst[k] = max(worst.get(k, 0.0), v)
    print(f"[light] N={n} largest errors: {worst}")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["none", "cut"])
@pytest.mark.parametrize("n", [64, 16])
def test_full_refresh_matches_plain(demo, n, mesh):
    """C = N, as `create_scene` and the engine's refresh run it: no cohort
    ids, no footprint cache, the maps returned."""
    st, po, vp = demo[n]
    dev = st.rho_light.device
    for name in ("z-", "x+"):
        light_pos = _light(name, dev)
        axis = "xyz".index(name[0])
        sm = None
        if mesh == "cut":
            sm = _cut_map(st, po, light_pos, axis,
                          _order(po, light_pos, axis)[-1:], vp)
        vp_ = None if sm is None else vp
        with _recorded() as rp:
            want, sout_w = _plain(st, po, light_pos, axis, None, sm, vp_)
        with _recorded() as rk:
            got, sout = _kernel(st, po, light_pos, axis, None, sm, vp_)
        for k in ("rho_o", "du", "dv", "f_corr"):
            assert torch.equal(rk["scan"][k], rp["scan"][k]), k
        rep = {}
        if sm is not None:
            sp, sk = rp["scan"], rk["scan"]
            rep["e0"] = float(((sk["sm_vol"] - sk["z_entry"])
                               - (sp["sm_vol"] - sp["z_entry"])).abs().max())
        n_t, rep["t_ins"] = _beyond(rk["t_ins"], rp["t_ins"])
        rep["maps_beyond"], rep["maps"] = _beyond(got, want)
        assert torch.equal(sout, rk["s_out"])
        print(f"[light] full refresh N={n} {name} {mesh}: {rep}, "
              f"footprints equal {bool(torch.equal(sout, sout_w))}")
        assert n_t == 0, rep
        if rep["maps_beyond"]:
            _explain_by_e0(rep, rp["scan"], lambda: _kernel(
                st, po, light_pos, axis, None, sm, vp_)[0], want)


@pytest.mark.cuda
def test_the_checks_fail_without_each_term(demo, monkeypatch):
    """The map check of `_cohort_case` fails for a prologue that drops the
    volumes ahead (g_in = 1) or the shadow entry, and for an epilogue that
    skips the AO / SH term. B3' takes the plain version's entry planes on
    every run here, so that no e0 ulp moves a voxel of the penumbra."""
    st, po, vp = demo[64]
    light_pos = _light("z-", st.rho_light.device)
    ids = _order(po, light_pos, 2)[-1:]       # last: every volume ahead
    sm = _cut_map(st, po, light_pos, 2, ids, vp)
    with _recorded() as rp:
        want, _ = _plain(st, po, light_pos, 2, ids, sm, vp,
                         st.light_sout.clone())
    assert float(rp["t_ins"].min()) < 0.9     # the volumes ahead occlude

    def run(**kw):
        with _with_plain_entry(rp["scan"]):
            return _kernel(st, po, light_pos, 2, ids, sm, vp,
                           st.light_sout.clone(), **kw)[0]

    assert _maps_pass(run(), want)
    # the epilogue without the AO / SH term
    assert not _maps_pass(run(sh=torch.zeros_like(st.sh_coeffs)), want)
    # the prologue without the volumes ahead
    occlusion = prep_ops.light_occlusion
    monkeypatch.setattr(prep_ops, "light_occlusion",
                        lambda *a, **k: torch.ones_like(occlusion(*a, **k)))
    assert not _maps_pass(run(), want)
    monkeypatch.setattr(prep_ops, "light_occlusion", occlusion)
    # the prologue without the shadow entry
    prologue = prep_ops.light_prologue
    monkeypatch.setattr(prep_ops, "light_prologue",
                        lambda *a, **k: prologue(*a, **k)._replace(sm={}))
    assert not _maps_pass(run(), want)


@pytest.mark.cuda
def test_a_frame_launches_each_light_kernel_once(demo):
    st, _po, _vp = demo[16]
    cfg = RenderConfig(**DEMO, num_volumes=16)
    cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio,
                               device=st.rho_light.device)
    for show_mesh in (False, True):
        own = dataclasses.replace(
            st, light_maps=st.light_maps.clone(),
            light_sweep=st.light_sweep.clone(),
            light_sout=st.light_sout.clone())
        ops.reset_launches()
        frame_lib.render_frame(own, cam, cfg, show_mesh=show_mesh)
        torch.cuda.synchronize()
        assert all(ops.LAUNCHES[k] == 1 for k in KERNELS), ops.LAUNCHES
        assert ops.LAUNCHES["light_self_scan_sm"] == int(show_mesh), \
            ops.LAUNCHES
