"""Sweep-based light maps: shear-warp transmittance propagation.

Counterpart of `multivolumes_tpu/render/lightsweep.py`: the sweep axis
is static (the engine derives it from the light direction,
`light_axis`), and the two L-step scans run through the B3/B4 kernel
wrappers in `ops/lightsweep.py`. With the opaque mesh, its shadow map is
sampled once per ray on the global lateral grid (the light view is
orthographic, so a ray's shadow-map texel is constant along it; a direct
4-tap bilinear read), resampled to each cohort volume's entry plane, and
compared per slice inside B3's shadow-map variant. See the JAX module for
the method and its documented deviations from the reference's per-voxel
light march.

On CUDA tensors a cohort update (`ray_march_light_sweep_update`) is five
launches: B10's prologue (`ops/lightsweep_prep.py:light_prologue`: the
shear geometry, B3's operands, the shadow entry), B3 or B3' (the self
scan), B10's occlusion chain (`light_occlusion`: t_ins and the footprint
cache), B4 (the advect-multiply) and B11 (`light_epilogue`: the shade and
the stores of the light-map rows). The functions below are their plain
version: `prologue_plain` and `shear_geometry` (B10a), `occlusion_entry`
(B10b), `orient_back` with `_shade_light_fields` and the stores (B11);
CPU tensors and `impl="plain"` take it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch.core import sh as sh_lib
from multivolumes_tpu_torch.ops import lightsweep as light_ops
from multivolumes_tpu_torch.ops import lightsweep_prep as prep_ops
from multivolumes_tpu_torch.ops.trilinear import indexed_trilinear_soa
from multivolumes_tpu_torch.render.perframe import PerObject
from multivolumes_tpu_torch.utils import timing

ABSORPTION = SharedConsts.ABSORPTION
ZERO_THRESHOLD = SharedConsts.ZERO_THRESHOLD
MAX_DIST = SharedConsts.MAX_DIST


def light_axis(light_pos) -> int:
    """Dominant axis of the light direction (ties: z, then y), the static
    sweep axis. Reads the light position on the host."""
    ax, ay, az = (abs(float(x)) for x in light_pos[:3].tolist())
    return 2 if (az >= ax and az >= ay) else (1 if ay >= ax else 0)


def _resample_matrix(n_out: int, n_in: int, scale, offset, device=None):
    """(..., n_out, n_in) linear resample: src coord = i*scale + offset.
    scale/offset: python floats or (C,) tensors."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=device)
    rows = torch.arange(n_out, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    src = torch.clamp(rows * scale[..., None, None] + offset[..., None, None],
                      0.0, n_in - 1.0)
    return torch.clamp(1.0 - (src - cols).abs(), min=0.0)


def densities_at_light_grid(volumes, l: int):
    """Resample each source's density channel to the light grid:
    (N_src, D, H, W, 4) -> (N_src, L, L, L). Separable matmuls."""
    d, h, w = volumes.shape[1:4]
    rho = volumes[..., 3].float()
    dev = volumes.device

    def axis_mat(nn):
        return _resample_matrix(l, nn, nn / l, 0.5 * nn / l - 0.5, dev)

    out = torch.einsum("ad,sdhw->sahw", axis_mat(d), rho)
    out = torch.einsum("bh,sahw->sabw", axis_mat(h), out)
    return torch.einsum("cw,sabw->sabc", axis_mat(w), out)


class ShearGeometry(NamedTuple):
    """`light_transmittance`'s per-volume geometry, all (N,) unless said:
    the light order, the orientation flag, the shifts per slice and the
    opacity correction, the entry plane (w_in, sgn), the global lateral
    bounds (0-dim) and the entry / exit resample of each volume onto the
    global (G, G) map."""
    order: torch.Tensor
    flip: torch.Tensor
    du: torch.Tensor
    dv: torch.Tensor
    f_corr: torch.Tensor
    scales: torch.Tensor
    sgn: torch.Tensor
    w_in: torch.Tensor
    lo_u: torch.Tensor
    lo_v: torch.Tensor
    span_u: torch.Tensor
    span_v: torch.Tensor
    su: torch.Tensor
    sv: torch.Tensor
    ou: torch.Tensor
    ov: torch.Tensor
    ou_o: torch.Tensor
    ov_o: torch.Tensor


def shear_geometry(per_object: PerObject, light_dir_world, step_scale: float,
                   axis: int, l: int) -> ShearGeometry:
    """The shear geometry of every volume for the sweep along `axis` with
    an L-texel light grid (the plain version of B10a's geometry)."""
    g = 2 * l  # global lateral occlusion map resolution
    # local light direction (uniform-scale, unrotated worlds)
    wi = per_object.world_i
    ld = light_dir_world
    lx = ld[0] * wi[:, 0, 0] + ld[1] * wi[:, 1, 0] + ld[2] * wi[:, 2, 0]
    ly = ld[0] * wi[:, 0, 1] + ld[1] * wi[:, 1, 1] + ld[2] * wi[:, 2, 1]
    lz = ld[0] * wi[:, 0, 2] + ld[1] * wi[:, 1, 2] + ld[2] * wi[:, 2, 2]
    norm = torch.rsqrt(torch.clamp(lx * lx + ly * ly + lz * lz, min=1e-20))
    lx, ly, lz = lx * norm, ly * norm, lz * norm

    centers = per_object.world[:, 3, :3]
    scales = per_object.world[:, 0, 0]
    proj = (centers[:, 0] * ld[0] + centers[:, 1] * ld[1]
            + centers[:, 2] * ld[2])
    order = torch.argsort(-proj, stable=True)  # closest to the light first

    # lateral (v, u) and sweep (w) components
    if axis == 0:     # sweep x; lateral (v=y, u=z)
        lu, lv, lw = lz, ly, lx
        cu, cv, cw_axis = centers[:, 2], centers[:, 1], centers[:, 0]
    elif axis == 1:   # sweep y; lateral (v=z, u=x)
        lu, lv, lw = lx, lz, ly
        cu, cv, cw_axis = centers[:, 0], centers[:, 2], centers[:, 1]
    else:             # sweep z; lateral (v=y, u=x)
        lu, lv, lw = lx, ly, lz
        cu, cv, cw_axis = centers[:, 0], centers[:, 1], centers[:, 2]

    # propagation direction d = -light_dir; orient grids so d_w > 0
    dwc = -lw
    flip = dwc < 0.0
    dw_abs = torch.clamp(dwc.abs(), min=1e-6)
    du = (-lu) / dw_abs   # voxels of lateral motion per slice
    dv = (-lv) / dw_abs
    dt_local = (2.0 / l) / dw_abs
    f_corr = dt_local / step_scale

    # reference-plane anchoring (parallel rays x(w) = x_ref + slope * w)
    dw_world = -lw
    dw_safe = torch.where(dw_world.abs() > 1e-6, dw_world,
                          torch.where(dw_world >= 0, 1e-6, -1e-6))
    slope_u = (-lu) / dw_safe
    slope_v = (-lv) / dw_safe
    sgn = torch.sign(dw_safe)
    w_in = cw_axis - sgn * scales
    w_out = cw_axis + sgn * scales

    cu_ref_in = cu - slope_u * w_in
    cv_ref_in = cv - slope_v * w_in
    cu_ref_out = cu - slope_u * w_out
    cv_ref_out = cv - slope_v * w_out
    lo_u = torch.minimum((cu_ref_in - scales).min(),
                         (cu_ref_out - scales).min())
    hi_u = torch.maximum((cu_ref_in + scales).max(),
                         (cu_ref_out + scales).max())
    lo_v = torch.minimum((cv_ref_in - scales).min(),
                         (cv_ref_out - scales).min())
    hi_v = torch.maximum((cv_ref_in + scales).max(),
                         (cv_ref_out + scales).max())
    span_u = torch.clamp(hi_u - lo_u, min=1e-3)
    span_v = torch.clamp(hi_v - lo_v, min=1e-3)

    # per-volume entry/exit resample weights (pure geometry)
    su = (2.0 * scales / l) * (g / span_u)
    ou = ((cu_ref_in - scales - lo_u) / span_u) * g - 0.5 + 0.5 * su
    sv = (2.0 * scales / l) * (g / span_v)
    ov = ((cv_ref_in - scales - lo_v) / span_v) * g - 0.5 + 0.5 * sv
    ou_o = ((cu_ref_out - scales - lo_u) / span_u) * g - 0.5 + 0.5 * su
    ov_o = ((cv_ref_out - scales - lo_v) / span_v) * g - 0.5 + 0.5 * sv
    return ShearGeometry(order, flip, du, dv, f_corr, scales, sgn, w_in,
                         lo_u, lo_v, span_u, span_v, su, sv, ou, ov, ou_o,
                         ov_o)


def occlusion_entry(geo: ShearGeometry, s_out_all, sub, mv_in, mu_in):
    """The global-map chain in light order (the plain version of B10b):
    each cohort volume's incoming occlusion on its entry plane, the
    product of the occlusion factors of every volume ahead of it, from
    the outgoing footprints s_out_all (N, L, L) -> t_ins (C, L, L)."""
    n, l = s_out_all.shape[0], s_out_all.shape[1]
    g = 2 * l
    dev = s_out_all.device
    gu_rows = torch.arange(g, dtype=torch.float32, device=dev)[:, None]
    gu_cols = torch.arange(l, dtype=torch.float32, device=dev)[None, :]
    wu_all = torch.clamp(1.0 - ((gu_rows - geo.ou_o[:, None, None])
                                / geo.su[:, None, None] - gu_cols).abs(),
                         min=0.0)
    wv_all = torch.clamp(1.0 - ((gu_rows - geo.ov_o[:, None, None])
                                / geo.sv[:, None, None] - gu_cols).abs(),
                         min=0.0)
    o_big = torch.einsum("ngl,nlk,nhk->ngh", wv_all, s_out_all, wu_all)
    cover = torch.clamp(wv_all.sum(2)[:, :, None] * wu_all.sum(2)[:, None, :],
                        0.0, 1.0)
    fac = o_big + (1.0 - cover)
    order = geo.order
    ranks = torch.argsort(order, stable=True)  # volume -> light rank
    if sub.shape[0] * 4 <= n:
        # small cohort: one masked product per cohort volume
        mask = ranks[None, :] < ranks[sub][:, None]             # (C, N)
        g_in = torch.where(mask[:, :, None, None], fac[None],
                           1.0).prod(dim=1)                      # (C, G, G)
    else:
        cum = torch.cumprod(fac[order], dim=0)
        g_excl = torch.cat([torch.ones_like(cum[:1]), cum[:-1]], 0)
        g_in = g_excl[ranks[sub]]
    return torch.einsum("cvg,cgh,cuh->cvu", mv_in, g_in, mu_in)


def prologue_plain(rho_light, per_object: PerObject, light_dir_world,
                   step_scale: float, axis: int, sub, shadow_map=None,
                   shadow_vp=None, shadow_bias: float = 0.0027):
    """The plain version of B10a: the shear geometry, the cohort's density
    oriented sweep-major (rho_light (C, L, L, L) of the cohort `sub`),
    its entry resample matrices and the shadow operands of B3' -> (geo, rho_o,
    mv_in (C, L, G), mu_in (C, L, G), sm_args: {} or sm_vol, z_entry,
    dz_slice, soft)."""
    l = rho_light.shape[1]
    dev = rho_light.device
    g = 2 * l  # global lateral occlusion map resolution
    geo = shear_geometry(per_object, light_dir_world, step_scale, axis, l)

    # orient: sweep axis leading as dim 1, lateral (v, u) = dims 2, 3
    if axis == 0:
        rho_a = rho_light.permute(0, 3, 2, 1)
    elif axis == 1:
        rho_a = rho_light.permute(0, 2, 1, 3)
    else:
        rho_a = rho_light
    flip_s = geo.flip[sub]
    rho_o = torch.where(flip_s[:, None, None, None],
                        torch.flip(rho_a, dims=(1,)), rho_a).contiguous()
    mu_in = _resample_matrix(l, g, geo.su[sub], geo.ou[sub], dev)  # (C, L, G)
    mv_in = _resample_matrix(l, g, geo.sv[sub], geo.ov[sub], dev)

    sm_args = {}
    if shadow_map is not None:
        sm_args = _shadow_entry(
            shadow_map, shadow_vp, shadow_bias, light_dir_world, axis, g,
            geo.lo_u, geo.lo_v, geo.span_u, geo.span_v, mv_in, mu_in,
            (geo.w_in, geo.sgn, geo.scales), sub, l)
    return geo, rho_o, mv_in, mu_in, sm_args


def light_transmittance(
    rho_light,        # (C, L, L, L) density at the refreshed volumes' grids
    per_object: PerObject,
    light_dir_world,  # (3,) unit, pointing TOWARD the light
    step_scale: float,
    axis: int,        # static sweep axis (see `light_axis`)
    sub_ids=None,     # (C,) volume indices refreshed (None = all N)
    sout_cache=None,  # (N, L, L) cached outgoing lateral transmittance
    impl: str | None = None,
    shadow_map=None,  # (Sm, Sm) the mesh's light-view clip depth, or None
    shadow_vp=None,   # (4, 4) its view-proj
    shadow_bias: float = 0.0027,
):
    """Per-volume transmittance fields toward the light with inter-volume
    occlusion chained through a shared lateral map -> ((C, L, L, L),
    (N, L, L) outgoing footprints). `sout_cache`, when given, is updated
    in place at `sub_ids` and returned. With `shadow_map`, each voxel is
    also lit only in front of the mesh (a soft compare one slice deep).
    The plain version of B10 / B3 / B4 (B3 and B4 launch on CUDA tensors
    unless `impl="plain"`)."""
    n = per_object.world.shape[0]
    c = rho_light.shape[0]
    sub = (sub_ids if sub_ids is not None
           else torch.arange(n, device=rho_light.device))
    assert sub_ids is not None or c == n, \
        "full refresh needs rho_light for every volume"
    geo, rho_o, mv_in, mu_in, sm_args = prologue_plain(
        rho_light, per_object, light_dir_world, step_scale, axis, sub,
        shadow_map, shadow_vp, shadow_bias)
    flip_s = geo.flip[sub]

    # self sweep (B3; its shadow-map variant with a mesh): volume-only
    # transmittance per slice + footprint
    here, s_out_c = light_ops.light_self_scan(
        rho_o, geo.du[sub], geo.dv[sub], geo.f_corr[sub], impl=impl,
        **sm_args)

    if sout_cache is not None:
        sout_cache[sub] = s_out_c
        s_out_all = sout_cache
    else:
        s_out_all = s_out_c
    t_ins = occlusion_entry(geo, s_out_all, sub, mv_in, mu_in)

    # advect the incoming occlusion through the volumes (B4)
    t_fields = light_ops.light_advect_mul(here, t_ins, geo.du[sub],
                                          geo.dv[sub], impl=impl)
    return orient_back(t_fields, flip_s, axis), s_out_all


def orient_back(t_fields, flip_s, axis: int):
    """Sweep-major fields (C, L, L, L) back to the volumes' (z, y, x)
    layout: the flip of the flagged rows, then the permute of `axis`."""
    t_fields = torch.where(flip_s[:, None, None, None],
                           torch.flip(t_fields, dims=(1,)), t_fields)
    if axis == 0:
        t_fields = t_fields.permute(0, 3, 2, 1)
    elif axis == 1:
        t_fields = t_fields.permute(0, 2, 1, 3)
    return t_fields


def _shadow_entry(shadow_map, shadow_vp, shadow_bias, light_dir_world,
                  axis: int, g: int, lo_u, lo_v, span_u, span_v, mv_in,
                  mu_in, geom, sub, l: int) -> dict:
    """The shadow-map operands of B3's variant for the cohort: sm_vol and
    z_entry (C, L, L) on each volume's entry plane, dz_slice and soft
    (C,). The map is read once per ray of the global (G, G) lateral grid
    on the w = 0 reference plane, bilinearly with clamped taps (the JAX
    package's non-quad branch)."""
    w_in, sgn, scales = geom
    dev = shadow_map.device
    ar = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    u_w = lo_u + ar[None, :] * span_u
    v_w = lo_v + ar[:, None] * span_v
    zero = torch.zeros_like(u_w + v_w)
    if axis == 0:      # lateral (v=y, u=z), reference plane x = 0
        p0 = (zero, v_w.expand_as(zero), u_w.expand_as(zero))
    elif axis == 1:    # lateral (v=z, u=x), plane y = 0
        p0 = (u_w.expand_as(zero), zero, v_w.expand_as(zero))
    else:              # lateral (v=y, u=x), plane z = 0
        p0 = (u_w.expand_as(zero), v_w.expand_as(zero), zero)
    m = shadow_vp
    su_ = p0[0] * m[0, 0] + p0[1] * m[1, 0] + p0[2] * m[2, 0] + m[3, 0]
    sv_ = p0[0] * m[0, 1] + p0[1] * m[1, 1] + p0[2] * m[2, 1] + m[3, 1]
    z0g = p0[0] * m[0, 2] + p0[1] * m[1, 2] + p0[2] * m[2, 2] + m[3, 2]
    hs, ws = shadow_map.shape
    xs_ = (su_ * 0.5 + 0.5) * ws - 0.5
    ys_ = (1.0 - (sv_ * 0.5 + 0.5)) * hs - 0.5
    x0f, y0f = torch.floor(xs_), torch.floor(ys_)

    def cidx(vv, nn):
        return torch.clamp(torch.clamp(vv, -1.0, float(nn)).long(), 0,
                           nn - 1)

    fx, fy = xs_ - x0f, ys_ - y0f
    xa, xb = cidx(x0f, ws), cidx(x0f + 1, ws)
    ya, yb = cidx(y0f, hs), cidx(y0f + 1, hs)
    sm0 = shadow_map[ya, xa] * (1 - fx) + shadow_map[ya, xb] * fx
    sm1 = shadow_map[yb, xa] * (1 - fx) + shadow_map[yb, xb] * fx
    sm_g = sm0 * (1 - fy) + sm1 * fy + shadow_bias             # (G, G)
    # light-space z advance per unit world w along a ray
    d = -light_dir_world
    dz_dp = d[0] * m[0, 2] + d[1] * m[1, 2] + d[2] * m[2, 2]
    dir_w = d[axis]
    dzdw = dz_dp / torch.where(dir_w.abs() > 1e-6, dir_w,
                               torch.where(dir_w >= 0, 1e-6, -1e-6))
    sm_vol = torch.einsum("cvg,gh,cuh->cvu", mv_in, sm_g, mu_in)
    z_vol = torch.einsum("cvg,gh,cuh->cvu", mv_in, z0g, mu_in)
    dz_slice = (dzdw * sgn * (2.0 * scales / l))[sub]
    return dict(sm_vol=sm_vol,
                z_entry=z_vol + (dzdw * w_in)[sub][:, None, None],
                dz_slice=dz_slice,
                soft=torch.clamp(dz_slice.abs(), min=1e-6))


def precompute_static(volumes, light_grid_size: int,
                      max_light_samples: int, ao_taps: int = 8):
    """Static per-source lighting fields, computed once per scene:
    rho_light (N_src, L, L, L), ao (N_src, L, L, L) and the unit AO ray
    directions grad_dir (N_src, 3, L, L, L)."""
    l = light_grid_size
    n_src = volumes.shape[0]
    dev = volumes.device
    step_scale = MAX_DIST / float(max_light_samples)
    rho_light = densities_at_light_grid(volumes, l)

    ts = (torch.arange(l, dtype=torch.float32, device=dev) + 0.5) / l \
        * 2.0 - 1.0
    vz, vy, vx = torch.meshgrid(ts, ts, ts, indexing="ij")
    shape = (n_src, l, l, l)
    tex_idx = torch.arange(n_src, device=dev)[:, None, None, None].expand(
        shape)
    u = (vx * 0.5 + 0.5)[None].expand(shape)
    v = (vy * 0.5 + 0.5)[None].expand(shape)
    w = (vz * 0.5 + 0.5)[None].expand(shape)
    density = volumes[..., 3:4].float()

    def dens(du_, dv_, dw_):
        return indexed_trilinear_soa(density, tex_idx, u + du_, v + dv_,
                                     w + dw_)[0]

    eps = 1.0 / l
    gx = dens(eps, 0, 0) - dens(-eps, 0, 0)
    gy = dens(0, eps, 0) - dens(0, -eps, 0)
    gz = dens(0, 0, eps) - dens(0, 0, -eps)
    zero_g = (gx.abs() + gy.abs() + gz.abs()) <= 0.0
    ax_ = torch.where(zero_g, vx[None], -gx)
    ay_ = torch.where(zero_g, vy[None], -gy)
    az_ = torch.where(zero_g, vz[None], -gz)
    ginv = torch.rsqrt(torch.clamp(ax_ * ax_ + ay_ * ay_ + az_ * az_,
                                   min=1e-20))
    ax_, ay_, az_ = ax_ * ginv, ay_ * ginv, az_ * ginv

    ao_step = 1.0 / ao_taps
    transm = torch.ones(shape, dtype=torch.float32, device=dev)
    f = (ao_step * 0.5 * MAX_DIST) / step_scale
    for k in range(1, ao_taps + 1):
        s = k * ao_step * 0.5
        dk = dens(ax_ * s, ay_ * s, az_ * s)
        transm = transm * torch.exp2(
            f * torch.log2(torch.clamp(1.0 - dk * ABSORPTION, min=1e-7)))
    grad_dir = torch.stack([ax_, ay_, az_], dim=1)
    return rho_light, transm, grad_dir


def _shade_light_fields(shadow, rho, tex_sub, ao_src, grad_dir_src,
                        sh_coeffs, ambient, light_color,
                        has_light_probe: bool):
    """Transmittance fields -> RGB light maps (C, 3, L, L, L)."""
    lcol = light_color[:3] * light_color[3]
    if has_light_probe:
        has_density = rho >= ZERO_THRESHOLD
        ao = ao_src[tex_sub]
        nrm = grad_dir_src[tex_sub].movedim(1, -1)        # (C, L, L, L, 3)
        irr = sh_lib.eval_irradiance(sh_coeffs, nrm)
        amb = [torch.where(has_density, ao * irr[..., i], 0.0)
               for i in range(3)]
    else:
        a = ambient[:3] * ambient[3]
        amb = [a[i].expand_as(shadow) for i in range(3)]
    return torch.stack([shadow * lcol[i] + amb[i] for i in range(3)], dim=1)


def ray_march_light_sweep_update(
    rho_light_src, ao_src, grad_dir_src, vol_tex_ids,
    per_object: PerObject, light_pos, light_color, ambient, sh_coeffs,
    max_light_samples: int, axis: int, has_light_probe: bool = True,
    sub_ids=None, sout_cache=None, impl: str | None = None,
    shadow_map=None, shadow_vp=None, store=None,
):
    """Refresh the light maps of a volume cohort (all volumes when
    `sub_ids` is None) -> (maps (C, 3, L, L, L), sout (N, L, L)); with
    the mesh's `shadow_map` and `shadow_vp` the maps take its shadow.
    With `store` = (light_maps (N, 3, L, L, L), light_sweep (N, L, L, L,
    4), rows (C,)) the maps are written into those rows in place and None
    is returned for them. On CUDA tensors (unless `impl="plain"`) it runs
    B10 / B3 / B4 / B11 (`ops/lightsweep_prep.py`), else the plain
    version. Steps `light.update` (the transmittance) and `light.store`
    (the shade and the stores)."""
    step_scale = MAX_DIST / float(max_light_samples)
    light_dir = light_pos[:3] / torch.linalg.norm(light_pos[:3])
    if ops.use_kernel(impl, rho_light_src):
        return _update_kernels(
            rho_light_src, ao_src, grad_dir_src, vol_tex_ids, per_object,
            light_dir, light_color, ambient, sh_coeffs, step_scale, axis,
            has_light_probe, sub_ids, sout_cache, impl, shadow_map,
            shadow_vp, store)
    tex_sub = vol_tex_ids if sub_ids is None else vol_tex_ids[sub_ids]
    with timing.span("light.update"):
        rho = rho_light_src[tex_sub]
        shadow, sout = light_transmittance(
            rho, per_object, light_dir, step_scale, axis,
            sub_ids=sub_ids, sout_cache=sout_cache, impl=impl,
            shadow_map=shadow_map, shadow_vp=shadow_vp)
    with timing.span("light.store"):
        maps = _shade_light_fields(shadow, rho, tex_sub, ao_src,
                                   grad_dir_src, sh_coeffs, ambient,
                                   light_color, has_light_probe)
        if store is None:
            return maps, sout
        from multivolumes_tpu_torch.scene.state import to_light_sweep

        light_maps, light_sweep, rows = store
        light_maps[rows] = maps.to(light_maps.dtype)
        light_sweep[rows] = to_light_sweep(maps, light_sweep.dtype)
    return None, sout


def _update_kernels(rho_light_src, ao_src, grad_dir_src, vol_tex_ids,
                    per_object, light_dir, light_color, ambient, sh_coeffs,
                    step_scale, axis, has_light_probe, sub_ids, sout_cache,
                    impl, shadow_map, shadow_vp, store):
    """`ray_march_light_sweep_update` on the card: B10a, B3 / B3', B10b,
    B4, B11 (five launches)."""
    n = vol_tex_ids.shape[0]
    sub = (sub_ids if sub_ids is not None
           else torch.arange(n, device=vol_tex_ids.device))
    with timing.span("light.update"):
        prep = prep_ops.light_prologue(
            rho_light_src, vol_tex_ids, sub, per_object, light_dir,
            step_scale, axis, shadow_map=shadow_map, shadow_vp=shadow_vp)
        here, s_out_c = light_ops.light_self_scan(
            prep.rho_o, prep.du, prep.dv, prep.f_corr, impl=impl, **prep.sm)
        t_ins = prep_ops.light_occlusion(prep, s_out_c, sout_cache)
        fields = light_ops.light_advect_mul(here, t_ins, prep.du, prep.dv,
                                            impl=impl)
    with timing.span("light.store"):
        maps = prep_ops.light_epilogue(
            fields, prep, rho_light_src, ao_src, grad_dir_src, vol_tex_ids,
            sh_coeffs, ambient, light_color, has_light_probe, store=store)
    return maps, (s_out_c if sout_cache is None else sout_cache)


def ray_march_light_sweep(
    rho_light_src, ao_src, grad_dir_src, vol_tex_ids,
    per_object: PerObject, cull, shadow_map, shadow_vp, light_pos,
    light_color, ambient, sh_coeffs, max_light_samples: int,
    has_light_probe: bool = True,
):
    """All N light maps in one pass -> (N, 3, L, L, L): the full-refresh
    case of `ray_march_light_sweep_update`, with the arguments of the JAX
    function, swept along the host pick `light_axis(light_pos)`. `cull`
    does not gate light maps (off-screen volumes still shadow visible
    ones)."""
    del cull
    maps, _sout = ray_march_light_sweep_update(
        rho_light_src, ao_src, grad_dir_src, vol_tex_ids, per_object,
        light_pos, light_color, ambient, sh_coeffs, max_light_samples,
        light_axis(light_pos), has_light_probe=has_light_probe,
        shadow_map=shadow_map, shadow_vp=shadow_vp)
    return maps
