"""Light-sweep march kernels (B3 self scan, B4 advect-multiply).

Hand kernels: `csrc/lightsweep.cu`. They replace the TPU kernels
`multivolumes_tpu/ops/pallas/lightsweep_kernel.py::light_self_scan_pallas`
(has_sm=False, launched as `light_self_scan`; has_sm=True, the frames
with the opaque mesh, launched as `light_self_scan_sm`) and
`::light_advect_mul_pallas`.

Both march an (L, L) plane through the L slices of each cohort volume
with the lateral shear B(x) = mv @ x @ mu^T, where mv/mu are the
constant-shift linear-clamp resample matrices of `_interp_matrix_shift`.
The kernels take the shifts (dv, du) and apply B as the equivalent 2-tap
separable lerp (O(L^2) per slice); the plain versions below keep the
dense matrix products of the JAX twin (`lightsweep.py`, impl="xla"), so
comparing the two on the card checks that equivalence.

The shadow-map term of the variant, lit_k = clip((B^{k+1}(sm) - z_k) /
soft + 1, 0, 1) with z_k = B^{k+1}(z_entry) + (k + 0.5) dz_slice, is
carried as one plane e_k = B^{k+1}(sm - z_entry) - (k + 0.5) dz_slice
(e_0 = B(sm - z_entry) - dz/2, e_k = B(e_{k-1}) - dz): B is linear and
its rows sum to 1, so this is the same function. The form matters for
the numbers: soft is one slice of light-space depth (about 1e-4 at the
demo scale), so the JAX twin's difference of two shifted planes near 0.5
puts their rounding, amplified ~1e4 times, into lit. Here the compare
reads the carried e, and both the plain version and the kernel shift it
with the same 2-tap lerp in the same order with every operation rounded
on its own, so they agree to the bit on the e path.
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch import ops

ABSORPTION = SharedConsts.ABSORPTION


def interp_matrix_shift(n: int, shift):
    """(C, n, n) linear-resample matrices for constant index shifts (C,):
    out[i] = in[i - shift] with linear interpolation, clamp addressing."""
    ar = torch.arange(n, dtype=torch.float32, device=shift.device)
    src = torch.clamp(ar[None, :, None] - shift[:, None, None], 0.0, n - 1.0)
    return torch.clamp(1.0 - (src - ar[None, None, :]).abs(), min=0.0)


def _bshift(x, mv, mu):
    return torch.einsum("nab,nbc,ndc->nad", mv, x, mu)


def _atten(rho_k, f_corr):
    return torch.exp2(f_corr[:, None, None] * torch.log2(
        torch.clamp(1.0 - rho_k * ABSORPTION, min=1e-7)))


def shift_taps(n: int, shift):
    """The two taps and the upper weight of the constant-shift resample
    (the non-zeros of `interp_matrix_shift`): src = clip(i - shift, 0,
    n - 1), taps floor(src) and the next (clamped), weight src - floor
    -> (i0, i1, frac), each (C, n)."""
    ar = torch.arange(n, dtype=torch.float32, device=shift.device)
    src = torch.clamp(ar[None, :] - shift[:, None], 0.0, n - 1.0)
    lo = torch.floor(src)
    i0 = lo.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), src - lo


def bshift_lerp(x, taps_v, taps_u):
    """B(x) as the 2-tap separable lerp, in the kernel's order: per row,
    x[r, c0] (1 - fu) + x[r, c1] fu, then the two rows (1 - fv), fv."""
    v0, v1, fv = taps_v
    u0, u1, fu = taps_u
    c, l = x.shape[0], x.shape[1]

    def rows(i):
        return torch.gather(x, 1, i[:, :, None].expand(c, l, l))

    def cols(y, i):
        return torch.gather(y, 2, i[:, None, :].expand(c, l, l))

    fu_, fv_ = fu[:, None, :], fv[:, :, None]
    top, bot = rows(v0), rows(v1)
    top = cols(top, u0) * (1.0 - fu_) + cols(top, u1) * fu_
    bot = cols(bot, u0) * (1.0 - fu_) + cols(bot, u1) * fu_
    return top * (1.0 - fv_) + bot * fv_


def atten_ahead(rho_o, f_corr):
    """The attenuation of every slice, (C, L, L, L), computed before the
    scan as the kernel does (`csrc/lightsweep.cu`, the density ring): it
    depends on the density alone, so only s <- B(s) * a_k is serial.
    Slice k is `_atten(rho_o[:, k], f_corr)` bit for bit (evaluated slice
    by slice: on the CPU the vector and the scalar paths of exp2 and log2
    round differently, so one call over another shape need not be)."""
    return torch.stack([_atten(rho_o[:, k], f_corr)
                        for k in range(rho_o.shape[1])], dim=1)


def band_rows(l: int, n_bands: int):
    """The kernel's split of L rows over a cluster of `n_bands` CTAs:
    [(r_lo, r_hi), ...] with ceil(L / n_bands) rows a band, the last
    shorter or empty."""
    band = -(-l // n_bands)
    return [(min(r * band, l), min(r * band + band, l))
            for r in range(n_bands)]


def bshift_lerp_bands(x, taps_v, taps_u, n_bands: int):
    """`bshift_lerp` evaluated band by band, as the kernel's cluster does:
    the plane is held as `n_bands` separate row bands, each output band
    reads its tap rows from the band that owns them (row r lives in band
    r // ceil(L / n_bands), at local row r - r_lo), and the bands are
    concatenated. Equal to `bshift_lerp` bit for bit."""
    v0, v1, fv = taps_v
    u0, u1, fu = taps_u
    c, l = x.shape[0], x.shape[1]
    band = -(-l // n_bands)
    rows = band_rows(l, n_bands)
    held = [x[:, lo:hi].clone() for lo, hi in rows]

    def fetch(r):
        """(C, n) row indices -> (C, n, L) rows, each from its owner"""
        out = torch.empty((c, r.shape[1], l), dtype=x.dtype, device=x.device)
        owner = r // band
        for o, (lo, _hi) in enumerate(rows):
            ci, ni = torch.nonzero(owner == o, as_tuple=True)
            out[ci, ni] = held[o][ci, r[ci, ni] - lo]
        return out

    def cols(y, i):
        return torch.gather(y, 2, i[:, None, :].expand(c, y.shape[1], l))

    fu_ = fu[:, None, :]
    parts = []
    for lo, hi in rows:
        top, bot = fetch(v0[:, lo:hi]), fetch(v1[:, lo:hi])
        fv_ = fv[:, lo:hi, None]
        top = cols(top, u0) * (1.0 - fu_) + cols(top, u1) * fu_
        bot = cols(bot, u0) * (1.0 - fu_) + cols(bot, u1) * fu_
        parts.append(top * (1.0 - fv_) + bot * fv_)
    return torch.cat(parts, dim=1)


def advect_mul_bands(here, t_in, du, dv, n_bands: int):
    """B4 evaluated as the kernel's cluster does: the carry t_0 = t_in
    held as `n_bands` row bands, t <- `bshift_lerp_bands(t)` (the 2-tap
    order) and out_k = t * here_k. Equal to `light_advect_mul_plain` to
    rounding (the plain version keeps the dense matrix products)."""
    l = here.shape[1]
    taps_v, taps_u = shift_taps(l, dv), shift_taps(l, du)
    out = torch.empty_like(here)
    t = t_in
    for k in range(l):
        t = bshift_lerp_bands(t, taps_v, taps_u, n_bands)
        out[:, k] = t * here[:, k]
    return out


def _scan_mode(has_sm: bool, advect: bool) -> int:
    """The launch's mode in csrc/lightsweep.cu: 0 the self scan, 1 with
    the shadow map, 2 the advect-multiply."""
    return 2 if advect else int(has_sm)


def scan_launch_info(c: int, l: int, has_sm: bool = False,
                     advect: bool = False) -> dict:
    """How the self scan (`advect`: the advect-multiply, B4) of a cohort
    of `c` volumes of side `l` launches on the current card: cluster
    size, rows per band, threads, shared memory per CTA, registers per
    thread, CTAs per SM and the clusters that run at once
    (`csrc/lightsweep.cu: mv_light_scan_info`)."""
    import ctypes

    from multivolumes_tpu_torch.ops import build

    out = (ctypes.c_int * 8)()
    err = build.library().mv_light_scan_info(c, l, _scan_mode(has_sm, advect),
                                             out)
    if err != 0:
        raise RuntimeError(f"mv_light_scan_info: CUDA error {err}")
    keys = ("cluster", "band_rows", "threads", "smem_bytes", "registers",
            "ctas_per_sm", "active_clusters", "static_smem_bytes")
    return dict(zip(keys, out))


def scan_chain_floor(c: int, l: int, has_sm: bool, device,
                     cluster: int = 0, advect: bool = False) -> None:
    """Launch the self scan (`advect`: the advect-multiply) of (c, l) with
    an empty body: its L cluster barriers and nothing else. Timed beside
    the kernel, it is the floor of the dependent chain. `cluster` > 0
    takes that cluster size in place of the planned one. Not a kernel of
    any path (no count)."""
    from multivolumes_tpu_torch.ops import build

    build.launch("mv_light_scan_floor", c, l, _scan_mode(has_sm, advect),
                 cluster, device=device)


def light_self_scan_plain(rho_o, du, dv, f_corr, sm_vol=None, z_entry=None,
                          dz_slice=None, soft=None):
    """Plain version of B3 (the `self_body` scan): here_k = B(s_k) * lit_k,
    s_{k+1} = B(s_k) * (1 - 0.8 rho_k)^f, s_0 = 1, lit_k = 1 without a
    shadow map, else clip(e_k / soft + 1, 0, 1) (see the module
    docstring).

    rho_o (C, L, L, L) f32 sweep-major; du, dv, f_corr (C,); sm_vol,
    z_entry (C, L, L) and dz_slice, soft (C,) or all None
    -> (here (C, L, L, L), s_out (C, L, L))."""
    c, l = rho_o.shape[0], rho_o.shape[1]
    mu, mv = interp_matrix_shift(l, du), interp_matrix_shift(l, dv)
    s = torch.ones((c, l, l), dtype=torch.float32, device=rho_o.device)
    here = torch.empty_like(rho_o)
    has_sm = sm_vol is not None
    if has_sm:
        taps_v, taps_u = shift_taps(l, dv), shift_taps(l, du)
        e = sm_vol - z_entry
        dz = dz_slice[:, None, None]
        soft = soft[:, None, None]
    for k in range(l):
        shifted = _bshift(s, mv, mu)
        if has_sm:
            e = bshift_lerp(e, taps_v, taps_u) - (dz * 0.5 if k == 0 else dz)
            lit = torch.clamp(e / soft + 1.0, 0.0, 1.0)
            here[:, k] = shifted * lit
        else:
            here[:, k] = shifted
        s = shifted * _atten(rho_o[:, k], f_corr)
    return here, s


def light_advect_mul_plain(here, t_in, du, dv):
    """Plain version of B4: out_k = here_k * B^{k+1}(t_in). The kernel is
    the banded scan of B3 with the carry started from t_in's bands, here
    streamed in place of the density and the product formed off the
    chain (`advect_mul_bands` is its order of operations).

    here (C, L, L, L); t_in (C, L, L); du, dv (C,) -> (C, L, L, L)."""
    l = here.shape[1]
    mu, mv = interp_matrix_shift(l, du), interp_matrix_shift(l, dv)
    out = torch.empty_like(here)
    t = t_in
    for k in range(l):
        t = _bshift(t, mv, mu)
        out[:, k] = here[:, k] * t
    return out


def light_self_scan(rho_o, du, dv, f_corr, sm_vol=None, z_entry=None,
                    dz_slice=None, soft=None, impl: str | None = None):
    """B3 wrapper: see `light_self_scan_plain`; the shadow-map operands
    come all four or none."""
    sm = (sm_vol, z_entry, dz_slice, soft)
    has_sm = sm_vol is not None
    if any((x is None) == has_sm for x in sm):
        raise ValueError("sm_vol, z_entry, dz_slice and soft come together")
    if not ops.use_kernel(impl, rho_o):
        return light_self_scan_plain(rho_o, du, dv, f_corr, *sm)
    from multivolumes_tpu_torch.ops import build

    c, l = rho_o.shape[0], rho_o.shape[1]
    rho_o, du, dv, f_corr = (x.float().contiguous()
                             for x in (rho_o, du, dv, f_corr))
    ops_in = [("rho_o", rho_o), ("du", du), ("dv", dv), ("f_corr", f_corr)]
    if has_sm:
        e0 = (sm_vol.float() - z_entry.float()).contiguous()
        dz_slice, soft = dz_slice.float().contiguous(), \
            soft.float().contiguous()
        ops_in += [("sm_vol - z_entry", e0), ("dz_slice", dz_slice),
                   ("soft", soft)]
        if e0.shape != (c, l, l) or dz_slice.shape != (c,) \
                or soft.shape != (c,):
            raise ValueError(f"bad shadow-map shapes {e0.shape} "
                             f"{dz_slice.shape} {soft.shape}")
    for name, t in ops_in:
        ops.check_cuda(t, name, torch.float32)
    if rho_o.shape != (c, l, l, l) or du.shape != (c,) or dv.shape != (c,):
        raise ValueError(f"bad shapes {rho_o.shape} {du.shape} {dv.shape}")
    here = torch.empty_like(rho_o)
    s_out = torch.empty((c, l, l), dtype=torch.float32, device=rho_o.device)
    if has_sm:
        build.launch("mv_light_self_scan_sm", rho_o.data_ptr(),
                     du.data_ptr(), dv.data_ptr(), f_corr.data_ptr(),
                     e0.data_ptr(), dz_slice.data_ptr(), soft.data_ptr(),
                     here.data_ptr(), s_out.data_ptr(), c, l,
                     device=rho_o.device)
        ops.count_launch("light_self_scan_sm")
    else:
        build.launch("mv_light_self_scan", rho_o.data_ptr(), du.data_ptr(),
                     dv.data_ptr(), f_corr.data_ptr(), here.data_ptr(),
                     s_out.data_ptr(), c, l, device=rho_o.device)
        ops.count_launch("light_self_scan")
    return here, s_out


def light_advect_mul(here, t_in, du, dv, impl: str | None = None):
    """B4 wrapper: see `light_advect_mul_plain`."""
    if not ops.use_kernel(impl, here):
        return light_advect_mul_plain(here, t_in, du, dv)
    from multivolumes_tpu_torch.ops import build

    c, l = here.shape[0], here.shape[1]
    here, t_in, du, dv = (x.float().contiguous()
                          for x in (here, t_in, du, dv))
    for name, t in (("here", here), ("t_in", t_in), ("du", du), ("dv", dv)):
        ops.check_cuda(t, name, torch.float32)
    if here.shape != (c, l, l, l) or t_in.shape != (c, l, l):
        raise ValueError(f"bad shapes {here.shape} {t_in.shape}")
    out = torch.empty_like(here)
    build.launch("mv_light_advect_mul", here.data_ptr(), t_in.data_ptr(),
                 du.data_ptr(), dv.data_ptr(), out.data_ptr(), c, l,
                 device=here.device)
    ops.count_launch("light_advect_mul")
    return out
