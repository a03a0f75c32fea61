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

from mvbench.reference.config import SharedConsts

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
                    dz_slice=None, soft=None, impl=None):
    """B3's plain version: see `light_self_scan_plain`."""
    del impl
    return light_self_scan_plain(rho_o, du, dv, f_corr, sm_vol, z_entry,
                                 dz_slice, soft)


def light_advect_mul(here, t_in, du, dv, impl=None):
    """B4's plain version: see `light_advect_mul_plain`."""
    del impl
    return light_advect_mul_plain(here, t_in, du, dv)
