"""Plane-sweep cube-map march (B1): kernel wrapper and plain version.

Hand kernel: `csrc/sweep.cu`, replacing
`multivolumes_tpu/ops/pallas/sweep_kernel.py::sweep_batched_pallas`.
Plain version: `sweep_march_plain`, the direct translation of the JAX
twin `multivolumes_tpu/render/sweep.py::sweep_batched` (including its
bf16 rounding points), over the three orientation variants built on the
fly from the plain stacks.

Both take the plain channel-last stacks: volumes (N_src, D, H, W, 4) and
light (N_light, L, L, L, 4) in the sweep dtype (cubic grids), and return
the (N, 6, 4, S, S) f32 scatter of `sweep_batched`.
"""

from __future__ import annotations

import numpy as np
import torch

from mvbench.reference.config import SharedConsts

ABSORPTION = SharedConsts.ABSORPTION
ZERO_THRESHOLD = SharedConsts.ZERO_THRESHOLD
MAX_DIST = SharedConsts.MAX_DIST
EXIT_T = 0.01  # csrc/sweep.cu: a face stops once all its rays are below it
FLT_MAX = 3.402823466e38

# Face -> stored variant (0: [z,y,x]; 1: z<->x; 2: z<->y) and the face's
# (z, v, u) mirrors: the six face frames reduce to three transposes of a
# volume, and every flip is index arithmetic (render/sweep.py in the JAX
# package; the kernel folds both into its addressing).
FACE_VARIANT = (1, 1, 2, 2, 0, 0)
FACE_FLIPS = ((0, 0, 1), (1, 0, 0), (0, 1, 0), (1, 0, 0), (0, 0, 0),
              (1, 0, 1))


def orient_variants_cf(vol_cf):
    """(..., C, D, H, W) -> (..., 3, D, C, H, W): the three transposes."""
    t_zx = vol_cf.transpose(-3, -1)
    t_zy = vol_cf.transpose(-3, -2)
    return torch.stack([v.transpose(-4, -3) for v in (vol_cf, t_zx, t_zy)],
                       dim=-5)


def orient_variants(vol):
    """(..., D, H, W, C) -> (..., 3, D, C, H, W) slab-major variants."""
    return orient_variants_cf(vol.movedim(-1, -4))


def _face_tables(n: int, device):
    var = torch.tensor(FACE_VARIANT, device=device).repeat(n)
    flips = torch.tensor(FACE_FLIPS, dtype=torch.float32,
                         device=device).repeat(n, 1)
    return var, flips


def sweep_march_plain(volumes, light, vol_tex_ids, eye_faces, params,
                      smp_count, run_mask, num_planes: int, size: int,
                      n_eff_b=None, light_ids=None,
                      sample_counts: bool = False):
    """The JAX twin `sweep_batched`, one plane per step. dtype = the
    stacks' dtype: fetches, interpolation weights and the pass-1 product
    round to it; the products accumulate in f32.

    With `sample_counts`, returns (scatter, counts) where counts holds
    what a march of these inputs needs: "live", per ray ((N, 6, S, S)
    int32), the samples it composites (density above ZERO_THRESHOLD
    inside its window); "needed", those of them it meets while its
    transmittance is still at least EXIT_T (the kernel stops a face once
    all its rays are below EXIT_T); "vol_texels" and "light_texels", the
    distinct texels of the source volumes and light stacks that the
    needed samples' taps of non-zero weight read."""
    dtype = volumes.dtype
    dev = volumes.device
    vol_or = orient_variants(volumes)              # (N_src, 3, D, 4, H, W)
    light_or = orient_variants(light[..., :3])     # (N_l, 3, Dl, 3, Hl, Wl)
    n = vol_tex_ids.shape[0]
    b = n * 6
    d, h, w = vol_or.shape[2], vol_or.shape[4], vol_or.shape[5]
    dl, hl, wl = light_or.shape[2], light_or.shape[4], light_or.shape[5]

    eye_b = eye_faces.reshape(b, 3)
    eu, ev, ew = eye_b[:, 0], eye_b[:, 1], eye_b[:, 2]
    ew_c = torch.clamp(ew, -1.0, 1.0)
    delta = (1.0 - ew_c) / num_planes
    inv_gz = 1.0 / torch.clamp(1.0 - ew, min=1e-6)

    tex_b = vol_tex_ids.long().repeat_interleave(6)
    lm_b = (torch.arange(n, device=dev) if light_ids is None
            else light_ids.long()).repeat_interleave(6)
    var_b, flips = _face_tables(n, dev)
    zf_b, vf_b, uf_b = flips[:, 0], flips[:, 1], flips[:, 2]

    ar = torch.arange(size, dtype=torch.float32, device=dev)
    if n_eff_b is None:
        u = ((ar + 0.5) / size * 2.0 - 1.0).expand(b, size)
    else:
        ne = n_eff_b.float().repeat_interleave(6)[:, None]
        u = (ar[None] + 0.5) / ne * 2.0 - 1.0
    v = -u

    s_in = params.s_in.reshape(b, size, size)
    s_end = params.s_end.reshape(b, size, size)
    ray_len = params.ray_len.reshape(b, size, size)
    ray_ok = (params.active.reshape(b, size, size)
              & run_mask.reshape(b)[:, None, None])
    step_scale = MAX_DIST / torch.clamp(
        smp_count.float().repeat_interleave(6), min=1.0)
    f_corr = ((delta * inv_gz)[:, None, None] * ray_len
              / step_scale[:, None, None])

    def slab(stack, idx, wk, dd):
        zc = (wk * 0.5 + 0.5) * dd - 0.5
        zc = zc + zf_b * ((dd - 1.0) - 2.0 * zc)
        z0 = torch.clamp(torch.floor(zc).long(), 0, dd - 1)
        z1 = torch.clamp(z0 + 1, 0, dd - 1)
        fz = torch.clamp(zc - torch.floor(zc), 0.0, 1.0).to(dtype)
        fz = fz[:, None, None, None]
        return stack[idx, var_b, z0] * (1 - fz) + stack[idx, var_b, z1] * fz

    def interp(coords, nn, lat_flip):
        t = torch.arange(nn, dtype=torch.float32, device=dev)
        c = torch.clamp(coords, 0.0, nn - 1.0)
        c = c + lat_flip[:, None] * ((nn - 1.0) - 2.0 * c)
        return torch.clamp(1.0 - (c[..., None] - t).abs(), min=0.0).to(dtype)

    def resample(sl, wy, wx):
        tmp = torch.einsum("bjw,bchw->bchj", wx.float(), sl.float())
        return torch.einsum("bih,bchj->bcij", wy.float(),
                            tmp.to(dtype).float())

    def mark(need_or, need, idx, wk, dd, nn, coords_v, coords_u):
        """Set need_or (stacks, 3, dd, nn, nn) where a `need` ray's taps
        of non-zero weight read this plane (as slab() and interp())."""
        zc = (wk * 0.5 + 0.5) * dd - 0.5
        zc = zc + zf_b * ((dd - 1.0) - 2.0 * zc)
        z0 = torch.clamp(torch.floor(zc).long(), 0, dd - 1)
        fz = torch.clamp(zc - torch.floor(zc), 0.0, 1.0).to(dtype)
        zt = torch.stack([z0, torch.clamp(z0 + 1, 0, dd - 1)], -1)
        zm = torch.stack([1 - fz > 0, fz > 0], -1)              # (B, 2)

        def taps(coords, flip):
            c = torch.clamp(coords, 0.0, nn - 1.0)
            c = c + flip[:, None] * ((nn - 1.0) - 2.0 * c)
            t = torch.floor(c)[..., None] + torch.tensor([0.0, 1.0],
                                                         device=dev)
            wt = torch.clamp(1.0 - (c[..., None] - t).abs(), min=0.0)
            return t.long().clamp(0, nn - 1), wt.to(dtype) > 0

        yt, ym = taps(coords_v, vf_b)                           # (B, S, 2)
        xt, xm = taps(coords_u, uf_b)
        base = (idx * 3 + var_b)[:, None] * dd + zt             # (B, 2)
        flat = ((base[:, :, None, None, None, None] * nn
                 + yt[:, None, :, :, None, None]) * nn
                + xt[:, None, None, None, :, :])
        hit = (need[:, None, :, None, :, None]
               & zm[:, :, None, None, None, None]
               & ym[:, None, :, :, None, None] & xm[:, None, None, None])
        need_or.view(-1)[flat[hit]] = True

    def distinct(need_or):
        """Distinct texels in the stacks' own layout (the three oriented
        variants are transposes of one stack)."""
        n_st, _, dd, nn, _ = need_or.shape
        ids = orient_variants_cf(torch.arange(
            dd * nn * nn, device=dev).reshape(1, dd, nn, nn))[:, :, 0]
        orig = torch.zeros((n_st, dd * nn * nn), dtype=torch.bool,
                           device=dev)
        for var in range(3):
            perm = ids[var].reshape(-1)
            orig[:, perm] |= need_or[:, var].reshape(n_st, -1)
        return int(orig.sum())

    transm = torch.ones((b, size, size), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, 4, size, size), dtype=torch.float32, device=dev)
    if sample_counts:
        n_live = torch.zeros((b, size, size), dtype=torch.int32, device=dev)
        n_needed = torch.zeros_like(n_live)
        vol_need = torch.zeros((volumes.shape[0], 3, d, h, w),
                               dtype=torch.bool, device=dev)
        light_need = torch.zeros((light.shape[0], 3, dl, hl, wl),
                                 dtype=torch.bool, device=dev)
    for k in range(num_planes):
        wk = ew_c + (k + 0.5) * delta
        sk = (wk - ew) * inv_gz
        pu = eu[:, None] + sk[:, None] * (u - eu[:, None])      # (B, S)
        pv = ev[:, None] + sk[:, None] * (v - ev[:, None])
        plane = resample(slab(vol_or, tex_b, wk, d),
                         interp((pv * 0.5 + 0.5) * h - 0.5, h, vf_b),
                         interp((pu * 0.5 + 0.5) * w - 0.5, w, uf_b))
        lgt = resample(slab(light_or, lm_b, wk, dl),
                       interp((pv * 0.5 + 0.5) * hl - 0.5, hl, vf_b),
                       interp((pu * 0.5 + 0.5) * wl - 0.5, wl, uf_b))
        rho = torch.clamp(plane[:, 3], 0.0, 1.0)
        skb = sk[:, None, None]
        live = (rho > ZERO_THRESHOLD) & (skb >= s_in) & (skb <= s_end) \
            & ray_ok
        a_mult = torch.exp2(f_corr * torch.log2(
            torch.clamp(1.0 - rho * ABSORPTION, min=1e-7)))
        a_mult = torch.where(live, a_mult, 1.0)
        amt = torch.where(live, transm * (1.0 - a_mult), 0.0)
        acc[:, :3] += plane[:, :3] * lgt * amt[:, None]
        acc[:, 3] += amt
        if sample_counts:
            need = live & (transm >= EXIT_T)
            n_live += live
            n_needed += need
            mark(vol_need, need, tex_b, wk, d, h, (pv * 0.5 + 0.5) * h - 0.5,
                 (pu * 0.5 + 0.5) * w - 0.5)
            mark(light_need, need, lm_b, wk, dl, hl,
                 (pv * 0.5 + 0.5) * hl - 0.5, (pu * 0.5 + 0.5) * wl - 0.5)
        transm = transm * a_mult
    acc = acc.reshape(n, 6, 4, size, size)
    if sample_counts:
        return acc, {"live": n_live.reshape(n, 6, size, size),
                     "needed": n_needed.reshape(n, 6, size, size),
                     "vol_texels": distinct(vol_need),
                     "light_texels": distinct(light_need)}
    return acc


# --- what the kernel's staging relies on, mirrored for the CPU tests -------


_f32 = np.float32


def sweep_march(volumes, light, vol_tex_ids, eye_faces, params, smp_count,
                run_mask, num_planes: int, size: int, n_eff_b=None,
                light_ids=None, vol_zmax=None, impl=None):
    """B1's plain version -> (N, 6, 4, S, S) f32 scatter (it needs no
    transparent-slab skip, so `vol_zmax` goes unused)."""
    del vol_zmax, impl
    return sweep_march_plain(volumes, light, vol_tex_ids, eye_faces, params,
                             smp_count, run_mask, num_planes, size,
                             n_eff_b=n_eff_b, light_ids=light_ids)
