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

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch import ops

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

STAGE_VOL = (24, 32)    # csrc/sweep.cu: kVolRows x the density pitch
STAGE_LIGHT = (16, 16)  # csrc/sweep.cu: kLightRows x the light pitch
RECT_PAD = 1e-3         # csrc/sweep.cu: kRectPad
TILE = 16               # csrc/sweep.cu: kTile


_f32 = np.float32


def plane_sk(ew, k: int, num_planes: int):
    """Ray parameter of plane k for a face whose eye depth is ew (f32, the
    kernel's operation order) -> (wk, sk)."""
    ew = _f32(ew)
    ew_c = np.clip(ew, _f32(-1.0), _f32(1.0))
    delta = (_f32(1.0) - ew_c) / _f32(num_planes)
    inv_gz = _f32(1.0) / np.maximum(_f32(1.0) - ew, _f32(1e-6))
    wk = ew_c + (_f32(k) + _f32(0.5)) * delta
    return wk, (wk - ew) * inv_gz


def lateral_coord(p, n: int, flip):
    """csrc/sweep.cu: lateral -- grid coordinate of face coordinate p,
    clamped to [0, n - 1], then mirrored when flip is 1 (f32 numpy)."""
    c = np.clip((np.asarray(p, np.float32) * _f32(0.5) + _f32(0.5))
                * _f32(n) - _f32(0.5), _f32(0.0), _f32(n - 1.0))
    return (c + _f32(flip) * ((_f32(n - 1.0)) - _f32(2.0) * c)).astype(
        np.float32)


def texel_centres(idx, n_eff):
    """csrc/sweep.cu: texel_u -- face coordinate of texel columns idx."""
    return ((np.asarray(idx, np.float32) + _f32(0.5)) / _f32(n_eff)
            * _f32(2.0) - _f32(1.0)).astype(np.float32)


def axis_taps(e, sk, g, n: int, flip):
    """The two tent taps (t0, min(t0 + 1, n - 1)) of the rays with face
    coordinates g on one lateral axis, as the kernel's `trilerp` takes
    them."""
    e, sk = _f32(e), _f32(sk)
    c = lateral_coord(e + sk * (np.asarray(g, np.float32) - e), n, flip)
    t0 = np.floor(c).astype(np.int64)
    return t0, np.minimum(t0 + 1, n - 1)


def tile_rect(eye_f, k: int, num_planes: int, n_eff, n: int, flips,
              i_lo: int, i_hi: int, j_lo: int, j_hi: int,
              cap=STAGE_VOL):
    """csrc/sweep.cu: tile_rect -- the rectangle of slab texels that the
    rays of face rows i_lo..i_hi and columns j_lo..j_hi (inside the n_eff
    corner) tap on plane k of a grid of side n: (y_lo, y_hi, x_lo, x_hi)
    inclusive, or None when the tile has no ray or the rectangle exceeds
    the staging buffer of `cap` = (rows, columns) texels (STAGE_VOL for
    the density, STAGE_LIGHT for the light; a tile with such a plane
    marches by the direct fetch).

    eye_f = (eu, ev, ew) of the face, flips = its (z, v, u) mirrors. The
    crossing e + sk (g - e) is monotone in the ray index and the clamp
    and the mirror keep that, so the end rays bound the span; RECT_PAD
    covers the rounding of the mirror."""
    if i_hi < i_lo or j_hi < j_lo:
        return None
    eu, ev, ew = (_f32(x) for x in eye_f)
    _wk, sk = plane_sk(ew, k, num_planes)

    def span(e, g_lo, g_hi, flip):
        a, b = (lateral_coord(e + sk * (g - e), n, flip)
                for g in (g_lo, g_hi))
        lo = max(int(np.floor(min(a, b) - _f32(RECT_PAD))), 0)
        hi = min(int(np.floor(max(a, b) + _f32(RECT_PAD))) + 1, n - 1)
        return lo, hi

    v_lo, v_hi = (-texel_centres(i, n_eff) for i in (i_lo, i_hi))
    u_lo, u_hi = (texel_centres(j, n_eff) for j in (j_lo, j_hi))
    y_lo, y_hi = span(ev, v_lo, v_hi, flips[1])
    x_lo, x_hi = span(eu, u_lo, u_hi, flips[2])
    if y_hi - y_lo + 1 > cap[0] or x_hi - x_lo + 1 > cap[1]:
        return None
    return y_lo, y_hi, x_lo, x_hi


def sweep_march_rays_plain(volumes, light, vol_tex_ids, eye_faces, params,
                           smp_count, run_mask, num_planes: int, size: int,
                           n_eff_b=None, light_ids=None):
    """B1 in the kernel's per-ray gather form and operation order: per
    sample, each of the 2 x 2 lateral taps is z-lerped per texel from
    slabs z0 and z1 (rounded to the stacks' dtype as the twin's slab),
    the u pass sums the two column taps and rounds, the v pass sums the
    two rows in f32. Same arguments and result as `sweep_march_plain`,
    which resamples whole planes with tent matrices instead."""
    dtype = volumes.dtype
    dev = volumes.device
    n = vol_tex_ids.shape[0]
    b = n * 6
    nv, nl = volumes.shape[1], light.shape[1]
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
    ne = (torch.full((b, 1), float(size), device=dev) if n_eff_b is None
          else n_eff_b.float().repeat_interleave(6)[:, None])
    u = (ar[None] + 0.5) / ne * 2.0 - 1.0                       # (B, S)
    v = -u
    s_in = params.s_in.reshape(b, size, size)
    s_end = params.s_end.reshape(b, size, size)
    ray_ok = (params.active.reshape(b, size, size)
              & run_mask.reshape(b)[:, None, None])
    step_scale = MAX_DIST / torch.clamp(
        smp_count.float().repeat_interleave(6), min=1.0)
    f_corr = ((delta * inv_gz)[:, None, None]
              * params.ray_len.reshape(b, size, size)
              / step_scale[:, None, None])

    def tent(c, nn):
        """(B, S) clipped coordinate -> taps t0, t1 and their weights"""
        t0 = torch.floor(c)
        w0 = torch.clamp(1.0 - (c - t0).abs(), min=0.0).to(dtype)
        w1 = torch.clamp(1.0 - (c - (t0 + 1.0)).abs(), min=0.0).to(dtype)
        w1 = torch.where(t0 + 1.0 <= nn - 1.0, w1, torch.zeros_like(w1))
        t0 = t0.long()
        return t0, torch.clamp(t0 + 1, max=nn - 1), w0, w1

    def lateral(p, nn, flip):
        c = torch.clamp((p * 0.5 + 0.5) * nn - 0.5, 0.0, nn - 1.0)
        return c + flip[:, None] * ((nn - 1.0) - 2.0 * c)

    def fetch(stack, idx, zo, yo, xo):
        """texels (zo, yo, xo) of each face's oriented variant from the
        plain stack: (B,), (B, S, 1), (B, 1, S) -> (B, S, S, C)"""
        zo = zo[:, None, None].expand(b, size, size)
        yo, xo = yo.expand(b, size, size), xo.expand(b, size, size)
        var = var_b[:, None, None]
        z = torch.where(var == 1, xo, torch.where(var == 2, yo, zo))
        y = torch.where(var == 2, zo, yo)
        x = torch.where(var == 1, zo, xo)
        return stack[idx[:, None, None], z, y, x]

    def sample(stack, idx, nn, wk, pv, pu):
        zc = (wk * 0.5 + 0.5) * nn - 0.5
        zc = zc + zf_b * ((nn - 1.0) - 2.0 * zc)
        z0 = torch.clamp(torch.floor(zc).long(), 0, nn - 1)
        z1 = torch.clamp(z0 + 1, 0, nn - 1)
        fz = torch.clamp(zc - torch.floor(zc), 0.0, 1.0).to(dtype)
        fz = fz[:, None, None, None]
        y0, y1, wy0, wy1 = tent(lateral(pv, nn, vf_b), nn)
        x0, x1, wx0, wx1 = tent(lateral(pu, nn, uf_b), nn)
        acc = 0.0
        for y, wy in ((y0, wy0), (y1, wy1)):
            row = 0.0
            for x, wx in ((x0, wx0), (x1, wx1)):
                yy, xx = y[:, :, None], x[:, None, :]
                tx = (fetch(stack, idx, z0, yy, xx) * (1 - fz)
                      + fetch(stack, idx, z1, yy, xx) * fz)     # in dtype
                row = row + wx.float()[:, None, :, None] * tx.float()
            acc = acc + wy.float()[:, :, None, None] * row.to(dtype).float()
        return acc                                               # (B,S,S,C)

    transm = torch.ones((b, size, size), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, 4, size, size), dtype=torch.float32, device=dev)
    for k in range(num_planes):
        wk = ew_c + (k + 0.5) * delta
        sk = (wk - ew) * inv_gz
        pu = eu[:, None] + sk[:, None] * (u - eu[:, None])      # (B, S)
        pv = ev[:, None] + sk[:, None] * (v - ev[:, None])
        c = sample(volumes, tex_b, nv, wk, pv, pu)
        lgt = sample(light[..., :3], lm_b, nl, wk, pv, pu)
        rho = torch.clamp(c[..., 3], 0.0, 1.0)
        skb = sk[:, None, None]
        live = (rho > ZERO_THRESHOLD) & (skb >= s_in) & (skb <= s_end) \
            & ray_ok
        a_mult = torch.exp2(f_corr * torch.log2(
            torch.clamp(1.0 - rho * ABSORPTION, min=1e-7)))
        a_mult = torch.where(live, a_mult, 1.0)
        amt = torch.where(live, transm * (1.0 - a_mult), 0.0)
        acc[:, :3] += (c[..., :3] * lgt * amt[..., None]).permute(0, 3, 1, 2)
        acc[:, 3] += amt
        transm = transm * a_mult
    return acc.reshape(n, 6, 4, size, size)


def sweep_launch_info(size: int, num_planes: int, n: int, nl: int,
                      bf16: bool = True) -> dict:
    """How B1 launches for faces of size x size rays and num_planes
    planes on grids of side n (density) and nl (light) on the current
    card: registers per thread, shared memory per CTA, CTAs per SM,
    whether it stages slabs in shared memory or marches by the direct
    fetch alone, and local memory per thread
    (`csrc/sweep.cu: mv_sweep_info`)."""
    import ctypes

    from multivolumes_tpu_torch.ops import build

    out = (ctypes.c_int * 5)()
    err = build.library().mv_sweep_info(size, num_planes, n, nl, int(bf16),
                                        out)
    if err != 0:
        raise RuntimeError(f"mv_sweep_info: CUDA error {err}")
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm", "stages",
                     "local_bytes"), out))


def sweep_march(volumes, light, vol_tex_ids, eye_faces, params, smp_count,
                run_mask, num_planes: int, size: int, n_eff_b=None,
                light_ids=None, vol_zmax=None, impl: str | None = None):
    """B1 wrapper -> (N, 6, 4, S, S) f32 scatter. `vol_zmax` (N_src, 3, D)
    enables the kernel's exact transparent-slab skip (the plain version
    needs no skip)."""
    if not ops.use_kernel(impl, volumes):
        return sweep_march_plain(volumes, light, vol_tex_ids, eye_faces,
                                 params, smp_count, run_mask, num_planes,
                                 size, n_eff_b=n_eff_b, light_ids=light_ids)
    from multivolumes_tpu_torch.ops import build

    dev = volumes.device
    n = vol_tex_ids.shape[0]
    b = n * 6
    nv, nl = volumes.shape[1], light.shape[1]
    if (volumes.shape[1:] != (nv, nv, nv, 4)
            or light.shape[1:] != (nl, nl, nl, 4)):
        raise ValueError("sweep_march needs cubic channel-last stacks with "
                         f"4 channels, got {tuple(volumes.shape)} and "
                         f"{tuple(light.shape)}")
    if light.dtype != volumes.dtype:
        raise ValueError("volume and light stacks must share the sweep dtype")
    if not 1 <= num_planes <= 512:
        raise ValueError("the kernel keeps one 64-byte record per plane in "
                         f"shared memory: 1..512 planes, got {num_planes}")
    ops.check_cuda(volumes, "volumes", (torch.bfloat16, torch.float32))
    ops.check_cuda(light, "light", (torch.bfloat16, torch.float32))

    # The kernel takes the operands as the frame has them and derives the
    # face constants, the opacity exponent and the masks itself; what is
    # left here are casts, most of them no-ops on the frame's tensors.
    def i32(x):
        return x.to(torch.int32).contiguous()

    def f32(x, shape):
        return x.reshape(shape).float().contiguous()

    def u8(x, shape):
        return x.reshape(shape).contiguous().view(torch.uint8)

    rays = (b, size, size)
    tex = i32(vol_tex_ids)
    lrow = (torch.arange(n, dtype=torch.int32, device=dev)
            if light_ids is None else i32(light_ids))
    n_eff = (torch.full((n,), float(size), device=dev) if n_eff_b is None
             else n_eff_b.float().contiguous())
    zmax = None
    if vol_zmax is not None:
        zmax = vol_zmax.float().contiguous()
        ops.check_cuda(zmax, "vol_zmax", torch.float32)
        if zmax.shape != (volumes.shape[0], 3, nv):
            raise ValueError(f"vol_zmax shape {tuple(zmax.shape)}")
    operands = (tex, lrow, u8(run_mask, (b,)), n_eff, i32(smp_count),
                f32(eye_faces, (b, 3)), f32(params.s_in, rays),
                f32(params.s_end, rays), f32(params.ray_len, rays),
                u8(params.active, rays))
    if tex.shape != (n,) or lrow.shape != (n,) or n_eff.shape != (n,) \
            or smp_count.shape != (n,):
        raise ValueError("per-volume operands must have one entry a volume")
    if params.active.dtype != torch.bool or run_mask.dtype != torch.bool:
        raise ValueError("run_mask and params.active must be bool")
    for x in operands:
        ops.check_cuda(x, "sweep operand")
    # rays of each face that fell below T = 0.01 (the face-level early exit)
    done = torch.zeros((b,), dtype=torch.int32, device=dev)
    out = torch.empty((b, 4, size, size), dtype=torch.float32, device=dev)
    build.launch(
        "mv_sweep_march", volumes.data_ptr(), light.data_ptr(),
        None if zmax is None else zmax.data_ptr(),
        *(x.data_ptr() for x in operands), done.data_ptr(), out.data_ptr(),
        b, size, num_planes, nv, nl, int(volumes.dtype == torch.bfloat16),
        MAX_DIST, device=dev)
    ops.count_launch("sweep")
    return out.reshape(n, 6, 4, size, size)
