"""Screen-tile OIT composite (B2): kernel wrapper and plain version.

Hand kernel: `csrc/composite.cu`, replacing
`multivolumes_tpu/ops/pallas/composite_kernel.py::tile_composite_pallas`,
with and without the CubeCast depth weights (`depth_sel`, the frames with
the opaque mesh; launched as `composite_depth`).

The JAX package has no same-signature twin of this kernel, so the plain
version below is written from the kernel's semantics: per pixel, for each
volume on its tile's list, the ray/box exit, exit face and exit clip-z
against the scene depth, the exact Catmull-Smith two-pass warp of the exit
face (rows floor(vt) and floor(vt) + 1, each tapped at its own isoline
crossing cu(row, x)), a nearest-K insert that keeps the earlier-listed
volume on equal depth, then the front-to-back under-blend.

With `depth_sel` (N, 6, S, S), the cube depth in view distance, tiles
that hold a mesh pixel (scene clip z in (0, 1) anywhere in the th x tw
tile) weight the two rows of the warp by depth (`PSCube.hlsli:51-108`):
each row's cube depth is u-interpolated with the colour's tent weights,
the row weight becomes wv * max(max(1 - 0.5 |d_scene - d_row|, 0), 1e-6)
with d_scene the pixel's scene depth in view distance, and the four
channels are normalised by the weight sum (floored at 1e-20). Other
tiles take the plain warp: the gate is part of the result, because the
normalisation changes the colour at a face's edge, where the tent
weights sum to less than 1.

Operands (from `render/tilecast._tile_prep`): color (N, 6, 4, S, S)
pre-swapped faces; scene (Hp, Wp) padded clip depth (0 in the pad);
tlist (T, N) int32 per-tile volume ids, the first counts[t] valid;
vol_flt (N, 21): local basis B (9), local eye (3), world-view-proj
columns 2 and 3 (8), n_eff; face_flt (N, 6, 9): texel-scaled pu, pv,
den. Returns (4, Hp, Wp) premultiplied RGBA.

Row bands (the sharded frame step, a mesh with a "rows" axis): with
`tile_row0`, the operands `scene`, `tlist` and `counts` are one band of
tile rows, cut from a screen of `height` pixel rows `tile_row0` tile rows
down, and the result is that band of the screen. Only the pixel's NDC y
takes the offset; a band with `tile_row0 = 0` and the full height is the
unbanded launch. The band launches are counted as `composite_band` /
`composite_depth_band`.
"""

from __future__ import annotations

import torch

from mvbench.reference.config import SharedConsts

FLT_MAX = 3.402823466e38
_EPS = 1e-12
_BIG = 1e30
MAX_LAYERS = 8


def _safe(x):
    return torch.where(x.abs() > _EPS, x, torch.where(x >= 0, _EPS, -_EPS))


def _finite(x):
    return torch.where(x.abs() < _BIG, x, 0.0)


def _slab(o, d):
    ds = _safe(d)
    t1, t2 = (-1.0 - o) / ds, (1.0 - o) / ds
    return torch.minimum(t1, t2), torch.maximum(t1, t2)


def mesh_tiles(scene, th: int, tw: int):
    """(Hp, Wp) padded scene clip depth -> (Hp / th, Wp / tw) bool: the
    tile holds a mesh pixel (0 < z < 1; the pad is 0, empty background
    1)."""
    hp, wp = scene.shape
    m = (scene > 0.0) & (scene < 1.0)
    return m.reshape(hp // th, th, wp // tw, tw).any(dim=3).any(dim=1)


def pixel_ndc(idx, size: int, dtype=torch.float32):
    """(idx + 0.5) / size * 2 - 1 in `dtype`, the division correctly
    rounded as the kernel's: the divisor is a tensor on `idx`'s device,
    because PyTorch on the card divides by a host scalar as a product
    with its reciprocal, one ulp off in some columns."""
    return (idx.to(dtype) + 0.5) / torch.tensor(
        size, dtype=dtype, device=idx.device) * 2.0 - 1.0


def tile_composite_plain(color, scene, tlist, counts, vol_flt, face_flt,
                         th: int, tw: int, tiles_x: int, k_layers: int,
                         width: int, height: int, depth_sel=None,
                         tile_row0: int = 0):
    """Plain version of B2 (see the module docstring), in the dtype of
    `scene` (f32; f64 to judge the f32 forms)."""
    hp, wp = scene.shape
    s = color.shape[-1]
    dev, ft = scene.device, scene.dtype
    rows = torch.arange(hp, device=dev)
    cols = torch.arange(wp, device=dev)
    xg = pixel_ndc(cols, width, ft)[None, :].expand(hp, wp)
    yg = -pixel_ndc(rows + tile_row0 * th, height,
                    ft)[:, None].expand(hp, wp)
    tile = (rows // th)[:, None] * tiles_x + (cols // tw)[None, :]
    cnt = counts.long()[tile]
    img = color.to(ft)
    if depth_sel is not None:
        on_mesh = mesh_tiles(scene, th, tw).repeat_interleave(
            th, 0).repeat_interleave(tw, 1)
        zn, zf = SharedConsts.Z_NEAR, SharedConsts.Z_FAR
        d_scene = (zn * zf) / (scene * (zn - zf) + zf)

    lz = torch.full((k_layers, hp, wp), FLT_MAX, dtype=ft, device=dev)
    lc = torch.zeros((4, k_layers, hp, wp), dtype=ft, device=dev)
    for i in range(int(counts.max()) if counts.numel() else 0):
        vid = tlist.long()[tile, i]                        # (Hp, Wp)
        vf = vol_flt[vid]                                  # (Hp, Wp, 21)
        dlx = vf[..., 0] * xg + vf[..., 3] * yg + vf[..., 6]
        dly = vf[..., 1] * xg + vf[..., 4] * yg + vf[..., 7]
        dlz = vf[..., 2] * xg + vf[..., 5] * yg + vf[..., 8]
        ox_, oy_, oz_ = vf[..., 9], vf[..., 10], vf[..., 11]
        ix, tx = _slab(ox_, dlx)
        iy, ty = _slab(oy_, dly)
        iz, tz = _slab(oz_, dlz)
        t_near = torch.maximum(torch.maximum(ix, iy), iz)
        t_far = torch.minimum(torch.minimum(tx, ty), tz)
        hit = t_far > torch.clamp(t_near, min=0.0)
        qx, qy, qz = ox_ + dlx * t_far, oy_ + dly * t_far, oz_ + dlz * t_far
        ax, ay, az = qx.abs(), qy.abs(), qz.abs()
        is_x = (ax >= ay) & (ax >= az)
        is_y = (~is_x) & (ay >= az)
        face = torch.where(
            is_x, torch.where(qx >= 0, 0, 1),
            torch.where(is_y, torch.where(qy >= 0, 2, 3),
                        torch.where(qz >= 0, 4, 5)))
        hz = qx * vf[..., 12] + qy * vf[..., 13] + qz * vf[..., 14] \
            + vf[..., 15]
        hw = qx * vf[..., 16] + qy * vf[..., 17] + qz * vf[..., 18] \
            + vf[..., 19]
        exit_z = hz / torch.clamp(hw, min=1e-20)
        valid = (hit & (hw > 0.0) & (exit_z <= scene) & (exit_z > 0.0)
                 & (i < cnt))

        hi = vf[..., 20] - 1.0
        fq = face_flt[vid, face]                           # (Hp, Wp, 9)
        dq = fq[..., 6] * xg + fq[..., 7] * yg + fq[..., 8]
        vt = torch.clamp(_finite((fq[..., 3] * xg + fq[..., 4] * yg
                                  + fq[..., 5]) / _safe(dq)), min=0.0)
        vt = torch.minimum(vt, hi)
        v0 = torch.floor(vt)
        rgba = torch.zeros((4, hp, wp), dtype=ft, device=dev)
        rgba_d = torch.zeros((4, hp, wp), dtype=ft, device=dev)
        w_sum = torch.zeros((hp, wp), dtype=ft, device=dev)
        for v in (v0, v0 + 1.0):
            wv = torch.clamp(1.0 - (vt - v).abs(), min=0.0)
            wv = torch.where(v <= hi, wv, 0.0)
            k0 = fq[..., 3] - v * fq[..., 6]
            k1 = fq[..., 4] - v * fq[..., 7]
            k2 = fq[..., 5] - v * fq[..., 8]
            y1 = -(k0 * xg + k2) / _safe(k1)
            dq1 = fq[..., 6] * xg + fq[..., 7] * y1 + fq[..., 8]
            cu = torch.clamp(_finite((fq[..., 0] * xg + fq[..., 1] * y1
                                      + fq[..., 2]) / _safe(dq1)), min=0.0)
            cu = torch.minimum(cu, hi)
            u0 = torch.floor(cu)
            vi = torch.clamp(v.long(), 0, s - 1)
            row = torch.zeros((4, hp, wp), dtype=ft, device=dev)
            d_row = torch.zeros((hp, wp), dtype=ft, device=dev)
            for u in (u0, u0 + 1.0):
                wu = torch.clamp(1.0 - (cu - u).abs(), min=0.0)
                ui = torch.clamp(u.long(), 0, s - 1)
                tap = img[vid, face, :, vi, ui]            # (Hp, Wp, 4)
                row += tap.movedim(-1, 0) * wu
                if depth_sel is not None:
                    d_row += depth_sel[vid, face, vi, ui] * wu
            rgba += row * wv
            if depth_sel is not None:
                wd = torch.clamp(1.0 - 0.5 * (d_scene - d_row).abs(),
                                 min=0.0)
                wvd = wv * torch.clamp(wd, min=1e-6)
                rgba_d += row * wvd
                w_sum += wvd
        if depth_sel is not None:
            rgba = torch.where(on_mesh, rgba_d * (
                1.0 / torch.clamp(w_sum, min=1e-20)), rgba)
        aa = torch.clamp(rgba[3], max=1.0)
        store = (aa > 0.0) & valid
        zn = torch.where(store, exit_z, FLT_MAX)
        cn = torch.where(store, torch.cat([rgba[:3], aa[None]]), 0.0)
        for k in range(k_layers):
            take = zn < lz[k]
            z_k, c_k = lz[k].clone(), lc[:, k].clone()
            lz[k] = torch.where(take, zn, z_k)
            lc[:, k] = torch.where(take, cn, c_k)
            zn = torch.where(take, z_k, zn)
            cn = torch.where(take, c_k, cn)

    acc = torch.zeros((4, hp, wp), dtype=ft, device=dev)
    for k in range(k_layers):
        acc = acc + lc[:, k] * (1.0 - acc[3])
    acc[3] = torch.clamp(acc[3], max=0.9997)
    return acc


def tile_composite(color, scene, tlist, counts, vol_flt, face_flt, th: int,
                   tw: int, tiles_x: int, k_layers: int, width: int,
                   height: int, depth_sel=None, impl=None):
    """B2's plain version -> (4, Hp, Wp) premultiplied RGBA; with
    `depth_sel` the depth-weighted variant."""
    del impl
    if not 1 <= k_layers <= MAX_LAYERS:
        raise ValueError(f"k_layers must be in [1, {MAX_LAYERS}]")
    return tile_composite_plain(color, scene, tlist, counts, vol_flt,
                                face_flt, th, tw, tiles_x, k_layers,
                                width, height, depth_sel=depth_sel,
                                tile_row0=0)


