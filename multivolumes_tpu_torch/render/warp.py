"""Screen-to-face projective geometry and the warp composite.

Counterpart of `multivolumes_tpu/render/warp.py`. For one volume and one
exit face the map from screen NDC q = [x, y, 1] to face coordinates is a
homography, u = (nu.q)/(den.q), v = (nv.q)/(den.q). The tile composite
(kernel B2) evaluates it as a Catmull-Smith two-pass resample whose pass
order per face is chosen by `catmull_swap_flags`: the LOD sweep picks
the flags once and emits its faces pre-swapped by them, and the tile
prep takes them as given, packing the rows of `face_rows`.

`composite_oit_warp` (`composite_mode="warp"`) resamples each volume's
faces onto a screen tile around it with two tent-matrix products a face
(`warp_face`) and inserts the tile into the nearest-K layers. Where the
JAX function branches on device values (`lax.cond` on a volume's
visibility, on whether a face covers any pixel, on a face's resample
orientation and on the pass-2 formulation), this one reads the
visibility of a footprint class once and the 18 flags of each visible
volume once from the device, and branches on the host; the arithmetic of
each branch is the JAX function's.
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.render import raymarch
from multivolumes_tpu_torch.render.composite import (
    FLT_MAX, _ray_box_exit_soa, _underblend, dir_to_face_uv_soa)

_EPS = 1e-12
# volumes promoted to the full-screen tile when no LOD classes are given
_NUM_BIG = 12

# face -> (axis, sign, (u axis, u coeff), (v axis, v coeff)) matching
# `GetLocalPos` (`CSRayMarch.hlsl:28-53`): u = 0.5 + cu * e[bu], ...
_FACES = (
    (0, +1.0, (2, -0.5), (1, -0.5)),   # +X
    (0, -1.0, (2, +0.5), (1, -0.5)),   # -X
    (1, +1.0, (0, +0.5), (2, +0.5)),   # +Y
    (1, -1.0, (0, +0.5), (2, -0.5)),   # -Y
    (2, +1.0, (0, +0.5), (1, -0.5)),   # +Z
    (2, -1.0, (0, -0.5), (1, -0.5)),   # -Z
)


def screen_basis(screen_to_world, eye):
    """(3, 3) matrix A with d_world = [x_ndc, y_ndc, 1] @ A (the
    mid-depth unprojection of `composite.screen_rays`, kept homogeneous)."""
    m = screen_to_world
    rows = [m[0], m[1], 0.5 * m[2] + m[3]]
    return torch.stack([r[:3] - eye * r[3] for r in rows])


def face_homography(b_mat, o, face: int):
    """Homography coefficient vectors (nu, nv, den), each (..., 3), for one
    exit face. b_mat: (..., 3, 3) with d_local = q @ b_mat; o: (..., 3)
    local eye."""
    a, s, (bu, cu), (bv, cv) = _FACES[face]
    den = b_mat[..., :, a]

    def exit_num(comp):
        # e_comp numerator: o_comp * d_a + (s - o_a) * d_comp
        return (o[..., comp, None] * den
                + (s - o[..., a, None]) * b_mat[..., :, comp])

    nu = 0.5 * den + cu * exit_num(bu)
    nv = 0.5 * den + cv * exit_num(bv)
    return nu, nv, den


def local_basis(a_mat, world_i):
    """(N, 3, 3) B = A @ world_i[:3, :3]: d_local = q @ B."""
    return torch.einsum("ij,njk->nik", a_mat, world_i[:, :3, :3])


def face_rows(b_mat, eye_local, n_eff):
    """Each volume's six face homographies in texels -> (p_u, p_v, den),
    each (N, 6, 3): (p_u.q)/(den.q) = n_eff * u - 0.5, likewise v. b_mat
    (N, 3, 3) from `local_basis`, eye_local (N, 3), n_eff (N,) float."""
    rows = []
    for f in range(6):
        nu, nv, den = face_homography(b_mat, eye_local, f)
        rows.append((n_eff[:, None] * nu - 0.5 * den,
                     n_eff[:, None] * nv - 0.5 * den, den))
    return tuple(torch.stack(r, dim=1) for r in zip(*rows))


def pick_swap_flags(p_u, p_v, den, world_view_proj):
    """(N, 6) bool Catmull-Smith resample-axis choice from the rows of
    `face_rows`: True = the face image is consumed transposed, its u axis
    varying more with screen y at the volume's projected centre."""
    c0 = world_view_proj[:, 3, :]
    c0w = torch.where(c0[:, 3].abs() > 1e-3, c0[:, 3], 1e-3)
    xc = torch.clamp(c0[:, 0] / c0w, -1.0, 1.0)[:, None]
    yc = torch.clamp(c0[:, 1] / c0w, -1.0, 1.0)[:, None]
    dqc = den[..., 0] * xc + den[..., 1] * yc + den[..., 2]
    vqc = p_v[..., 0] * xc + p_v[..., 1] * yc + p_v[..., 2]
    uqc = p_u[..., 0] * xc + p_u[..., 1] * yc + p_u[..., 2]
    dv_dy = p_v[..., 1] * dqc - den[..., 1] * vqc
    du_dy = p_u[..., 1] * dqc - den[..., 1] * uqc
    return dv_dy.abs() < du_dy.abs()


def catmull_swap_flags(a_mat, world_i, world_view_proj, eye_local, n_eff):
    """(N, 6) bool Catmull-Smith flags: `pick_swap_flags` of the rows."""
    rows = face_rows(local_basis(a_mat, world_i), eye_local, n_eff)
    return pick_swap_flags(*rows, world_view_proj)


def _safe(x, eps=_EPS):
    return torch.where(x.abs() > eps, x, torch.where(x >= 0, eps, -eps))


def _tent(pos, n: int, dtype):
    """2-tap tent rows (..., n): max(0, 1 - |i - pos|); for pos in
    [0, n - 1] linear interpolation with clamp-to-edge."""
    i = torch.arange(n, dtype=torch.float32, device=pos.device)
    return torch.clamp(1.0 - (i - pos[..., None]).abs(), min=0.0).to(dtype)


def _clip_coord(c, hi):
    """nan/inf -> 0, then clip to [0, hi] (hi a float or a 0-d tensor)."""
    c = torch.clamp(torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0),
                    min=0.0)
    return torch.minimum(c, torch.as_tensor(hi, dtype=c.dtype,
                                            device=c.device))


def _chunk(wt: int) -> int:
    chunk = 16
    while wt % chunk:
        chunk //= 2
    return chunk


def rectified_ok(p_v, den, xg, yg):
    """0-d bool: pass 2 of `warp_face` may take the piecewise-rectified
    form (|dv/dx| at the tile centre keeps a chunk's sweep within one
    texel)."""
    wt = xg.shape[0]
    xc = (xg[0] + xg[-1]) * 0.5
    yc = (yg[0] + yg[-1]) * 0.5
    dqc = den[0] * xc + den[1] * yc + den[2]
    vqc = p_v[0] * xc + p_v[1] * yc + p_v[2]
    dv_dx = (p_v[0] * dqc - den[0] * vqc) / _safe(dqc * dqc)
    px_ndc = (xg[1] - xg[0]).abs() if wt > 1 else 1.0
    return dv_dx.abs() * px_ndc * (_chunk(wt) * 0.5) < 1.0


def warp_face(img, p_u, p_v, den, xg, yg, hi=None, rectified=None):
    """Two-pass separable projective warp of one face image to a tile.

    img: (C, S, S) indexed [v, u], sliced to the class's extent; p_u, p_v,
    den: the homography 3-vectors in texel space; xg (Wt,), yg (Ht,) the
    tile's NDC coordinates. Returns (C, Ht, Wt) f32 = img[v, u] with
    clamp-to-edge. Pass 1 resamples each face row along u where v(x, y)
    equals the row; pass 2 interpolates along the rows, either densely
    per pixel or, where `rectified_ok` holds, from two chunk-end anchor
    maps plus a first-order correction (`rectified`: the caller's
    decision, else read here). The products accumulate in f32 and pass
    1's result is rounded to img's dtype, as the JAX einsums do."""
    s = img.shape[-1]
    dt = img.dtype
    dev = img.device
    if hi is None:
        hi = s - 1.0
    if rectified is None:
        rectified = bool(rectified_ok(p_v, den, xg, yg))

    r = torch.arange(s, dtype=torch.float32, device=dev)
    k0 = p_v[0] - r * den[0]
    k1 = p_v[1] - r * den[1]
    k2 = p_v[2] - r * den[2]
    y1 = -(k0[:, None] * xg[None, :] + k2[:, None]) / _safe(k1)[:, None]
    dq1 = den[0] * xg[None, :] + den[1] * y1 + den[2]
    ut = _clip_coord((p_u[0] * xg[None, :] + p_u[1] * y1 + p_u[2])
                     / _safe(dq1), hi)
    w1 = _tent(ut, s, dt)                                  # (S, Wt, S_u)
    tmp = torch.einsum("cvu,vxu->cvx", img.float(), w1.float()).to(dt)

    dq = den[0] * xg[None, :] + den[1] * yg[:, None] + den[2]
    vt = _clip_coord((p_v[0] * xg[None, :] + p_v[1] * yg[:, None] + p_v[2])
                     / _safe(dq), hi)
    if not rectified:
        w2 = _tent(vt, s, dt)                              # (Ht, Wt, S_v)
        return torch.einsum("cvx,yxv->cyx", tmp.float(), w2.float())

    wt, ht_n = xg.shape[0], yg.shape[0]
    chunk = _chunk(wt)
    n_ch = wt // chunk
    c = tmp.shape[0]
    tmp_n = tmp.reshape(c, s, n_ch, chunk).float()
    vt_n = vt.reshape(ht_n, n_ch, chunk)

    def anchored(xa):
        dqa = den[0] * xa[:, None] + den[1] * yg[None, :] + den[2]
        vt_c = _clip_coord((p_v[0] * xa[:, None] + p_v[1] * yg[None, :]
                            + p_v[2]) / _safe(dqa), hi)     # (n_ch, Ht)
        w2 = _tent(vt_c, s, dt).float()                    # (n_ch, Ht, S)
        v0 = torch.clamp(torch.floor(vt_c), 0.0, s - 2.0)
        w2d = ((r == v0[..., None] + 1.0).to(dt).float()
               - (r == v0[..., None]).to(dt).float())
        base = torch.einsum("nyv,cvnx->cnyx", w2, tmp_n)
        slope = torch.einsum("nyv,cvnx->cnyx", w2d, tmp_n)
        delta_raw = vt_n - vt_c.T[:, :, None]              # (Ht, n_ch, ch)
        delta = torch.clamp(delta_raw, -2.0, 2.0)
        return (base + delta[None].permute(0, 2, 1, 3) * slope, dqa,
                delta_raw.abs())

    out_l, dq_l, ad_l = anchored(xg[0::chunk])
    out_r, dq_r, ad_r = anchored(xg[chunk - 1::chunk])
    dq_n = dq.reshape(ht_n, n_ch, chunk)
    same_l = (dq_n * dq_l.T[:, :, None]) > 0.0
    same_r = (dq_n * dq_r.T[:, :, None]) > 0.0
    use_l = torch.where(same_l == same_r, ad_l <= ad_r, same_l)
    out = torch.where(use_l[None].permute(0, 2, 1, 3), out_l, out_r)
    return out.permute(0, 2, 1, 3).reshape(c, ht_n, wt)


def composite_oit_warp(cube_maps, per_object, cull, eye, screen_to_world,
                       depth_map, width: int, height: int, num_layers: int,
                       tile: int, lod_order=None, lod_buckets=None):
    """The OIT composite by per-volume tile warps -> premultiplied (r, g,
    b, a) screen fields, the semantics of
    `composite.composite_oit(use_raycast=False)`.

    cube_maps.color (N, 6, 4, S, S) unpacked, in volume order. Volumes go
    in footprint classes that mirror the sweep's LOD buckets
    (`lod_order`, `lod_buckets` from `sweep.lod_partition`): a class's
    maps have the static extent size_b and its tile scales with it; the
    mip-0 class's two largest volumes get a full-screen tile, the next
    four 3/5 of it, the rest 2/5. Without LOD classes every map is
    full-extent, the `_NUM_BIG` largest projected volumes get the
    full-screen tile and the rest `tile`. A footprint is clipped to its
    tile."""
    color = cube_maps.color
    if color.shape[2] != 4:
        raise ValueError("the warp composite needs unpacked cube maps")
    n = per_object.world.shape[0]
    s = color.shape[-1]
    dev = color.device
    num_layers = min(num_layers, n)
    a_mat = screen_basis(screen_to_world, eye)
    eye_local = math3d.transform_point3(eye, per_object.world_i)
    wi3 = per_object.world_i[:, :3, :3]
    wvp_all = per_object.world_view_proj
    scene_z = depth_map if depth_map is not None else torch.ones(
        (height, width), dtype=torch.float32, device=dev)
    n_eff_all = (s >> torch.clamp(cull.mip_level, 0, 31).long()).float()

    # tile anchors: the centre of the projected corner bbox
    corners = torch.tensor(
        [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
         for z in (-1.0, 1.0)], dtype=torch.float32, device=dev)
    ch_ = math3d.transform_point(corners[None], wvp_all[:, None])  # (N,8,4)
    cok = ch_[..., 3] > 1e-3
    chw = torch.clamp(ch_[..., 3], min=1e-3)
    px = (ch_[..., 0] / chw * 0.5 + 0.5) * width
    py = (-ch_[..., 1] / chw * 0.5 + 0.5) * height
    big = 1e9

    def vis_bounds(p, lim):
        lo = torch.clamp(torch.where(cok, p, big).amin(-1), 0, lim)
        hi = torch.clamp(torch.where(cok, p, -big).amax(-1), 0, lim)
        return lo, hi

    vx_lo, vx_hi = vis_bounds(px, width)
    vy_lo, vy_hi = vis_bounds(py, height)
    c0 = wvp_all[:, 3, :]
    c0w = torch.clamp(c0[:, 3], min=1e-3)
    c0x = (c0[:, 0] / c0w * 0.5 + 0.5) * width
    c0y = (-c0[:, 1] / c0w * 0.5 + 0.5) * height

    # layers (5, K, H, W): z, r, g, b, a
    layers = torch.cat([
        torch.full((1, num_layers, height, width), FLT_MAX,
                   dtype=torch.float32, device=dev),
        torch.zeros((4, num_layers, height, width), dtype=torch.float32,
                    device=dev)])

    def process(vid: int, x0: int, y0: int, ht: int, wt: int, n_eff: int):
        xg = (x0 + torch.arange(wt, dtype=torch.float32, device=dev)
              + 0.5) / width * 2.0 - 1.0
        yg = -((y0 + torch.arange(ht, dtype=torch.float32, device=dev)
                + 0.5) / height * 2.0 - 1.0)
        b_mat = a_mat @ wi3[vid]
        o = eye_local[vid]
        dl = [b_mat[0, j] * xg[None, :] + b_mat[1, j] * yg[:, None]
              + b_mat[2, j] for j in range(3)]
        ox, oy, oz = (o[j].expand_as(dl[0]) for j in range(3))
        hit, t_exit = _ray_box_exit_soa(ox, oy, oz, *dl)
        qx, qy, qz = (ox + dl[0] * t_exit, oy + dl[1] * t_exit,
                      oz + dl[2] * t_exit)
        face_id = dir_to_face_uv_soa(qx, qy, qz)[0]
        _hx, _hy, hz, hw = raymarch._transform_point_soa(qx, qy, qz,
                                                         wvp_all[vid])
        exit_z = hz / torch.clamp(hw, min=1e-20)
        sz = scene_z[y0:y0 + ht, x0:x0 + wt]
        valid = hit & (hw > 0.0) & (exit_z <= sz) & (exit_z > 0.0)

        n_eff_v = n_eff_all[vid]
        img_all = color[vid][:, :, :n_eff, :n_eff]         # (6, 4, n, n)
        xc, yc = (xg[0] + xg[-1]) * 0.5, (yg[0] + yg[-1]) * 0.5
        faces = []
        for f in range(6):
            nu, nv, den = face_homography(b_mat, o, f)
            p_u = n_eff_v * nu - 0.5 * den
            p_v = n_eff_v * nv - 0.5 * den
            # resample rows along the face axis that varies more with
            # screen y
            dqc = den[0] * xc + den[1] * yc + den[2]
            vqc = p_v[0] * xc + p_v[1] * yc + p_v[2]
            uqc = p_u[0] * xc + p_u[1] * yc + p_u[2]
            swap = (p_v[1] * dqc - den[1] * vqc).abs() \
                < (p_u[1] * dqc - den[1] * uqc).abs()
            rect = torch.where(swap, rectified_ok(p_u, den, xg, yg),
                               rectified_ok(p_v, den, xg, yg))
            faces.append((p_u, p_v, den, (valid & (face_id == f)).any(),
                          swap, rect))
        flags = torch.stack([torch.stack([x[3], x[4], x[5]])
                             for x in faces]).cpu().tolist()
        rr, gg, bb, aa = (torch.zeros((ht, wt), dtype=torch.float32,
                                      device=dev) for _ in range(4))
        for f, ((p_u, p_v, den, _a, _s, _r), (any_f, swap, rect)) in \
                enumerate(zip(faces, flags)):
            if not any_f:
                continue
            img_f = img_all[f]
            if swap:
                img_f, p_u, p_v = img_f.transpose(-1, -2), p_v, p_u
            warped = warp_face(img_f, p_u, p_v, den, xg, yg,
                               hi=n_eff_v - 1.0, rectified=rect)
            use_f = valid & (face_id == f)
            rr = torch.where(use_f, warped[0], rr)
            gg = torch.where(use_f, warped[1], gg)
            bb = torch.where(use_f, warped[2], bb)
            aa = torch.where(use_f, warped[3], aa)

        # `PSCube.hlsl:57` stores 0 < w <= 1; the tent weights round in
        # the maps' dtype, so alpha 1 may overshoot: clamp, not drop
        aa = torch.clamp(aa, max=1.0)
        store_ok = (aa > 0.0) & valid
        new = [torch.where(store_ok, exit_z, FLT_MAX)] + [
            torch.where(store_ok, x, 0.0) for x in (rr, gg, bb, aa)]
        t5 = layers[:, :, y0:y0 + ht, x0:x0 + wt]
        for k in range(num_layers):
            take = new[0] < t5[0, k]
            for c in range(5):
                old = t5[c, k].clone()
                t5[c, k] = torch.where(take, new[c], old)
                new[c] = torch.where(take, old, new[c])

    def run_group(ids, tile_px: int, n_eff: int):
        if ids.numel() == 0:
            return
        wt, ht = min(tile_px, width), min(tile_px, height)
        cx = torch.where(vx_hi[ids] - vx_lo[ids] <= wt,
                         (vx_lo[ids] + vx_hi[ids]) * 0.5, c0x[ids])
        cy = torch.where(vy_hi[ids] - vy_lo[ids] <= ht,
                         (vy_lo[ids] + vy_hi[ids]) * 0.5, c0y[ids])
        x0 = torch.clamp(torch.round(cx - wt * 0.5), 0, width - wt).long()
        y0 = torch.clamp(torch.round(cy - ht * 0.5), 0, height - ht).long()
        host = torch.stack([ids.long(), x0, y0,
                            cull.visible[ids].long()]).cpu().tolist()
        for vid, xo, yo, vis in zip(*host):
            if vis:
                process(vid, xo, yo, ht, wt, n_eff)

    full_px = max(width, height)
    if lod_order is not None and lod_buckets is not None:
        for (b0, count, size_b, mip_b) in lod_buckets:
            ids = lod_order[b0:b0 + count]
            if mip_b == 0:
                ladder = [(2, full_px), (4, (full_px * 3) // 5),
                          (count, (full_px * 2) // 5)]
                at = 0
                for cap, tile_px in ladder:
                    take = min(cap, count - at)
                    if take <= 0:
                        break
                    run_group(ids[at:at + take], tile_px, size_b)
                    at += take
            else:
                run_group(ids, max(128, min(tile, 6 * size_b)), size_b)
    else:
        n_big = min(_NUM_BIG, n) if tile < full_px else 0
        order = torch.argsort(-cull.max_edge_px, stable=True)
        if n_big:
            run_group(order[:n_big], full_px, s)
            run_group(order[n_big:], tile, s)
        else:
            run_group(torch.arange(n, device=dev), tile, s)
    return _underblend(layers[1], layers[2], layers[3], layers[4],
                       num_layers, height, width)
