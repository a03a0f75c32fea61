"""View-space ray marching in cube-map space: the reference march.

Counterpart of `multivolumes_tpu/render/raymarch.py`: `CSRayMarchV`
(`CSRayMarch.hlsl:77-158`) and the shared marching math of
`RayMarch.hlsli`. For every interior-face texel of every visible volume's
cube map, the ray from the local-space eye through the texel composites
trilinear density samples front to back, modulated by the volume's light
map, with the adaptive step (`GetStep`), the transmittance early-out and
the scene-depth bound (`GetTMax`). This is the reference-semantics path
(`march_mode="reference"`) the plane sweep is held against; the sweep's
occlusion bound uses its geometry helpers too.

The march runs in eager PyTorch. Its loop stops, as the JAX
`lax.while_loop` does, when every ray is done or after `max_steps`; the
body is masked per ray, so the result does not depend on when the loop
looks. It looks every `CHECK_EVERY` steps (one host read), and then
marches on only the rays that are not done yet: an exact compaction.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.ops.trilinear import indexed_trilinear_soa

ABSORPTION = SharedConsts.ABSORPTION
ZERO_THRESHOLD = SharedConsts.ZERO_THRESHOLD
MAX_DIST = SharedConsts.MAX_DIST
FLT_MAX = 3.402823466e38
# steps between two looks at the march's done mask (a host read each)
CHECK_EVERY = 8


class CubeMaps(NamedTuple):
    color: torch.Tensor            # (N, 6, 4, S, S) channel-mid
    depth: Optional[torch.Tensor]  # (N, 6, S, S) scene depth behind each
                                   # texel; None without a scene depth


def _safe(d, eps=1e-12):
    return torch.where(d.abs() > eps, d,
                       torch.where(d >= 0, eps, -eps))


def get_local_pos_soa(px, py, face):
    """Interior-face texel -> local position (x, y, z) (`GetLocalPos`,
    `CSRayMarch.hlsl:28-53`); face broadcasts against px, py."""
    one = torch.ones_like(px)
    fx = [one, -one, px, px, px, -px]
    fy = [py, py, one, -one, py, py]
    fz = [-px, px, -py, py, one, -one]

    def sel(cands):
        out = cands[0]
        for i in range(1, 6):
            out = torch.where(face == i, cands[i], out)
        return out

    return sel(fx), sel(fy), sel(fz)


def compute_ray_origin_soa(ox, oy, oz, dx, dy, dz):
    """Clip a ray start to the unit box (`ComputeRayOrigin`,
    `RayMarch.hlsli:128-155`) -> (x, y, z, hit)."""
    inside = (ox.abs() <= 1.0) & (oy.abs() <= 1.0) & (oz.abs() <= 1.0)
    comps = ((ox, dx), (oy, dy), (oz, dz))
    best_u = torch.full_like(ox, FLT_MAX)
    any_hit = torch.zeros_like(inside)
    for i in range(3):
        o_i, d_i = comps[i]
        u = (-torch.sign(_safe(d_i)) - o_i) / _safe(d_i)
        ok = (u >= 0.0) & (d_i.abs() > 1e-12)
        for j in range(3):
            if j != i:
                o_j, d_j = comps[j]
                ok = ok & ((d_j * u + o_j).abs() <= 1.0 + 1e-6)
        best_u = torch.where(ok & (u < best_u), u, best_u)
        any_hit = any_hit | ok
    u = torch.where(any_hit, best_u, 0.0)
    cx = torch.clamp(ox + dx * u, -1.0, 1.0)
    cy = torch.clamp(oy + dy * u, -1.0, 1.0)
    cz = torch.clamp(oz + dz * u, -1.0, 1.0)
    return (torch.where(inside, ox, cx), torch.where(inside, oy, cy),
            torch.where(inside, oz, cz), inside | any_hit)


def compute_target_hit_soa(ox, oy, oz, tx, ty, tz, dx, dy, dz):
    """`ComputeTargetHit` (`RayMarch.hlsli:160-165`)."""
    ux = (tx - ox) / _safe(dx)
    uy = (ty - oy) / _safe(dy)
    uz = (tz - oz) / _safe(dz)
    return torch.maximum(torch.maximum(ux, uy), uz)


def get_t_max_soa(cx, cy, cz, ox, oy, oz, dx, dy, dz, wvp_i):
    """Occluded end point from a scene-depth sample (`GetTMax`,
    `RayMarch.hlsli:82-97`): clip position (cx, cy, cz = depth), wvp_i
    (..., 4, 4) broadcastable row-vector inverse, or (..., 16) its rows
    flattened. FLT_MAX where the depth is the far plane."""
    flat16 = wvp_i.shape[-1] == 16

    def m(r, c):
        return wvp_i[..., r * 4 + c] if flat16 else wvp_i[..., r, c]

    hw = _safe(cx * m(0, 3) + cy * m(1, 3) + cz * m(2, 3) + m(3, 3), 1e-20)

    def unproj(col):
        return (cx * m(0, col) + cy * m(1, col) + cz * m(2, col)
                + m(3, col)) / hw

    tx = (unproj(0) - ox) / _safe(dx)
    ty = (unproj(1) - oy) / _safe(dy)
    tz = (unproj(2) - oz) / _safe(dz)
    t = torch.maximum(torch.maximum(tx, ty), tz)
    return torch.where(cz >= 1.0, FLT_MAX, t)


def _transform_point_soa(x, y, z, m):
    """Row-vector transform of SoA points by m (..., 4, 4) -> (hx, hy, hz,
    hw)."""
    hx = x * m[..., 0, 0] + y * m[..., 1, 0] + z * m[..., 2, 0] + m[..., 3, 0]
    hy = x * m[..., 0, 1] + y * m[..., 1, 1] + z * m[..., 2, 1] + m[..., 3, 1]
    hz = x * m[..., 0, 2] + y * m[..., 1, 2] + z * m[..., 2, 2] + m[..., 3, 2]
    hw = x * m[..., 0, 3] + y * m[..., 1, 3] + z * m[..., 2, 3] + m[..., 3, 3]
    return hx, hy, hz, hw


def get_step(d_density, transm, density, step_scale):
    """Adaptive step size (`GetStep`, `RayMarch.hlsli:182-192`)."""
    factor_ev = torch.clamp(
        1.0 / 256.0 / torch.clamp(d_density.abs(), min=1e-20), max=2.0)
    factor_ui = torch.clamp(1.0 - density, max=1.0)
    factor_th = 1.0 - transm
    return step_scale * torch.clamp(1.5 * factor_ev * factor_ui * factor_th,
                                    min=1.0)


class MarchResult(NamedTuple):
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    a: torch.Tensor


def march_scatter(
    sample_fn: Callable,   # (u, v, w, rows) -> (cr, cg, cb, density)
    light_fn: Callable,    # (u, v, w, rows) -> (lr, lg, lb)
    origin,                # (ox, oy, oz) scalar fields, box-clipped
    direction,             # (dx, dy, dz)
    t_max,                 # (...,)
    smp_count,             # (...,) int
    step_scale,            # (...,)
    max_steps: int,
    active,                # (...,) bool
    adaptive: bool = True,
    check_every: int = CHECK_EVERY,
) -> MarchResult:
    """Front-to-back scatter accumulation, the inner loop of
    `CSRayMarch.hlsl:112-155` with break -> done-mask semantics.

    The fields broadcast to t_max's shape and are marched as one flat
    batch of rays; `sample_fn` and `light_fn` get the sample positions of
    the rays still marching and their flat indices `rows` into that batch
    (the JAX callables take the positions of every ray). Every
    `check_every` steps the march reads how many rays are left, drops the
    done ones, and stops when none is left, which is when the JAX loop
    stops too. The JAX result's loop count (`steps`) has no reader and is
    not kept."""
    shape = t_max.shape
    dev = t_max.device
    nr = t_max.numel()

    def flat(x, dtype=None):
        x = torch.as_tensor(x, device=dev)
        x = torch.broadcast_to(x, shape).reshape(-1)
        return x if dtype is None else x.to(dtype)

    ox, oy, oz = (flat(x, torch.float32) for x in origin)
    dx, dy, dz = (flat(x, torch.float32) for x in direction)
    tmx, smp = flat(t_max, torch.float32), flat(smp_count, torch.int32)
    ss = flat(step_scale, torch.float32)
    out = torch.zeros((4, nr), dtype=torch.float32, device=dev)
    rows = flat(active).nonzero().squeeze(1)
    const = [ox, oy, oz, dx, dy, dz, tmx, smp, ss]
    cur = [x[rows] for x in const]
    z = torch.zeros(rows.shape, dtype=torch.float32, device=dev)
    t, sr, sg, sb, sa, prev = z, z, z, z, z, z
    done = torch.zeros(rows.shape, dtype=torch.bool, device=dev)
    i = 0
    while i < max_steps and rows.numel():
        c_ox, c_oy, c_oz, c_dx, c_dy, c_dz, c_tm, c_smp, c_ss = cur
        for _ in range(min(check_every, max_steps - i)):
            px = c_ox + c_dx * t
            py = c_oy + c_dy * t
            pz = c_oz + c_dz * t
            out_of_box = (px.abs() > 1.0) | (py.abs() > 1.0) \
                | (pz.abs() > 1.0)
            done = done | out_of_box | (i >= c_smp)
            u, v, w = px * 0.5 + 0.5, py * 0.5 + 0.5, pz * 0.5 + 0.5
            cr, cg, cb, density = sample_fn(u, v, w, rows)
            occupied = density > ZERO_THRESHOLD
            transm = 1.0 - sa
            lr, lg, lb = light_fn(u, v, w, rows)
            if adaptive:
                new_step = torch.where(
                    occupied, get_step(density - prev, transm, density, c_ss),
                    c_ss)
            else:
                new_step = c_ss
            do_acc = occupied & ~done
            kk = torch.where(do_acc, ABSORPTION * transm, 0.0)
            sr = sr + cr * density * lr * kk
            sg = sg + cg * density * lg * kk
            sb = sb + cb * density * lb * kk
            sa = sa + density * kk
            prev = torch.where(do_acc, density, prev)
            done = done | (occupied & (transm < ZERO_THRESHOLD))
            t = torch.where(done, t, t + new_step)
            done = done | (t > c_tm)
            i += 1
        keep = (~done).nonzero().squeeze(1)
        if keep.numel() < rows.numel() or i >= max_steps:
            fin = done if i < max_steps else torch.ones_like(done)
            out[:, rows[fin]] = torch.stack([sr, sg, sb, sa])[:, fin]
            rows = rows[keep]
            cur = [x[keep] for x in cur]
            t, sr, sg, sb, sa, prev, done = (
                x[keep] for x in (t, sr, sg, sb, sa, prev, done))
    out = out.reshape(4, *shape)
    return MarchResult(r=out[0], g=out[1], b=out[2], a=out[3])


def ray_march_view(
    volumes,              # (N_src, D, H, W, 4)
    vol_tex_ids,          # (N,)
    light_maps,           # (N, L, L, L, 3) channel-last
    per_object,
    cull,
    eye,                  # (3,)
    depth_map,            # (Hd, Wd) scene clip depth, or None
    cube_map_size: int,
    max_steps: int,
    adaptive: bool = True,
) -> CubeMaps:
    """March every visible volume's cube map -> colour (N, 6, 4, S, S) and
    the scene depth behind each texel (ones without a depth map).

    The dense form of the `rayMarchV` ExecuteIndirect pass
    (`MultiRayCaster.cpp:1329-1368`): a volume at mip m marches the
    (S >> m)^2 texels of the top-left corner of each face."""
    n = vol_tex_ids.shape[0]
    s = cube_map_size
    dev = volumes.device
    eye_local = math3d.transform_point3(eye, per_object.world_i)  # (N, 3)
    s_mip = (s >> torch.clamp(cull.mip_level, max=31)).float()

    ij = torch.arange(s, dtype=torch.float32, device=dev)
    jj, ii = torch.meshgrid(ij, ij, indexing="ij")
    sm = s_mip[:, None, None, None]
    px = (ii[None, None] + 0.5) / sm * 2.0 - 1.0
    py = -((jj[None, None] + 0.5) / sm * 2.0 - 1.0)
    texel_valid = (ii[None, None] < sm) & (jj[None, None] < sm)
    px, py = px.expand(n, 6, s, s), py.expand(n, 6, s, s)
    face = torch.arange(6, device=dev)[None, :, None, None]
    tx, ty, tz = get_local_pos_soa(px, py, face)

    ox, oy, oz = (eye_local[:, c, None, None, None].expand_as(tx)
                  for c in range(3))
    dxu, dyu, dzu = tx - ox, ty - oy, tz - oz
    inv_len = torch.rsqrt(torch.clamp(dxu * dxu + dyu * dyu + dzu * dzu,
                                      min=1e-20))
    dx, dy, dz = dxu * inv_len, dyu * inv_len, dzu * inv_len
    ox, oy, oz, is_hit = compute_ray_origin_soa(ox, oy, oz, dx, dy, dz)
    t_max = compute_target_hit_soa(ox, oy, oz, tx, ty, tz, dx, dy, dz)

    active = (is_hit & cull.face_mask[:, :, None, None] & texel_valid
              & cull.visible[:, None, None, None]
              & cull.use_cube_map[:, None, None, None])

    if depth_map is not None:
        prx, pry, prz = ox + 0.01 * dx, oy + 0.01 * dy, oz + 0.01 * dz
        wvp = per_object.world_view_proj[:, None, None, None]
        hx, hy, _hz, hw = _transform_point_soa(prx, pry, prz, wvp)
        hw = _safe(hw, 1e-20)
        cx, cy = hx / hw, hy / hw
        uu = cx * 0.5 + 0.5
        vv = 1.0 - (cy * 0.5 + 0.5)
        hd, wd = depth_map.shape
        z = depth_map[_nearest_tap(vv, hd), _nearest_tap(uu, wd)]
        cube_depth = z
        t_occ = get_t_max_soa(
            cx, cy, z, ox, oy, oz, dx, dy, dz,
            per_object.world_view_proj_i[:, None, None, None])
        t_max = torch.minimum(t_max, t_occ)
    else:
        cube_depth = torch.ones(tx.shape, dtype=torch.float32, device=dev)

    smp_count = cull.smp_count[:, None, None, None]
    step_scale = MAX_DIST / torch.clamp(smp_count.float(), min=1.0)
    tex_idx = vol_tex_ids.long()[:, None, None, None].expand(tx.shape) \
        .reshape(-1)
    lm_idx = torch.arange(n, device=dev)[:, None, None, None].expand(
        tx.shape).reshape(-1)

    def sample_fn(u, v, w, rows):
        return indexed_trilinear_soa(volumes, tex_idx[rows], u, v, w)

    def light_fn(u, v, w, rows):
        return indexed_trilinear_soa(light_maps, lm_idx[rows], u, v, w)

    res = march_scatter(sample_fn, light_fn, (ox, oy, oz), (dx, dy, dz),
                        t_max, smp_count, step_scale, max_steps, active,
                        adaptive)
    inv2pi = 1.0 / (2.0 * math.pi)
    color = torch.stack([res.r * inv2pi, res.g * inv2pi, res.b * inv2pi,
                         res.a], dim=2)
    return CubeMaps(color=torch.where(active[:, :, None], color, 0.0),
                    depth=cube_depth)


def _nearest_tap(c, nn: int):
    """Nearest texel of normalized coordinate c on an axis of nn texels:
    truncation toward zero as the JAX int32 cast, kept in range."""
    return torch.clamp(torch.clamp(c * nn, -1.0, float(nn)).long(), 0,
                       nn - 1)
