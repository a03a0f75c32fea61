"""Light-space ray marching: one volume's light map per frame, with
inter-volume self-shadowing and SH ambient occlusion.

Counterpart of `multivolumes_tpu/render/lightmarch.py`: `CSRayMarchL`
(`CSRayMarchL.hlsl:20-121`) and `CastLightRay` (`RayMarch.hlsli:197-230`),
the reference-semantics light path (`light_mode="reference"`, and every
`point_light`). One volume's map is refreshed per frame
(`CSRayMarchL.hlsl:29-33`); for every voxel of its light grid, (1) a
shadow-map test against the opaque scene, (2) a transmittance march
toward the light through every volume of the scene, and (3) with the
light probe, an ambient-occlusion march along the negated density
gradient that attenuates the SH irradiance.

Unlike the shear-warp light sweep, it takes any volume world (rotated,
anisotropic): it is the light path for such volumes. Each light ray is
marched like the view rays of `raymarch.march_scatter`: a masked body,
a look at the done mask every `raymarch.CHECK_EVERY` steps, and only the
rays not yet done marched on.
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch.core import sh as sh_lib
from multivolumes_tpu_torch.ops.trilinear import indexed_trilinear_channel
from multivolumes_tpu_torch.render import raymarch

ABSORPTION = SharedConsts.ABSORPTION
ZERO_THRESHOLD = SharedConsts.ZERO_THRESHOLD
MAX_DIST = SharedConsts.MAX_DIST


def select_update_volume(visible, frame_idx: int):
    """`volumeId = visibleVolumes[frameIdx % visibleCount]` over a dense
    mask: the (frame_idx mod count)-th visible volume, or frame_idx mod N
    when none is visible (`CSRayMarchL.hlsl:29-33`). A 0-d int64 tensor
    on the mask's device (no host read)."""
    n = visible.shape[0]
    vis = visible.long()
    count = vis.sum()
    rank = torch.cumsum(vis, 0) - 1
    k = torch.where(count > 0, frame_idx % torch.clamp(count, min=1), 0)
    ids = torch.arange(n, device=visible.device)
    cand = torch.where(visible & (rank == k), ids, n)
    return torch.where(count > 0, cand.min(), frame_idx % n)


def shadow_test_soa(wx, wy, wz, shadow_map, shadow_vp, bias: float = 0.0027):
    """PCF shadow compare (`ShadowTest`, `RayMarch.hlsli:103-113`): the
    bilinear blend of the four per-texel (z - bias <= depth) tests of a
    LESS_EQUAL comparison sampler."""
    m = shadow_vp
    lx = wx * m[0, 0] + wy * m[1, 0] + wz * m[2, 0] + m[3, 0]
    ly = wx * m[0, 1] + wy * m[1, 1] + wz * m[2, 1] + m[3, 1]
    lz = wx * m[0, 2] + wy * m[1, 2] + wz * m[2, 2] + m[3, 2]
    u = lx * 0.5 + 0.5
    v = 1.0 - (ly * 0.5 + 0.5)
    z = lz - bias
    h, w = shadow_map.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f

    def cidx(vv, nn):
        return torch.clamp(vv.long(), 0, nn - 1)

    x0, x1 = cidx(x0f, w), cidx(x0f + 1, w)
    y0, y1 = cidx(y0f, h), cidx(y0f + 1, h)

    def cmp(yi, xi):
        return (z <= shadow_map[yi, xi]).float()

    c0 = cmp(y0, x0) * (1 - fx) + cmp(y0, x1) * fx
    c1 = cmp(y1, x0) * (1 - fx) + cmp(y1, x1) * fx
    return c0 * (1 - fy) + c1 * fy


def density_gradient_soa(volumes, tex_idx, u, v, w):
    """Central-difference density gradient (`GetDensityGradient`,
    `RayMarch.hlsli:55-77`): six one-texel-offset linear taps."""
    d, h, ww = volumes.shape[1:4]

    def dens(du, dv, dw):
        return indexed_trilinear_channel(volumes, 3, tex_idx, u + du,
                                         v + dv, w + dw)

    gx = dens(1.0 / ww, 0, 0) - dens(-1.0 / ww, 0, 0)
    gy = dens(0, 1.0 / h, 0) - dens(0, -1.0 / h, 0)
    gz = dens(0, 0, 1.0 / d) - dens(0, 0, -1.0 / d)
    return gx, gy, gz


def cast_light_ray(volumes, tex_id, origin, ray_dir, transm0,
                   step_scale: float, num_samples: int, active,
                   check_every: int = raymarch.CHECK_EVERY):
    """Transmittance march toward the light (`CastLightRay`,
    `RayMarch.hlsli:197-230`): origin and ray_dir are (x, y, z) scalar
    fields, tex_id the source volume per ray, transm0 (...,) the starting
    transmittance; rays not `active` keep it."""
    shape = transm0.shape
    dev = transm0.device

    def flat(x):
        return torch.broadcast_to(torch.as_tensor(x, device=dev),
                                  shape).reshape(-1)

    out = transm0.reshape(-1).clone()
    rows = flat(active).nonzero().squeeze(1)
    cur = [flat(x)[rows] for x in (*origin, *ray_dir)] + [
        flat(tex_id)[rows]]
    t = torch.full(rows.shape, float(step_scale), dtype=torch.float32,
                   device=dev)
    transm = out[rows]
    prev = torch.zeros_like(t)
    done = torch.zeros(rows.shape, dtype=torch.bool, device=dev)
    i = 0
    while i < num_samples and rows.numel():
        ox, oy, oz, dx, dy, dz, tex = cur
        for _ in range(min(check_every, num_samples - i)):
            px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
            done = done | (px.abs() > 1.0) | (py.abs() > 1.0) \
                | (pz.abs() > 1.0)
            density = indexed_trilinear_channel(
                volumes, 3, tex, px * 0.5 + 0.5, py * 0.5 + 0.5,
                pz * 0.5 + 0.5)
            opacity = torch.clamp(density * step_scale, 0.0, 1.0)
            new_step = raymarch.get_step(density - prev, transm, opacity,
                                         step_scale)
            upd = ~done
            transm = torch.where(upd, transm * (1.0 - density * ABSORPTION),
                                 transm)
            prev = torch.where(upd, density, prev)
            done = done | (transm < ZERO_THRESHOLD)
            t = torch.where(done, t, t + new_step)
            i += 1
        keep = (~done).nonzero().squeeze(1)
        if keep.numel() < rows.numel() or i >= num_samples:
            fin = done if i < num_samples else torch.ones_like(done)
            out[rows[fin]] = transm[fin]
            rows = rows[keep]
            cur = [x[keep] for x in cur]
            t, transm, prev, done = (x[keep] for x in (t, transm, prev,
                                                        done))
    return out.reshape(shape)


def ray_march_light(
    volumes,              # (N_src, D, H, W, 4)
    vol_tex_ids,          # (N,)
    light_maps,           # (N, 3, L, L, L), updated in place
    per_object,
    cull,
    frame_idx: int,
    shadow_map,           # (Sm, Sm) clip depth of the light's view, or None
    shadow_vp,            # (4, 4)
    light_pos,            # (4,)
    light_color,          # (4,) rgb + intensity
    ambient,              # (4,) rgb + intensity
    sh_coeffs,            # (9, 3)
    max_light_samples: int,
    has_light_probe: bool = True,
    point_light: bool = False,
    z_slab=None,          # (z0, zc): march light-grid z rows [z0, z0 + zc)
):
    """Refresh the light map of `select_update_volume(cull.visible,
    frame_idx)` in `light_maps` and return the stack.

    `point_light` is the `_POINT_LIGHT_` switch (`CSRayMarchL.hlsl:87-92`):
    each voxel marches toward the light point (light_pos with w = 1)
    instead of along the directional light's one vector. `z_slab` marches
    only those rows of the grid (the same values, a fraction of the rays
    and memory per call)."""
    l = light_maps.shape[-1]
    z0, zc = (0, l) if z_slab is None else z_slab
    vid, new_map = march_light_map(
        volumes, vol_tex_ids, per_object, cull, frame_idx, shadow_map,
        shadow_vp, light_pos, light_color, ambient, sh_coeffs,
        max_light_samples, l, has_light_probe=has_light_probe,
        point_light=point_light, z_slab=z_slab)
    light_maps[:, :, z0:z0 + zc].index_copy_(
        0, vid, new_map.to(light_maps.dtype)[None])
    return light_maps


def march_light_map(
    volumes, vol_tex_ids, per_object, cull, frame_idx: int, shadow_map,
    shadow_vp, light_pos, light_color, ambient, sh_coeffs,
    max_light_samples: int, light_grid_size: int,
    has_light_probe: bool = True, point_light: bool = False, z_slab=None,
):
    """The march of `ray_march_light` without the write -> (vid, the new
    map (3, zc, L, L) f32): `vid` (1,) the volume it belongs to
    (`select_update_volume`), on the device, so that a caller holding only
    some rows of the stack can write it without a host read."""
    n = vol_tex_ids.shape[0]
    l = light_grid_size
    dev = per_object.world.device
    vid = select_update_volume(cull.visible, frame_idx).reshape(1)
    step_scale = MAX_DIST / float(max_light_samples)

    ts = (torch.arange(l, dtype=torch.float32, device=dev) + 0.5) / l \
        * 2.0 - 1.0
    z0, zc = (0, l) if z_slab is None else z_slab
    lz, ly_, lx = torch.meshgrid(ts[z0:z0 + zc], ts, ts, indexing="ij")
    gshape = lz.shape

    tex_idx = vol_tex_ids.long().index_select(0, vid).expand(gshape)
    u, v, w = lx * 0.5 + 0.5, ly_ * 0.5 + 0.5, lz * 0.5 + 0.5
    density = indexed_trilinear_channel(volumes, 3, tex_idx, u, v, w)
    has_density = density >= ZERO_THRESHOLD

    world = per_object.world.index_select(0, vid)[0]
    wx = lx * world[0, 0] + ly_ * world[1, 0] + lz * world[2, 0] + world[3, 0]
    wy = lx * world[0, 1] + ly_ * world[1, 1] + lz * world[2, 1] + world[3, 1]
    wz = lx * world[0, 2] + ly_ * world[1, 2] + lz * world[2, 2] + world[3, 2]

    if shadow_map is not None:
        shadow = shadow_test_soa(wx, wy, wz, shadow_map, shadow_vp)
    else:
        shadow = torch.ones(gshape, dtype=torch.float32, device=dev)

    # SH ambient: the AO ray along the negated density gradient
    # (`CSRayMarchL.hlsl:61-75`)
    if has_light_probe:
        gx, gy, gz = density_gradient_soa(volumes, tex_idx, u, v, w)
        ax_, ay_, az_ = -gx, -gy, -gz
        zero_grad = (ax_.abs() + ay_.abs() + az_.abs()) <= 0.0
        ax_ = torch.where(zero_grad, lx, ax_)
        ay_ = torch.where(zero_grad, ly_, ay_)
        az_ = torch.where(zero_grad, lz, az_)
        awx = ax_ * world[0, 0] + ay_ * world[1, 0] + az_ * world[2, 0]
        awy = ax_ * world[0, 1] + ay_ * world[1, 1] + az_ * world[2, 1]
        awz = ax_ * world[0, 2] + ay_ * world[1, 2] + az_ * world[2, 2]
        inv = torch.rsqrt(torch.clamp(awx * awx + awy * awy + awz * awz,
                                      min=1e-20))
        awx, awy, awz = awx * inv, awy * inv, awz * inv
        irr_r, irr_g, irr_b = sh_lib.eval_irradiance_soa(sh_coeffs, awx,
                                                         awy, awz)

    ldx, ldy, ldz = light_pos[0], light_pos[1], light_pos[2]
    ao = torch.ones(gshape, dtype=torch.float32, device=dev)
    # every volume of the scene in turn (`CSRayMarchL.hlsl:77-110`)
    for j in range(n):
        m = per_object.world_i[j]
        onx = wx * m[0, 0] + wy * m[1, 0] + wz * m[2, 0] + m[3, 0]
        ony = wx * m[0, 1] + wy * m[1, 1] + wz * m[2, 1] + m[3, 1]
        onz = wx * m[0, 2] + wy * m[1, 2] + wz * m[2, 2] + m[3, 2]
        tex_j = vol_tex_ids[j]
        if point_light:
            # `_POINT_LIGHT_`: the light point in local space (w = 1), a
            # direction per voxel
            lpx = ldx * m[0, 0] + ldy * m[1, 0] + ldz * m[2, 0] + m[3, 0]
            lpy = ldx * m[0, 1] + ldy * m[1, 1] + ldz * m[2, 1] + m[3, 1]
            lpz = ldx * m[0, 2] + ldy * m[1, 2] + ldz * m[2, 2] + m[3, 2]
            lvx, lvy, lvz = lpx - onx, lpy - ony, lpz - onz
        else:
            # the directional light (rotation part only)
            lvx = (ldx * m[0, 0] + ldy * m[1, 0] + ldz * m[2, 0]).expand(
                gshape)
            lvy = (ldx * m[0, 1] + ldy * m[1, 1] + ldz * m[2, 1]).expand(
                gshape)
            lvz = (ldx * m[0, 2] + ldy * m[1, 2] + ldz * m[2, 2]).expand(
                gshape)
        linv = torch.rsqrt(torch.clamp(lvx * lvx + lvy * lvy + lvz * lvz,
                                       min=1e-20))
        lvx, lvy, lvz = lvx * linv, lvy * linv, lvz * linv
        cx, cy, cz, hit = raymarch.compute_ray_origin_soa(onx, ony, onz, lvx,
                                                          lvy, lvz)
        active = has_density & hit & (shadow >= ZERO_THRESHOLD)
        shadow = cast_light_ray(volumes, tex_j, (cx, cy, cz),
                                (lvx, lvy, lvz), shadow, step_scale,
                                max_light_samples, active)

        if has_light_probe:
            avx = awx * m[0, 0] + awy * m[1, 0] + awz * m[2, 0]
            avy = awx * m[0, 1] + awy * m[1, 1] + awz * m[2, 1]
            avz = awx * m[0, 2] + awy * m[1, 2] + awz * m[2, 2]
            ainv = torch.rsqrt(torch.clamp(
                avx * avx + avy * avy + avz * avz, min=1e-20))
            avx, avy, avz = avx * ainv, avy * ainv, avz * ainv
            c2x, c2y, c2z, hit2 = raymarch.compute_ray_origin_soa(
                onx, ony, onz, avx, avy, avz)
            active2 = has_density & hit2
            transm = cast_light_ray(
                volumes, tex_j, (c2x, c2y, c2z), (avx, avy, avz),
                torch.ones(gshape, dtype=torch.float32, device=dev),
                step_scale, max_light_samples, active2)
            transm = torch.where(active2, transm, 1.0)
            factor = torch.where(
                vid[0] == j, transm,
                torch.pow(torch.clamp(transm + 0.5, 0.0, 1.0), 0.25))
            ao = ao * torch.where(has_density, factor, 1.0)

    lcol = light_color[:3] * light_color[3]
    amb = ambient[:3] * ambient[3]
    if has_light_probe:
        # empty voxels never compute irradiance in the reference
        # (`CSRayMarchL.hlsl:58-75`): their ambient term is zero
        amb_rgb = [torch.where(has_density, ao * irr, 0.0)
                   for irr in (irr_r, irr_g, irr_b)]
    else:
        amb_rgb = [amb[c].expand(gshape) for c in range(3)]
    return vid, torch.stack([shadow * lcol[c] + amb_rgb[c]
                             for c in range(3)])
