"""Screen-space compositing: cube-map sampling, the paper's depth-aware
filter, the per-pixel march fallback and order-independent transparency.

Counterpart of `multivolumes_tpu/render/composite.py`: per pixel, the
camera ray meets every volume's unit box analytically; the
`NUM_OIT_LAYERS` nearest exit points are kept by a streaming insertion
over the volumes (the reference's k-buffer depth peel,
`PSDepthPeel.hlsl`); each layer is shaded with `CubeCast` (the
depth-aware seam-free bilinear filter, `PSCube.hlsli:51-108`) or, for
volumes the adaptive scheme sends to the per-pixel path, the `RayCast`
march (`RayCast.hlsli:43-108`); the layers are under-blended front to
back (`PSResolveOIT.hlsl`). This is the gather composite
(`composite_mode="gather"`, and the reference march's composite); the
screen-tile kernel of `tilecast.py` is the main path's. The sky and the
tile composite share `unproject_z`, `dir_to_face_uv_soa` and
`screen_rays`.

Cube maps may arrive f16-pair packed (`pack_cube_f16`): two channels in
the bits of each f32, half the gathers a tap.
"""

from __future__ import annotations

import math

import torch

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.ops.trilinear import indexed_trilinear_soa
from multivolumes_tpu_torch.render import raymarch

FLT_MAX = raymarch.FLT_MAX


# --- f16-pair packing --------------------------------------------------------

def pack_cube_f16(cube_color):
    """(N, 6, 4, S, S) -> (N, 6, 2, S, S) f32 whose bits hold (r, g) and
    (b, a) as f16 pairs, the first in the low half. Bit for bit the JAX
    function; the bits are formed in int64 (no uint32 shifts)."""
    def half_bits(x):
        return x.to(torch.float16).view(torch.int16).long() & 0xFFFF

    def pack(a, b):
        u = half_bits(a) | (half_bits(b) << 16)
        u = torch.where(u >= (1 << 31), u - (1 << 32), u)
        return u.to(torch.int32).view(torch.float32)

    rg = pack(cube_color[:, :, 0], cube_color[:, :, 1])
    ba = pack(cube_color[:, :, 2], cube_color[:, :, 3])
    return torch.stack([rg, ba], dim=2)


def _unpack_f16(v):
    """Packed f32 (or its int32 bits) -> (lo, hi) f32 channel values."""
    u = v.view(torch.int32) if v.dtype == torch.float32 else v
    lo = ((u & 0xFFFF) ^ 0x8000) - 0x8000     # the low half, sign-extended
    hi = u >> 16                               # arithmetic shift
    return (lo.to(torch.int16).view(torch.float16).float(),
            hi.to(torch.int16).view(torch.float16).float())


def unpack_cube_f16(packed, dtype=torch.float32):
    """Inverse of `pack_cube_f16`: (N, 6, 2, S, S) -> (N, 6, 4, S, S)."""
    r, g = _unpack_f16(packed[:, :, 0])
    b, a = _unpack_f16(packed[:, :, 1])
    return torch.stack([r, g, b, a], dim=2).to(dtype)


def unproject_z(depth):
    """Clip depth -> view-space z (`UnprojectZ`, `PSCube.hlsli:21-26`)."""
    zn, zf = SharedConsts.Z_NEAR, SharedConsts.Z_FAR
    return (zn * zf) / (depth * (zn - zf) + zf)


def dir_to_face_uv_soa(x, y, z):
    """Direction components -> (face id, u, v) in [0,1]; face order
    +X,-X,+Y,-Y,+Z,-Z, u right / v down (inverse of `GetLocalPos`)."""
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3),
                    torch.where(z >= 0, 4, 5)))
    major = torch.where(is_x, ax, torch.where(is_y, ay, az))
    inv = 1.0 / torch.clamp(major, min=1e-20)
    xs, ys, zs = x * inv, y * inv, z * inv
    px = torch.where(is_x, torch.where(x >= 0, -zs, zs),
                     torch.where(is_y, xs, torch.where(z >= 0, xs, -xs)))
    py = torch.where(is_y, torch.where(y >= 0, -zs, zs), ys)
    return face, px * 0.5 + 0.5, -py * 0.5 + 0.5


def screen_rays(width: int, height: int, screen_to_world, eye):
    """Per-pixel world rays -> ((xg, yg) NDC, (dx, dy, dz) unit dirs),
    each (H, W)."""
    dev = screen_to_world.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) \
        / width * 2.0 - 1.0
    ys = -((torch.arange(height, dtype=torch.float32, device=dev) + 0.5)
           / height * 2.0 - 1.0)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    m = screen_to_world
    hx = xg * m[0, 0] + yg * m[1, 0] + 0.5 * m[2, 0] + m[3, 0]
    hy = xg * m[0, 1] + yg * m[1, 1] + 0.5 * m[2, 1] + m[3, 1]
    hz = xg * m[0, 2] + yg * m[1, 2] + 0.5 * m[2, 2] + m[3, 2]
    hw = xg * m[0, 3] + yg * m[1, 3] + 0.5 * m[2, 3] + m[3, 3]
    hw = torch.where(hw.abs() > 1e-20, hw, 1e-20)
    fx, fy, fz = hx / hw - eye[0], hy / hw - eye[1], hz / hw - eye[2]
    inv = torch.rsqrt(torch.clamp(fx * fx + fy * fy + fz * fz, min=1e-20))
    return (xg, yg), (fx * inv, fy * inv, fz * inv)


# --- cube-map addressing -----------------------------------------------------

def _face_axis_coords(u, n_eff, size: int):
    """Linear-sampler axis coordinates against a per-sample effective
    (mip) extent n_eff (int tensor) -> (i0, i1, frac)."""
    x = u * n_eff - 0.5
    x0 = torch.floor(x)
    f = (x - x0).float()
    base = x0.long()
    hi = torch.clamp(n_eff.long() - 1, max=size - 1)
    i0 = torch.minimum(torch.clamp(base, min=0), hi)
    i1 = torch.minimum(torch.clamp(base + 1, min=0), hi)
    return i0, i1, f


def sample_cube_soa(cube_color, vol_id, x, y, z, n_eff):
    """Bilinear cube sample by direction -> a tuple of C channels.
    cube_color (N, 6, C, S, S); vol_id, n_eff, x, y, z (...,)."""
    size = cube_color.shape[-1]
    face, u, v = dir_to_face_uv_soa(x, y, z)
    x0, x1, fx = _face_axis_coords(u, n_eff, size)
    y0, y1, fy = _face_axis_coords(v, n_eff, size)
    vol_id = vol_id.long()
    outs = []
    for ci in range(cube_color.shape[2]):
        ch = cube_color[:, :, ci]

        def tap(yi, xi):
            return ch[vol_id, face, yi, xi]

        c0 = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
        c1 = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
        outs.append(c0 * (1 - fy) + c1 * fy)
    return tuple(outs)


def sample_cube(cube_color, vol_id, d, n_eff):
    """AoS wrapper: d (..., 3) -> (..., C)."""
    return torch.stack(sample_cube_soa(cube_color, vol_id, d[..., 0],
                                       d[..., 1], d[..., 2], n_eff), -1)


def cube_cast_soa(cube_color, cube_depth, vol_id, n_eff, px, py, pz, dx, dy,
                  dz, scene_depth, has_depth: bool = True):
    """The depth-aware seam-free cube-map filter (`CubeCast`,
    `PSCube.hlsli:51-108`) -> (r, g, b, a). cube_color (N, 6, 4, S, S), or
    (N, 6, 2, S, S) f16-pair packed; the ray fields are (...,). The plain
    bilinear fallback (`PSCube.hlsli:105`) reuses the same 16 colour taps;
    without a scene depth (has_depth=False) every depth weight is 1 and
    the depth taps are skipped."""
    size = cube_color.shape[-1]
    face, u, v = dir_to_face_uv_soa(px, py, pz)
    x0, x1, fx = _face_axis_coords(u, n_eff, size)
    y0, y1, fy = _face_axis_coords(v, n_eff, size)
    # Gather order (x, y, z, w) = (x0, y1), (x1, y1), (x1, y0), (x0, y0)
    taps = ((x0, y1), (x1, y1), (x1, y0), (x0, y0))

    # GetDomain (`PSCube.hlsli:31-46`): the bilinear domain, clamped at
    # the exterior edges
    neff_f = n_eff.float()
    up = u * neff_f
    vp = v * neff_f
    du = torch.remainder(up + 0.5, 1.0)
    dv = torch.remainder(vp + 0.5, 1.0)
    bound = neff_f - 1.0
    clamp_needed = (
        (((px * neff_f).abs() > bound) & (px * neff_f * dx < 0.0))
        | (((py * neff_f).abs() > bound) & (py * neff_f * dy < 0.0))
        | (((pz * neff_f).abs() > bound) & (pz * neff_f * dz < 0.0)))
    du = torch.where(clamp_needed, torch.where(
        torch.minimum(up, neff_f - 0.5) < 0.5, 1.0, 0.0), du)
    dv = torch.where(clamp_needed, torch.where(
        torch.minimum(vp, neff_f - 0.5) < 0.5, 1.0, 0.0), dv)

    wb = ((1 - du) * dv, du * dv, du * (1 - dv), (1 - du) * (1 - dv))
    wf = ((1 - fx) * fy, fx * fy, fx * (1 - fy), (1 - fx) * (1 - fy))

    vol_id = vol_id.long()
    packed = cube_color.shape[2] == 2
    samples = []
    for (xi, yi) in taps:
        if packed:
            r_, g_ = _unpack_f16(cube_color[:, :, 0][vol_id, face, yi, xi])
            b_, a_ = _unpack_f16(cube_color[:, :, 1][vol_id, face, yi, xi])
            samples.append([r_, g_, b_, a_])
        else:
            samples.append([cube_color[:, :, ci][vol_id, face, yi, xi]
                            for ci in range(4)])

    if has_depth:
        depth_v = unproject_z(scene_depth)
        w_taps = [torch.clamp(1.0 - 0.5 * (depth_v - unproject_z(
            cube_depth[vol_id, face, yi, xi])).abs(), min=0.0) * wbi
            for (xi, yi), wbi in zip(taps, wb)]
    else:
        w_taps = list(wb)

    acc = [torch.zeros_like(u) for _ in range(4)]
    fb = [torch.zeros_like(u) for _ in range(4)]
    ws = torch.zeros_like(u)
    for smp, w, wfi in zip(samples, w_taps, wf):
        for ci in range(4):
            acc[ci] = acc[ci] + smp[ci] * w
            fb[ci] = fb[ci] + smp[ci] * wfi
        ws = ws + w
    inv = 1.0 / torch.clamp(ws, min=1e-20)
    ok = ws > 0.0
    return tuple(torch.where(ok, acc[ci] * inv, fb[ci]) for ci in range(4))


# --- the OIT composite -------------------------------------------------------

def _ray_box_exit_soa(ox, oy, oz, dx, dy, dz):
    """Ray against the unit box -> (hit, t of the exit)."""
    def slab(o, d):
        ds = torch.where(d.abs() > 1e-12, d,
                         torch.where(d >= 0, 1e-12, -1e-12))
        t1 = (-1.0 - o) / ds
        t2 = (1.0 - o) / ds
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    ix, ox_ = slab(ox, dx)
    iy, oy_ = slab(oy, dy)
    iz, oz_ = slab(oz, dz)
    t_near = torch.maximum(torch.maximum(ix, iy), iz)
    t_far = torch.minimum(torch.minimum(ox_, oy_), oz_)
    return t_far > torch.clamp(t_near, min=0.0), t_far


def ray_box_exit(origin_local, dir_local):
    """AoS wrapper: (..., 3) -> (hit, t_exit)."""
    return _ray_box_exit_soa(
        origin_local[..., 0], origin_local[..., 1], origin_local[..., 2],
        dir_local[..., 0], dir_local[..., 1], dir_local[..., 2])


def _select_layers(key, num_layers: int):
    """Iterative min-selection over the leading N axis: key (N, H, W) ->
    (layer keys (K, H, W), layer ids (K, H, W)); ties take the first
    volume, as `jnp.argmin` does."""
    n = key.shape[0]
    ids = torch.arange(n, device=key.device)[:, None, None]
    keys, idxs = [], []
    cur = key
    for _ in range(num_layers):
        kmin, imin = cur.min(0).values, cur.argmin(0)
        keys.append(kmin)
        idxs.append(imin)
        cur = torch.where(ids == imin[None], FLT_MAX, cur)
    return torch.stack(keys), torch.stack(idxs)


def composite_oit(
    cube_maps,                      # color (N,6,4|2,S,S), depth (N,6,S,S)
    volumes,                        # (N_src, D, H, W, 4)
    vol_tex_ids,                    # (N,)
    light_maps,                     # (N, L, L, L, 3) channel-last
    per_object,
    cull,
    eye,
    screen_to_world,
    depth_map,                      # (H, W) scene clip depth, or None
    width: int,
    height: int,
    max_steps: int,
    num_layers: int = SharedConsts.NUM_OIT_LAYERS,
    adaptive: bool = True,
    use_raycast: bool = True,
    has_depth: bool = True,
):
    """The OIT composite -> premultiplied (r, g, b, a) screen fields, alpha
    capped at 0.9997 (`PSResolveOIT.hlsl:23`). With `use_raycast`, the
    layers of volumes off the cube-map path are marched per pixel
    (`light_maps` channel-last, as `raymarch.ray_march_view` takes them)."""
    n = per_object.world.shape[0]
    s = cube_maps.color.shape[-1]
    dev = per_object.world.device
    num_layers = min(num_layers, n)
    (xg, yg), (dwx, dwy, dwz) = screen_rays(width, height, screen_to_world,
                                            eye)
    eye_local = math3d.transform_point3(eye, per_object.world_i)  # (N, 3)
    wi = per_object.world_i
    scene_z = depth_map if depth_map is not None else torch.ones(
        (height, width), dtype=torch.float32, device=dev)

    # streaming nearest-K insertion over the volumes (the k-buffer peel)
    z_top = torch.full((num_layers, height, width), FLT_MAX,
                       dtype=torch.float32, device=dev)
    id_top = torch.zeros((num_layers, height, width), dtype=torch.long,
                         device=dev)
    for vid in range(n):
        m = wi[vid]
        dlx = dwx * m[0, 0] + dwy * m[1, 0] + dwz * m[2, 0]
        dly = dwx * m[0, 1] + dwy * m[1, 1] + dwz * m[2, 1]
        dlz = dwx * m[0, 2] + dwy * m[1, 2] + dwz * m[2, 2]
        ox, oy, oz = (eye_local[vid, c].expand_as(dlx) for c in range(3))
        hit, t_exit = _ray_box_exit_soa(ox, oy, oz, dlx, dly, dlz)
        qx, qy, qz = ox + dlx * t_exit, oy + dly * t_exit, oz + dlz * t_exit
        _hx, _hy, hz, hw = raymarch._transform_point_soa(
            qx, qy, qz, per_object.world_view_proj[vid])
        exit_z = hz / torch.clamp(hw, min=1e-20)
        valid = (hit & (hw > 0.0) & cull.visible[vid] & (exit_z <= scene_z)
                 & (exit_z > 0.0))
        z_new = torch.where(valid, exit_z, FLT_MAX)
        id_new = torch.full_like(id_top[0], vid)
        for k in range(num_layers):
            take = z_new < z_top[k]
            z_k, id_k = z_top[k].clone(), id_top[k].clone()
            z_top[k] = torch.where(take, z_new, z_k)
            id_top[k] = torch.where(take, id_new, id_k)
            z_new = torch.where(take, z_k, z_new)
            id_new = torch.where(take, id_k, id_new)
    layer_vol = id_top
    layer_valid = z_top < FLT_MAX * 0.5

    # per-layer ray fields from the selected volume ids
    def wsel(r, c):
        return wi[:, r, c][layer_vol]

    l_dx = dwx * wsel(0, 0) + dwy * wsel(1, 0) + dwz * wsel(2, 0)
    l_dy = dwx * wsel(0, 1) + dwy * wsel(1, 1) + dwz * wsel(2, 1)
    l_dz = dwx * wsel(0, 2) + dwy * wsel(1, 2) + dwz * wsel(2, 2)
    l_ox, l_oy, l_oz = (eye_local[:, c][layer_vol] for c in range(3))
    _hit_l, l_texit = _ray_box_exit_soa(l_ox, l_oy, l_oz, l_dx, l_dy, l_dz)
    l_qx = l_ox + l_dx * l_texit
    l_qy = l_oy + l_dy * l_texit
    l_qz = l_oz + l_dz * l_texit

    n_eff = s >> torch.clamp(cull.mip_level, max=31).long()     # (N,)
    l_neff = n_eff[layer_vol]
    l_use_cube = cull.use_cube_map[layer_vol]
    scene_b = scene_z[None].expand_as(z_top)
    cc = cube_cast_soa(cube_maps.color, cube_maps.depth, layer_vol, l_neff,
                       l_qx, l_qy, l_qz, l_dx, l_dy, l_dz, scene_b,
                       has_depth=has_depth)
    if not use_raycast:
        # every volume shades from its cube map (the reference's
        # non-adaptive mode, `CSVolumeCull.hlsl:69`)
        lr, lg, lb, la = cc
    else:
        # the per-pixel march over the layers off the cube-map path
        inv_dl = torch.rsqrt(torch.clamp(
            l_dx * l_dx + l_dy * l_dy + l_dz * l_dz, min=1e-20))
        ndx, ndy, ndz = l_dx * inv_dl, l_dy * inv_dl, l_dz * inv_dl
        ocx, ocy, ocz, oc_hit = raymarch.compute_ray_origin_soa(
            l_ox, l_oy, l_oz, ndx, ndy, ndz)
        t_max_l = raymarch.get_t_max_soa(
            xg[None].expand_as(ocx), yg[None].expand_as(ocx), scene_b,
            ocx, ocy, ocz, ndx, ndy, ndz,
            per_object.world_view_proj_i.reshape(-1, 16)[layer_vol])
        rc = _ray_cast_layers(
            volumes, vol_tex_ids[layer_vol], light_maps, layer_vol,
            (ocx, ocy, ocz), (ndx, ndy, ndz), t_max_l, oc_hit,
            cull.smp_count[layer_vol], max_steps,
            active=layer_valid & ~l_use_cube, adaptive=adaptive)
        lr, lg, lb, la = (torch.where(l_use_cube, c, r)
                          for c, r in zip(cc, rc))
    # `PSCube.hlsl:57`: store only if 0 < w <= 1
    store_ok = (la > 0.0) & (la <= 1.0) & layer_valid
    lr, lg, lb, la = (torch.where(store_ok, c, 0.0)
                      for c in (lr, lg, lb, la))
    return _underblend(lr, lg, lb, la, num_layers, height, width)


def _underblend(lr, lg, lb, la, num_layers, height, width):
    """Front-to-back under-blend over the leading layer axis
    (`PSResolveOIT.hlsl:17-24`)."""
    accr = torch.zeros((height, width), dtype=torch.float32,
                       device=la.device)
    accg, accb, acca = (torch.zeros_like(accr) for _ in range(3))
    for k in range(num_layers):
        t = 1.0 - acca
        accr = accr + lr[k] * t
        accg = accg + lg[k] * t
        accb = accb + lb[k] * t
        acca = acca + la[k] * t
    return accr, accg, accb, torch.clamp(acca, max=0.9997)


def _ray_cast_layers(volumes, l_tex, light_maps, layer_vol, origin,
                     dir_local, t_max, is_hit, smp_count, max_steps, active,
                     adaptive):
    """`RayCast` (`RayCast.hlsli:43-108`) over the (K, H, W) layer grid;
    origins box-clipped and t_max occlusion-bounded by the caller. The
    JAX function marches row bands one after another to bound a TPU
    dispatch; the march here keeps only the live rays, which bounds it
    the same way."""
    active = active & is_hit
    step_scale = raymarch.MAX_DIST / torch.clamp(smp_count.float(), min=1.0)
    tex_f, vol_f = l_tex.reshape(-1), layer_vol.reshape(-1)

    def sample_fn(u, v, w, rows):
        return indexed_trilinear_soa(volumes, tex_f[rows], u, v, w)

    def light_fn(u, v, w, rows):
        return indexed_trilinear_soa(light_maps, vol_f[rows], u, v, w)

    res = raymarch.march_scatter(sample_fn, light_fn, origin, dir_local,
                                 t_max, smp_count, step_scale, max_steps,
                                 active, adaptive)
    inv2pi = 1.0 / (2.0 * math.pi)
    return tuple(torch.where(active, c, 0.0) for c in (
        res.r * inv2pi, res.g * inv2pi, res.b * inv2pi, res.a))
