"""Per-frame geometry for the screen-tile OIT composite (kernel B2).

Counterpart of `multivolumes_tpu/render/tilecast.py` (`tile_dims`,
`_tile_prep`, `composite_oit_tile`, `composite_oit_tile_sharded`): the
per-volume homographies packed by each face's Catmull-Smith orientation
(the LOD sweep's flags as given), the per-tile volume lists and the
padded scene depth, handed to `ops/composite.py`. With a scene depth map
(the opaque mesh) the cube depth planes ride along as `depth_sel`, and
the composite weights its taps by depth (kernel B2's depth variant).
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.ops.composite import tile_composite
from multivolumes_tpu_torch.render import warp as warp_lib
from multivolumes_tpu_torch.render.composite import unproject_z
from multivolumes_tpu_torch.render.cull import CullResult
from multivolumes_tpu_torch.render.perframe import PerObject
from multivolumes_tpu_torch.render.raymarch import CubeMaps
from multivolumes_tpu_torch.utils import timing


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def tile_dims(width: int, height: int):
    """Tile shape + padded screen dims -> (th, tw, hp, wp): 64 x 128
    tiles (rows cut to a multiple of 8 for screens at most 64 high)."""
    tw = 128
    th = 64 if height > 64 else _ceil_to(max(height, 8), 8)
    return th, tw, _ceil_to(height, th), _ceil_to(width, tw)


def _tile_prep(cube_maps: CubeMaps, per_object: PerObject, cull: CullResult,
               eye, screen_to_world, width: int, height: int,
               num_layers: int = 8, order=None, swap_sorted=None,
               depth_map=None, rows_mult: int = 1):
    """Kernel operands of one frame -> (color, depth_sel, scene, tlist,
    counts, vol_flt, face_flt, s, th, tw, tiles_x, k_layers).

    `depth_map` (H, W): the scene clip depth (the mesh); the padded scene
    plane is 1 without it. `depth_sel` (N, 6, S, S) is the cube depth in
    view distance, swapped like the faces, when both a scene depth and
    cube depth maps exist; else None. `rows_mult` pads the tile rows to
    that multiple, so a mesh's row axis cuts even bands of tile rows.

    `order` (N,): the cube-map rows are in this sorted volume order (the
    LOD sweep's output); every per-volume tensor is permuted to match.
    `swap_sorted` (N, 6) bool: the LOD sweep's flags, by which its faces
    arrive pre-swapped; the face rows are packed by them as given. It
    requires `order` (the flags are in sorted space). Without it the prep
    picks the flags from its face rows and swaps the maps itself."""
    if swap_sorted is not None and order is None:
        raise ValueError("swap_sorted holds sorted-space flags: pass the "
                         "sweep's order with it")
    if order is not None:
        per_object = per_object.take(order)
        cull = cull.take(order)
    color = cube_maps.color
    if color.shape[2] != 4:
        raise ValueError("tile composite needs unpacked (4-channel) maps")
    n = per_object.world.shape[0]
    s = color.shape[-1]
    dev = color.device
    k_layers = min(num_layers, n)

    a_mat = warp_lib.screen_basis(screen_to_world, eye)
    eye_local = math3d.transform_point3(eye, per_object.world_i)
    b_mat = warp_lib.local_basis(a_mat, per_object.world_i)
    # floor at 1: an n_eff of 0 would leave no texel to sample
    n_eff = torch.clamp(s >> torch.clamp(cull.mip_level, 0, 31),
                        min=1).float()

    p_u, p_v, den = warp_lib.face_rows(b_mat, eye_local, n_eff)
    # the sweep's flags come with its faces and cube depth (in view
    # distance) already swapped by them
    swap_nf, color_sel = swap_sorted, color
    depth_sel = None if depth_map is None else cube_maps.depth
    if swap_nf is None:
        swap_nf = warp_lib.pick_swap_flags(p_u, p_v, den,
                                           per_object.world_view_proj)
        # contiguous for kernel B2: a `where` over a transposed view may
        # keep the view's strides
        color_sel = torch.where(swap_nf[:, :, None, None, None],
                                color.transpose(-1, -2), color).contiguous()
        if depth_sel is not None:
            dep = unproject_z(depth_sel.float())
            depth_sel = torch.where(swap_nf[:, :, None, None],
                                    dep.transpose(-1, -2), dep).contiguous()

    swap = swap_nf[..., None]
    face_flt = torch.cat([torch.where(swap, p_v, p_u),
                          torch.where(swap, p_u, p_v), den],
                         dim=-1)                          # (N, 6, 9)

    wvp = per_object.world_view_proj
    vol_flt = torch.cat([b_mat.reshape(n, 9), eye_local, wvp[:, :, 2],
                         wvp[:, :, 3], n_eff[:, None]], dim=1)  # (N, 21)

    # per-tile volume lists (projected-bbox culled, capacity N)
    th, tw, hp, wp = tile_dims(width, height)
    hp = _ceil_to(hp, th * rows_mult)
    tiles_x, tiles_y = wp // tw, hp // th
    corners = timing.host_read("composite.corners", lambda: torch.tensor(
        [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
         for z in (-1.0, 1.0)], dtype=torch.float32, device=dev))
    ch_ = math3d.transform_point(corners[None], wvp[:, None])  # (N, 8, 4)
    cok = ch_[..., 3] > 1e-3
    chw = torch.clamp(ch_[..., 3], min=1e-3)
    px = (ch_[..., 0] / chw * 0.5 + 0.5) * width
    py = (-ch_[..., 1] / chw * 0.5 + 0.5) * height
    big = 1e9
    # a behind-camera corner projects garbage: full-screen bbox
    all_ok = cok.all(-1)
    vx_lo = torch.where(all_ok, px.amin(-1), -big)
    vx_hi = torch.where(all_ok, px.amax(-1), big)
    vy_lo = torch.where(all_ok, py.amin(-1), -big)
    vy_hi = torch.where(all_ok, py.amax(-1), big)

    t_idx = torch.arange(tiles_x * tiles_y, device=dev)
    tx0 = (t_idx % tiles_x * tw).float()
    ty0 = (t_idx // tiles_x * th).float()
    overlap = ((vx_lo[None] < tx0[:, None] + tw)
               & (vx_hi[None] > tx0[:, None])
               & (vy_lo[None] < ty0[:, None] + th)
               & (vy_hi[None] > ty0[:, None])
               & cull.visible[None])                      # (T, N)
    vids = torch.arange(n, device=dev)
    key = torch.where(overlap, vids[None], n + 1)
    tlist = torch.clamp(torch.sort(key, dim=1).values, max=n - 1).int()
    counts = overlap.sum(1).int()

    # pad with 0: exit_z <= 0 never passes, so pad pixels stay empty
    scene = torch.zeros((hp, wp), dtype=torch.float32, device=dev)
    scene[:height, :width] = 1.0 if depth_map is None else depth_map
    return (color_sel, depth_sel, scene, tlist, counts, vol_flt, face_flt,
            s, th, tw, tiles_x, k_layers)


def composite_oit_tile(cube_maps: CubeMaps, per_object: PerObject,
                       cull: CullResult, eye, screen_to_world, width: int,
                       height: int, num_layers: int, order=None,
                       swap_sorted=None, depth_map=None,
                       impl: str | None = None):
    """Full OIT composite through kernel B2 (its depth variant when the
    frame has a scene depth) -> (r, g, b, a) fields."""
    with timing.span("composite.prep"):
        (color_sel, depth_sel, scene, tlist, counts, vol_flt, face_flt, _s,
         th, tw, tiles_x, k_layers) = _tile_prep(
            cube_maps, per_object, cull, eye, screen_to_world, width, height,
            num_layers=num_layers, order=order, swap_sorted=swap_sorted,
            depth_map=depth_map)
    with timing.span("composite.kernel"):
        out = tile_composite(color_sel, scene, tlist, counts, vol_flt,
                             face_flt, th, tw, tiles_x, k_layers, width,
                             height, depth_sel=depth_sel, impl=impl)
    out = out[:, :height, :width]
    return out[0], out[1], out[2], out[3]


def composite_oit_tile_sharded(mesh, cube_maps, per_object, cull, eye,
                               screen_to_world, width: int, height: int,
                               num_layers: int, order=None, swap_sorted=None,
                               depth_map=None, impl: str | None = None):
    """Row-sharded OIT composite: one launch of kernel B2 per index of the
    mesh's "rows" axis, on that index's device, each on a contiguous band
    of tile rows -> (r, g, b, a) fields on `mesh.root`. Every tensor
    argument is a replicated dict {device: value} (the cube maps after
    their all-gather); the per-tile prep runs replicated, once per
    physical device, so the only sharded operands are the band's tile
    lists, scene depth and output."""
    from multivolumes_tpu_torch.parallel import collectives

    rows = mesh.rows
    preps = {}
    bands = []
    for r in range(rows):
        dev = mesh.device(r, 0)
        if dev not in preps:
            preps[dev] = _tile_prep(
                cube_maps[dev], per_object[dev], cull[dev], eye[dev],
                screen_to_world[dev], width, height, num_layers=num_layers,
                order=None if order is None else order[dev],
                swap_sorted=None if swap_sorted is None else swap_sorted[dev],
                depth_map=None if depth_map is None else depth_map[dev],
                rows_mult=rows)
        (color_sel, depth_sel, scene, tlist, counts, vol_flt, face_flt, _s,
         th, tw, tiles_x, k_layers) = preps[dev]
        ty_local = (scene.shape[0] // th) // rows
        t0, t1 = r * ty_local * tiles_x, (r + 1) * ty_local * tiles_x
        bands.append(tile_composite(
            color_sel, scene[r * ty_local * th:(r + 1) * ty_local * th],
            tlist[t0:t1], counts[t0:t1], vol_flt, face_flt, th, tw, tiles_x,
            k_layers, width, height, depth_sel=depth_sel, impl=impl,
            tile_row0=r * ty_local))
    out = collectives.all_gather(bands, 1, mesh, "composite_rows",
                                 devices=(mesh.root,))[mesh.root]
    out = out[:, :height, :width]
    return out[0], out[1], out[2], out[3]
