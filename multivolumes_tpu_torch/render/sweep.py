"""Plane-sweep view-space marching: the cube-map march.

Counterpart of `multivolumes_tpu/render/sweep.py` (`eye_to_face_frames`,
`face_ray_params`, `lod_partition`, `ray_march_view_sweep_lod` with its
three output contracts, `ray_march_view_sweep`, the un-bucketed march of
every volume at full resolution, and `ray_march_view_sweep_lod_sharded`
and `ray_march_view_sweep_sharded`, the two split over the volume axis
of a device mesh). The per-(volume, face) march itself is kernel B1
(`ops/sweep.py`), the prologue of each LOD bucket (its ray intervals,
depth bound and cube depth) kernel B7 (`ops/sweep_prep.py`, whose plain
version is `bucket_prologue_plain` here), the frame's partition (face
frames, LOD rank and mips, B1's operands in rank order, the
Catmull-Smith flags of the tile composite) kernel B12 and each bucket's
store (scale, run mask, rounding, the flags' pre-swap) kernel B13
(`ops/lod_partition.py`, whose plain versions are `partition_plain` and
`bucket_store_plain` here); this module lays out the buckets on the host
and holds the plain versions. With a scene depth map
(the opaque mesh), each ray also ends where the scene occludes it
(`_occlusion_s_max`, the reference's `GetTMax` in the sweep's ray
parameter, sampled per bucket at a quarter, half or full bucket
resolution), and the bucket's cube depth, unprojected to view distance
and swapped like the faces, goes to the composite's CubeCast weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.ops import lod_partition as lod_partition_ops
from multivolumes_tpu_torch.ops import sweep_prep
from multivolumes_tpu_torch.ops.sweep import (  # noqa: F401 (the JAX names)
    ABSORPTION, FACE_FLIPS, FACE_VARIANT, MAX_DIST, ZERO_THRESHOLD,
    sweep_march)
from multivolumes_tpu_torch.render.composite import (pack_cube_f16,
                                                      unproject_z)
from multivolumes_tpu_torch.render.cull import CullResult
from multivolumes_tpu_torch.render.perframe import PerObject
from multivolumes_tpu_torch.render.raymarch import (
    FLT_MAX, CubeMaps, _safe, _transform_point_soa, compute_ray_origin_soa,
    get_local_pos_soa, get_t_max_soa)
from multivolumes_tpu_torch.render.warp import catmull_swap_flags
from multivolumes_tpu_torch.utils import timing


def eye_to_face_frames(eye_local):
    """(..., 3) local eye -> (..., 6, 3) (eu, ev, ew) per face."""
    ex, ey, ez = eye_local[..., 0], eye_local[..., 1], eye_local[..., 2]
    return torch.stack(
        [
            torch.stack([-ez, ey, ex], -1),   # f0 +X
            torch.stack([ez, ey, -ex], -1),   # f1 -X
            torch.stack([ex, -ez, ey], -1),   # f2 +Y
            torch.stack([ex, ez, -ey], -1),   # f3 -Y
            torch.stack([ex, ey, ez], -1),    # f4 +Z
            torch.stack([-ex, ey, -ez], -1),  # f5 -Z
        ],
        dim=-2,
    )


class SweepParams(NamedTuple):
    s_in: torch.Tensor     # (..., S, S) per-ray entry parameter
    s_end: torch.Tensor    # (..., S, S) per-ray end (exit)
    ray_len: torch.Tensor  # (..., S, S) |g - eye|
    active: torch.Tensor   # (..., S, S) ray validity


def face_ray_params(eye_f, u, v, s_max=None):
    """Per-ray sweep parameters in the face frame. eye_f: (B, 3); u, v:
    (B, S) per-batch face coords in [-1, 1]; s_max: optional (B, S, S)
    occlusion bound in s."""
    eu, ev, ew = (eye_f[:, i, None, None] for i in range(3))
    gx = u[:, None, :] - eu
    gy = v[:, :, None] - ev
    gz = 1.0 - ew

    def slab(e, d):
        d_safe = torch.where(d.abs() > 1e-12, d,
                             torch.where(d >= 0, 1e-12, -1e-12))
        s1 = (-1.0 - e) / d_safe
        s2 = (1.0 - e) / d_safe
        return torch.minimum(s1, s2), torch.maximum(s1, s2)

    ix, ox = slab(eu, gx)
    iy, oy = slab(ev, gy)
    iz, oz = slab(ew, gz)
    s_in = torch.maximum(torch.maximum(ix, iy), torch.clamp(iz, min=0.0))
    s_out = torch.minimum(torch.minimum(ox, oy), oz)
    ray_len = torch.sqrt(gx * gx + gy * gy + gz * gz)
    s_end = torch.clamp(s_out, max=1.0)
    if s_max is not None:
        s_end = torch.minimum(s_end, s_max)
    return SweepParams(s_in=s_in, s_end=s_end, ray_len=ray_len,
                       active=s_out > s_in)


def _roll_edge(x, d: int, dim: int):
    """Edge-clamped shift by d along dim: out[i] = x[clip(i + d)]."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(n, device=x.device) + d, 0, n - 1)
    return x.index_select(dim, idx)


def _dilate3_max(x):
    """3x3 max over the last two dims (separable, edge-clamped)."""
    for dim in (-2, -1):
        x = torch.maximum(torch.maximum(_roll_edge(x, 1, dim),
                                        _roll_edge(x, -1, dim)), x)
    return x


def _pool2_max(d):
    """2x2 stride-2 max-pool of a scene depth map (z = 1 far, so the
    derived bound s_max can only grow); odd sizes stay as they are."""
    hd, wd = d.shape
    if hd % 2 or wd % 2:
        return d
    return d.reshape(hd // 2, 2, wd // 2, 2).amax(dim=(1, 3))


def _upsample2_nearest(x, s: int):
    """(..., s/2, s/2) -> (..., s, s) nearest."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def _occlusion_s_max(per_object: PerObject, eye_local, depth_map, s: int,
                     n_eff):
    """Scene-depth occlusion per texel (the reference's GetClipPos +
    GetTMax, `CSRayMarch.hlsl:102-107`) in the sweep's ray parameter s,
    on each volume's n_eff texel grid (centres at (i + 0.5) / n_eff).
    Returns (s_max (N, 6, s, s), the sampled scene clip z)."""
    n = eye_local.shape[0]
    dev = eye_local.device
    ij = torch.arange(s, dtype=torch.float32, device=dev)
    jj, ii = torch.meshgrid(ij, ij, indexing="ij")
    denom = n_eff.float()[:, None, None, None]
    px = ((ii[None, None] + 0.5) / denom * 2.0 - 1.0).expand(n, 6, s, s)
    py = (-((jj[None, None] + 0.5) / denom * 2.0 - 1.0)).expand(n, 6, s, s)
    face = torch.arange(6, device=dev)[None, :, None, None]
    tx, ty, tz = get_local_pos_soa(px, py, face)

    ex, ey, ez = (eye_local[:, i, None, None, None] for i in range(3))
    dxu, dyu, dzu = tx - ex, ty - ey, tz - ez
    il = torch.rsqrt(torch.clamp(dxu * dxu + dyu * dyu + dzu * dzu,
                                 min=1e-20))
    dx, dy, dz = dxu * il, dyu * il, dzu * il
    ox, oy, oz, _hit = compute_ray_origin_soa(
        ex.expand_as(tx), ey.expand_as(tx), ez.expand_as(tx), dx, dy, dz)

    prx, pry, prz = ox + 0.01 * dx, oy + 0.01 * dy, oz + 0.01 * dz
    wvp = per_object.world_view_proj[:, None, None, None]
    hx, hy, _hz, hw = _transform_point_soa(prx, pry, prz, wvp)
    hw = _safe(hw, 1e-20)
    cx, cy = hx / hw, hy / hw
    uu = cx * 0.5 + 0.5
    vv = 1.0 - (cy * 0.5 + 0.5)
    hd, wd = depth_map.shape

    def tap(c, nn):
        # truncation toward zero as the JAX int32 cast, kept in range
        return torch.clamp(torch.clamp(c * nn, -1.0, float(nn)).long(),
                           0, nn - 1)

    z = depth_map[tap(vv, hd), tap(uu, wd)]
    t_max = get_t_max_soa(cx, cy, z, ox, oy, oz, dx, dy, dz,
                          per_object.world_view_proj_i[:, None, None, None])

    # s is measured from the eye (p = eye + s (g - eye)); the reference's
    # t from the box-clipped origin along the unit direction
    L = torch.sqrt(dxu * dxu + dyu * dyu + dzu * dzu)
    t0x, t0y, t0z = ox - ex, oy - ey, oz - ez
    t0 = torch.sqrt(t0x * t0x + t0y * t0y + t0z * t0z)
    s_max = (t0 + torch.clamp(t_max, max=FLT_MAX)) / torch.clamp(L,
                                                                 min=1e-12)
    s_max = torch.where(t_max >= FLT_MAX * 0.5, FLT_MAX, s_max)
    return s_max, z


def bucket_occlusion(per_object: PerObject, eye_local, occl_depth, ids,
                     size_b: int, n_eff_v):
    """A bucket's occlusion bound and cube depth at size_b, from the
    2x2-max-pooled scene depth `occl_depth`: quarter-resolution taps of a
    further 2x2-pooled depth for size_b >= 64, half resolution for
    size_b >= 32, else full. The coarse bound is 3x3 max-dilated before
    the nearest upsampling, so s_max only grows against the exact tap
    (the composite's per-pixel depth test clips the overshoot)."""
    po_b, eye_b = per_object.take(ids), eye_local[ids]
    if size_b >= 64:
        s_max_c, depth_c = _occlusion_s_max(
            po_b, eye_b, _pool2_max(occl_depth), size_b // 4, n_eff_v * 0.25)
        up = (lambda x: _upsample2_nearest(
            _upsample2_nearest(x, size_b // 2), size_b))
        return up(_dilate3_max(s_max_c)), up(depth_c)
    if size_b >= 32:
        s_max_c, depth_c = _occlusion_s_max(
            po_b, eye_b, occl_depth, size_b // 2, n_eff_v * 0.5)
        return (_upsample2_nearest(_dilate3_max(s_max_c), size_b),
                _upsample2_nearest(depth_c, size_b))
    return _occlusion_s_max(po_b, eye_b, occl_depth, size_b, n_eff_v)


def lod_order(cull: CullResult):
    """(N,) int64 LOD rank of the volumes. Sort key: mip ascending, ties
    by projected edge length descending, invisible volumes last; the sort
    is stable like `jnp.argsort`, so equal keys keep volume order."""
    edge = torch.clamp(cull.max_edge_px, 0.0, 65535.0).int()
    sort_key = torch.where(cull.visible,
                           cull.mip_level * (1 << 17) + (65536 - edge),
                           1 << 30)
    return torch.argsort(sort_key, stable=True)


def lod_buckets(n: int, cube_map_size: int, bucket_caps):
    """The static bucket layout of n ranked volumes: [(start, count,
    size_b, mip_b), ...], from the host's numbers alone."""
    s = cube_map_size
    buckets = []
    start = 0
    mip = 0
    for cap in bucket_caps:
        size_b = max(s >> mip, 8)
        count = min(cap, n - start)
        if count > 0:
            buckets.append((start, count, size_b, mip))
            start += count
        mip += 1
        if start >= n:
            break
    while start < n:  # leftover beyond the last cap: smallest bucket
        s0, c0, size_b, mip_b = buckets[-1]
        buckets[-1] = (s0, c0 + (n - start), size_b, mip_b)
        start = n
    return buckets


def lod_partition(cull: CullResult, n: int, cube_map_size: int,
                  bucket_caps):
    """Rank volumes for LOD bucketing -> (order, buckets): `lod_order`
    and `lod_buckets`."""
    return lod_order(cull), lod_buckets(n, cube_map_size, bucket_caps)


class SortedSweep(NamedTuple):
    """The LOD sweep's output: map rows in `order` (bucket-sorted, or the
    identity with sorted_output=False)."""
    cube_maps: CubeMaps     # rows in `order`; faces pre-swapped by `swap`
    mips: torch.Tensor      # (N,) int32 effective mip, ORIGINAL indexing
    order: torch.Tensor     # (N,) row j = volume order[j]
    swap: torch.Tensor      # (N, 6) bool Catmull-Smith flags, sorted rows;
                            # None without a swap basis


def bucket_mips(cull: CullResult, ids, mip_b: int, max_mip: int):
    """Effective mip of each bucket volume: its projected mip, one level
    deeper when the adaptive scheme routes it off the cube-map path,
    floored by the bucket's level."""
    actual = torch.clamp(cull.mip_level[ids], 0, max_mip)
    scheme_off = (~cull.use_cube_map[ids]).int()
    return torch.clamp(actual + scheme_off, mip_b, max_mip).int()


class Partition(NamedTuple):
    """The LOD sweep's per-frame partition (kernel B12,
    `ops/lod_partition.py`, or `partition_plain`). Rows j are the ranked
    volumes order[j]; each bucket takes its slice of the sorted rows."""
    order: torch.Tensor      # (N,) int64 row j = volume order[j]
    mips: torch.Tensor       # (N,) int32 effective mip, volume order
    n_eff: torch.Tensor      # (N,) f32 S >> mip, sorted rows
    eye_local: torch.Tensor  # (N, 3) the eye in each volume's frame
    eye_faces: torch.Tensor  # (N, 6, 3) its face frames, volume order
    ids: torch.Tensor        # (N,) int32 order: B1's light rows
    tex: torch.Tensor        # (N,) int32 source volumes, sorted rows
    faces: torch.Tensor      # (N, 6, 3) eye_faces, sorted rows
    smp: torch.Tensor        # (N,) int32 ray sample counts, sorted rows
    run: torch.Tensor        # (N, 6) bool faces to march, sorted rows
    swap: torch.Tensor       # (N, 6) bool Catmull-Smith flags, sorted
                             # rows; None without a swap basis


def partition_plain(cull: CullResult, per_object: PerObject, eye,
                    vol_tex_ids, cube_map_size: int, buckets,
                    swap_basis=None) -> Partition:
    """Plain version of kernel B12: the eye in each volume's frame, the
    LOD rank, each bucket's effective mips, B1's per-volume operands in
    rank order and, with a swap basis, the Catmull-Smith flags of the
    ranked rows (`warp.catmull_swap_flags`)."""
    n = vol_tex_ids.shape[0]
    s = cube_map_size
    eye_local = math3d.transform_point3(eye, per_object.world_i)
    eye_faces = eye_to_face_frames(eye_local)
    order = lod_order(cull)
    max_mip = max((s // 8).bit_length() - 1, 0)
    mips = torch.zeros((n,), dtype=torch.int32, device=eye.device)
    n_effs = []
    for (b0, count, _size_b, mip_b) in buckets:
        ids = order[b0:b0 + count]
        eff_mip = bucket_mips(cull, ids, mip_b, max_mip)
        mips[ids] = eff_mip
        n_effs.append((s >> eff_mip).float())
    n_eff = torch.cat(n_effs)
    swap = None
    if swap_basis is not None:
        # the frame's one pick of the flags, over every sorted row at
        # once: the tile prep takes them as given
        po_sorted = per_object.take(order)
        swap = catmull_swap_flags(
            swap_basis, po_sorted.world_i, po_sorted.world_view_proj,
            math3d.transform_point3(eye, po_sorted.world_i), n_eff)
    run = cull.face_mask[order] & cull.visible[order][:, None]
    return Partition(order, mips, n_eff, eye_local, eye_faces, order.int(),
                     vol_tex_ids[order].int(), eye_faces[order],
                     cull.smp_count[order], run, swap)


def bucket_store_plain(scatter, run, swap, color, rows, pack: bool = False):
    """Plain version of kernel B13: B1's (count, 6, 4, S_b, S_b) f32
    output of one bucket, RGB scaled by 1 / (2 pi), masked by `run`
    (count, 6), rounded to color's dtype (with `pack`, f16-pair packed:
    `composite.pack_cube_f16`), transposed where `swap` (count, 6) is set,
    stored into color[rows, :, :, :S_b, :S_b]. Scales `scatter` in
    place."""
    size_b = scatter.shape[-1]
    scatter[:, :, :3] *= 1.0 / (2.0 * math.pi)
    scatter = scatter * run[:, :, None, None, None]
    if pack:
        out_b = pack_cube_f16(scatter)
    else:
        out_b = scatter.to(color.dtype)
    if swap is not None:
        out_b = torch.where(swap[:, :, None, None, None],
                            out_b.transpose(-1, -2), out_b)
    color[rows, :, :, :size_b, :size_b] = out_b


def bucket_ray_params(eye_faces, ids, size_b: int, n_eff_v, s_max=None):
    """Kernel-B1 ray operands of one bucket (count, 6, S_b, S_b), rays
    beyond each volume's n_eff corner dead; `s_max` (count, 6, S_b, S_b)
    bounds the rays by the scene depth."""
    count = ids.shape[0]
    ar = torch.arange(size_b, dtype=torch.float32, device=ids.device)
    u = (ar[None] + 0.5) / n_eff_v[:, None] * 2.0 - 1.0     # (count, S_b)
    u6 = u.repeat_interleave(6, dim=0)
    params = face_ray_params(
        eye_faces[ids].reshape(count * 6, 3), u6, -u6,
        None if s_max is None else s_max.reshape(count * 6, size_b, size_b))
    in_corner = ((ar[None, None, :] < n_eff_v[:, None, None])
                 & (ar[None, :, None] < n_eff_v[:, None, None]))
    shape = (count, 6, size_b, size_b)
    return SweepParams(
        *(x.reshape(shape) for x in (params.s_in, params.s_end,
                                     params.ray_len)),
        params.active.reshape(shape) & in_corner[:, None])


def bucket_prologue_plain(per_object: PerObject, eye_local, eye_faces, ids,
                          size_b: int, n_eff_v, depth_map=None, swap=None,
                          cube_depth=None, rows=None) -> SweepParams:
    """Plain version of kernel B7 (`ops/sweep_prep.py:sweep_prologue`):
    one bucket's ray operands and, with the scene depth map, its depth
    bound and its cube depth written to `cube_depth[rows, :, :S_b, :S_b]`,
    unprojected to view distance and swapped by `swap` (count, 6) for the
    tile composite, else the sampled clip depth."""
    s_max = None
    if depth_map is not None:
        s_max, depth_b = bucket_occlusion(per_object, eye_local,
                                          _pool2_max(depth_map), ids, size_b,
                                          n_eff_v)
        if swap is not None:
            depth_b = unproject_z(depth_b.float())
            depth_b = torch.where(swap[:, :, None, None],
                                  depth_b.transpose(-1, -2), depth_b)
        cube_depth[rows, :, :size_b, :size_b] = depth_b
    return bucket_ray_params(eye_faces, ids, size_b, n_eff_v, s_max)


def ray_march_view_sweep_lod(
    volumes_sweep,      # (N_src, D, H, W, 4) sweep dtype
    vol_tex_ids,        # (N,)
    light_sweep,        # (N, L, L, L, 4) sweep dtype
    per_object: PerObject,
    cull: CullResult,   # use_cube_map = visible for the LOD march
    eye,
    cube_map_size: int,
    swap_basis,         # (3, 3) warp.screen_basis, or None
    bucket_caps=(8, 24, 1 << 30),
    vol_zmax=None,
    impl: str | None = None,
    depth_map=None,     # (H, W) scene clip depth (the mesh), or None
    sorted_output: bool = True,
    pack: bool = False,
) -> SortedSweep:
    """LOD-bucketed sweep (the reference's work-graph cube-map dispatch,
    `LibRayMarch.hlsl:39-134`, as fixed-capacity resolution buckets):
    volumes sorted by mip sweep at S, S/2, S/4 ... in bucket order; each
    map fills the top-left n_eff^2 corner of its (S, S) face.

    Three output contracts, as the JAX function's:
    * the tile composite's (`sorted_output`, a `swap_basis`): rows in
      bucket order, in the sweep dtype, each face pre-swapped; with
      `depth_map` the cube depth in view distance, swapped like the
      faces, Z_FAR outside each corner;
    * the warp composite's (`sorted_output=False`, no swap basis): rows
      in volume order, unswapped, in the sweep dtype; the cube depth is
      the sampled scene clip depth, 1 outside each corner;
    * the gather composite's: the same with `pack`, the colour f16-pair
      packed from the f32 march (`composite.pack_cube_f16`).
    With `depth_map`, rays stop at the scene depth."""
    if swap_basis is not None and (pack or not sorted_output):
        raise ValueError("swap_basis is the tile composite's contract: "
                         "sorted, unpacked")
    n = vol_tex_ids.shape[0]
    s = cube_map_size
    dev = volumes_sweep.device
    with timing.span("sweep.partition"):
        buckets = lod_buckets(n, s, bucket_caps)
        part = lod_partition_ops.partition(
            cull, per_object, eye, vol_tex_ids, s, buckets, swap_basis,
            impl=impl)

    if pack:
        color = torch.zeros((n, 6, 2, s, s), dtype=torch.float32,
                            device=dev)
    else:
        color = torch.zeros((n, 6, 4, s, s), dtype=volumes_sweep.dtype,
                            device=dev)
    cube_depth = None
    if depth_map is not None:
        cube_depth = torch.full((n, 6, s, s), SharedConsts.Z_FAR
                                if swap_basis is not None else 1.0,
                                dtype=torch.float32, device=dev)
    for (b0, count, size_b, _mip_b) in buckets:
        with timing.span("sweep.bucket"):
            sorted_rows = slice(b0, b0 + count)
            ids = part.order[sorted_rows]
            rows = sorted_rows if sorted_output else ids
            sw = None if part.swap is None else part.swap[sorted_rows]
            n_eff_v, run = part.n_eff[sorted_rows], part.run[sorted_rows]
            params = sweep_prep.sweep_prologue(
                per_object, part.eye_local, part.eye_faces, ids, n_eff_v,
                size_b, depth_map=depth_map, swap=sw, cube_depth=cube_depth,
                rows=rows, impl=impl)
            scatter = sweep_march(
                volumes_sweep, light_sweep, part.tex[sorted_rows],
                part.faces[sorted_rows], params, part.smp[sorted_rows], run,
                size_b, size_b, n_eff_b=n_eff_v,
                light_ids=part.ids[sorted_rows], vol_zmax=vol_zmax,
                impl=impl)                          # (count, 6, 4, Sb, Sb)
            if pack:
                bucket_store_plain(scatter, run, sw, color, rows, pack=True)
            else:
                lod_partition_ops.bucket_store(scatter, run, sw, color,
                                               rows, impl=impl)
    order = part.order if sorted_output else torch.arange(n, device=dev)
    return SortedSweep(CubeMaps(color=color, depth=cube_depth), part.mips,
                       order, part.swap)


def ray_march_view_sweep(
    volumes_sweep,      # (N_src, D, H, W, 4) sweep dtype
    vol_tex_ids,        # (N,)
    light_sweep,        # (N, L, L, L, 4) sweep dtype
    per_object: PerObject,
    cull: CullResult,
    eye,
    depth_map,          # (H, W) scene clip depth, or None
    cube_map_size: int,
    num_planes: int | None = None,
    vol_zmax=None,
    impl: str | None = None,
) -> CubeMaps:
    """The un-bucketed sweep (`lod_bucket_caps=None` or
    `adaptive_raymarch=False`): every (volume, face) cube map at the full
    resolution S in one launch of kernel B1, `num_planes` planes
    (None -> S). The output contract of `raymarch.ray_march_view` at mip
    0: rows in volume order, the f32 march, and the sampled scene clip
    depth (ones without a depth map)."""
    n = vol_tex_ids.shape[0]
    s = cube_map_size
    dev = volumes_sweep.device
    eye_local = math3d.transform_point3(eye, per_object.world_i)
    eye_faces = eye_to_face_frames(eye_local)
    u = ((torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
         * 2.0 - 1.0).expand(n * 6, s)
    s_max = None
    if depth_map is not None:
        s_max, cube_depth = _occlusion_s_max(
            per_object, eye_local, depth_map, s,
            torch.full((n,), float(s), device=dev))
        s_max = s_max.reshape(n * 6, s, s)
    else:
        cube_depth = torch.ones((n, 6, s, s), dtype=torch.float32,
                                device=dev)
    params = face_ray_params(eye_faces.reshape(n * 6, 3), u, -u, s_max)
    params = SweepParams(*(x.reshape(n, 6, s, s) for x in params))
    run = cull.face_mask & cull.visible[:, None] & cull.use_cube_map[:, None]
    scatter = sweep_march(volumes_sweep, light_sweep, vol_tex_ids, eye_faces,
                          params, cull.smp_count, run, num_planes or s, s,
                          vol_zmax=vol_zmax, impl=impl)
    scatter[:, :, :3] *= 1.0 / (2.0 * math.pi)
    return CubeMaps(color=scatter * run[:, :, None, None, None],
                    depth=cube_depth)


def ray_march_view_sweep_lod_sharded(
    mesh,               # parallel.collectives.DeviceMesh
    volumes_sweep,      # replicated {device: (N_src, D, H, W, 4)}
    vol_tex_ids,        # volume-sharded: [d] -> (N / D,) on mesh.device(0, d)
    light_sweep,        # replicated {device: (N, L, L, L, 4)}, or with
                        # light_sharded the shards [d] -> (N / D, L, L, L, 4)
    per_object,         # replicated {device: PerObject}, all N rows
    cull,               # replicated {device: CullResult}, all N rows
    eye,                # replicated {device: (3,)}
    cube_map_size: int,
    swap_basis,         # replicated {device: (3, 3)}, or None
    bucket_caps=(8, 24, 1 << 30),
    vol_zmax=None,      # replicated, or None
    impl: str | None = None,
    light_sharded: bool = False,
    depth_map=None,     # replicated {device: (H, W)} scene clip depth, or
                        # None
    sorted_output: bool = True,
    pack: bool = False,
) -> dict:
    """The LOD sweep partitioned over the mesh's volume axis: shard d
    LOD-buckets and marches its own N / D volumes on `mesh.device(0, d)`
    (kernel B1 launches there) with the bucket caps divided by D, the
    per-device reading of the capacity limits; the shards' cube maps,
    mips, orders and swap flags are then all-gathered, in shard order,
    onto every physical device -> replicated {device: SortedSweep}. Local
    sorted row j of shard d is global volume d N / D + order[j], so the
    gathered order is a permutation of 0..N-1. The source volumes stay
    replicated; the light stacks are replicated (each shard reads its
    slice) or, with `light_sharded`, sharded (each shard reads its own
    shard, so no stack ever moves). With `depth_map` (the mesh's, whole on
    every device), each shard's rays stop at the scene depth and its cube
    depth is all-gathered with the maps, as in the unsharded sweep.
    `sorted_output`, `pack` and a None `swap_basis` pick the output
    contract as in `ray_march_view_sweep_lod` (the warp and gather
    composites'): then the rows are in volume order and no order or flags
    move."""
    from multivolumes_tpu_torch.parallel import collectives

    nd = mesh.n_volumes_axis
    nl = vol_tex_ids[0].shape[0]
    n = nl * nd
    caps = tuple(c if c >= (1 << 20) else max(1, c // nd)
                 for c in bucket_caps)
    parts = {}
    for d in range(nd):
        dev = mesh.device(0, d)
        n_rows = per_object[dev].world.shape[0]
        assert n_rows == n and n % nd == 0, (n_rows, n, nd)
        rows = slice(d * nl, (d + 1) * nl)
        out = ray_march_view_sweep_lod(
            volumes_sweep[dev], vol_tex_ids[d],
            light_sweep[d] if light_sharded else light_sweep[dev][rows],
            per_object[dev].take(rows), cull[dev].take(rows), eye[dev],
            cube_map_size, None if swap_basis is None else swap_basis[dev],
            bucket_caps=caps,
            vol_zmax=None if vol_zmax is None else vol_zmax[dev], impl=impl,
            depth_map=None if depth_map is None else depth_map[dev],
            sorted_output=sorted_output, pack=pack)
        for name, x in (("cube_maps", out.cube_maps.color),
                        ("sweep_mips", out.mips),
                        ("sweep_order", out.order + d * nl
                         if sorted_output else None),
                        ("sweep_swap", out.swap),
                        ("cube_depth", out.cube_maps.depth)):
            if x is not None:
                parts.setdefault(name, []).append(x)
    got = {name: collectives.all_gather(x, 0, mesh, name)
           for name, x in parts.items()}
    none = dict.fromkeys(mesh.physical)
    return {dev: SortedSweep(
        CubeMaps(color=got["cube_maps"][dev],
                 depth=got.get("cube_depth", none)[dev]),
        got["sweep_mips"][dev],
        got["sweep_order"][dev] if sorted_output
        else torch.arange(n, device=dev),
        got.get("sweep_swap", none)[dev]) for dev in mesh.physical}


def ray_march_view_sweep_sharded(
    mesh,               # parallel.collectives.DeviceMesh
    volumes_sweep,      # replicated {device: (N_src, D, H, W, 4)}
    vol_tex_ids,        # volume-sharded: [d] -> (N / D,) on mesh.device(0, d)
    light_sweep,        # replicated {device: (N, L, L, L, 4)}, or with
                        # light_sharded the shards [d] -> (N / D, L, L, L, 4)
    per_object,         # replicated {device: PerObject}, all N rows
    cull,               # replicated {device: CullResult}, all N rows
    eye,                # replicated {device: (3,)}
    depth_map,          # replicated {device: (H, W)}, or None
    cube_map_size: int,
    num_planes: int | None = None,
    vol_zmax=None,      # replicated, or None
    impl: str | None = None,
    light_sharded: bool = False,
    pack: bool = False,
) -> dict:
    """The un-bucketed sweep partitioned over the mesh's volume axis
    (`march_volume_shards`): shard d marches its own N / D volumes at the
    full resolution S in one launch of kernel B1 (`ray_march_view_sweep`
    on its rows of the per-object data, the cull and the light stack);
    with `depth_map` its rays stop at the scene depth -> replicated
    {device: CubeMaps}."""
    def march(dev, d, rows):
        return ray_march_view_sweep(
            volumes_sweep[dev], vol_tex_ids[d],
            light_sweep[d] if light_sharded else light_sweep[dev][rows],
            per_object[dev].take(rows), cull[dev].take(rows), eye[dev],
            None if depth_map is None else depth_map[dev], cube_map_size,
            num_planes=num_planes,
            vol_zmax=None if vol_zmax is None else vol_zmax[dev], impl=impl)

    return march_volume_shards(
        mesh, vol_tex_ids[0].shape[0] * mesh.n_volumes_axis, march,
        depth_map is not None, pack=pack)


def march_volume_shards(mesh, n: int, march, with_depth: bool,
                        pack: bool = False) -> dict:
    """`march(dev, d, rows)` -> the CubeMaps of volume shard d, the
    volumes of global rows `rows` (N / D of the `n`), run on
    `mesh.device(0, d)` for each index d of the volume axis. With `pack`
    each shard packs its colour into f16 pairs (`composite.pack_cube_f16`,
    the gather composite's maps) before the move. The maps are then
    all-gathered in volume order (`gather_cube_maps`; the cube depth only
    `with_depth`) -> replicated {device: CubeMaps}."""
    nl = n // mesh.n_volumes_axis
    colors, depths = [], []
    for d in range(mesh.n_volumes_axis):
        out = march(mesh.device(0, d), d, slice(d * nl, (d + 1) * nl))
        colors.append(pack_cube_f16(out.color) if pack else out.color)
        depths.append(out.depth)
    return gather_cube_maps(mesh, colors, depths if with_depth else None)


def gather_cube_maps(mesh, colors, depths=None) -> dict:
    """The volume shards' cube maps, colour (N / D, 6, C, S, S) and cube
    depth (N / D, 6, S, S) in shard order, all-gathered onto every
    physical device -> replicated {device: CubeMaps}. With `depths` None
    (no scene depth: every texel's is 1) no depth moves; it is made where
    it is read."""
    from multivolumes_tpu_torch.parallel import collectives

    color = collectives.all_gather(colors, 0, mesh, "cube_maps")
    if depths is not None:
        depth = collectives.all_gather(depths, 0, mesh, "cube_depth")
    else:
        n, _f, _c, s, _ = color[mesh.root].shape
        depth = {dev: torch.ones((n, 6, s, s), dtype=torch.float32,
                                 device=dev) for dev in mesh.physical}
    return {dev: CubeMaps(color=color[dev], depth=depth[dev])
            for dev in mesh.physical}
