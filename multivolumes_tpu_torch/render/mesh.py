"""Opaque mesh: shadow map, depth map and the deferred-shaded base pass.

Counterpart of `multivolumes_tpu/render/mesh.py` (the reference's
`ObjectRenderer`, `Content/ObjectRenderer.cpp`, with `VSDepth`,
`VSBasePass` and `PSBasePass`). The D3D rasterizer becomes a scatter
z-buffer plus a deferred shade:

1. *Raster*: every triangle emits a grid of coverage samples over its
   screen bbox (size-tiered, see `rasterize`); each inside sample
   scatter-mins the packed `(z15 << 17) | triangle id` into a per-pixel
   buffer, so the nearest depth wins and ties go to the lowest id.
2. *Deferred shade*: per pixel, the winning triangle's interpolation
   planes give perspective-correct position and normal; then the
   Blinn-Phong + Schlick-Fresnel + SH-ambient + Karis-env-BRDF shading of
   `PSBasePass.hlsl:94-153`, the velocity output and the Halton jitter of
   `VSBasePass.hlsl:50`. On the card it is one call of B8
   (`ops/mesh_shade.py`, `csrc/mesh_shade.cu`); `_shader` is its plain
   version.

The tier ladders, the capacity, the small-triangle tail and the dense
analytic top decide which coverage samples exist, so they decide the
image: they are ported as they are. On the card the raster is B9
(`ops/raster.py`, `csrc/raster.cu`): the per-triangle table, every
emit segment in one launch with an atomic min a drawn sample, and the
dense pass fused with the decode. Its plain version, `rasterize_plain`,
makes the z-buffer one `scatter_reduce_(..., "amin")` on int64: PyTorch
has no full uint32 arithmetic, so the quantised depth and the packing
are kept in int64, with the JAX package's 0xFFFFFFFF sentinel and its
extra drop slot. Windows of the screen are cut and pasted back by index
arithmetic on device tensors, so the pass reads no device value on the
host. Under a device mesh with a rows axis the raster and the shade run
in row bands (`render_mesh_sharded`). The frame's record counts, from
the host, the coverage samples the raster launches (`raster_samples`,
counter `mesh.raster_samples`) and the pixels the shade covers
(`mesh.shade_px`); a raster on the near ladder is the step span
`mesh.near`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig, SharedConsts
from multivolumes_tpu_torch.core import math3d, sh as sh_lib
from multivolumes_tpu_torch.core.camera import Camera
from multivolumes_tpu_torch.core.halton import halton_jitter
from multivolumes_tpu_torch.ops import mesh_shade as shade_ops
from multivolumes_tpu_torch.ops import raster as raster_ops
from multivolumes_tpu_torch.ops.mesh_shade import Span
from multivolumes_tpu_torch.utils import timing

_ZQ = float(1 << 24)  # depth quantization of the z-buffer
_BIG = 0xFFFFFFFF     # empty / dead-sample sentinel (uint32 max, in int64)
_TBITS = raster_ops.TBITS  # triangle-id bits of the packed z-buffer word


class MeshOutput(NamedTuple):
    color: tuple              # (r, g, b) fields (H, W)
    valid: torch.Tensor       # (H, W) bool, the mesh covers the pixel
    velocity: tuple           # (vx, vy) fields (H, W)
    depth: torch.Tensor       # (H, W) clip z (1 = empty)
    shadow: torch.Tensor      # (Sm, Sm) light-view clip z
    shadow_vp: torch.Tensor   # (4, 4)
    new_prev_wvp: torch.Tensor  # (4, 4)
    screen_center: tuple = (0.0, 0.0)  # mesh bbox centre in pixels


def _cull_capacity(num_tris: int) -> int:
    """Sample capacity under backface culling: half the triangles (a
    closed mesh shows at most about half its faces)."""
    return num_tris // 2


# All-distance base-pass tier ladder (close-ups keep every tier's sample
# stride <= 1 px); the far preset swaps in the mesh's own ladder.
NEAR_TIERS = ((2048, 10), (128, 36))


def far_preset(config: RenderConfig) -> bool:
    """The frame rasterizes on the mesh's own far ladder."""
    return bool(config.raster_preset == "far" and config.raster_far_tiers)


def far_ceiling(config: RenderConfig) -> int:
    """ceil(1.05 * raster_far_bound) px: the preset pick holds "far" up to
    1.05 times the bound, so a window contains the mesh only if it covers
    this."""
    return -(-21 * int(config.raster_far_bound) // 20)


# --- host side: the raster-preset pick (numpy, no device reads) ---------

def _np_view_proj(eye, focus, width, height,
                  fov_y=SharedConsts.FOV_ANGLE_Y):
    """Host-side look-at + perspective, matching math3d.look_at_lh /
    perspective_fov_lh."""
    eye = np.asarray(eye, np.float32)
    z = np.asarray(focus, np.float32) - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.zeros((4, 4), np.float32)
    view[:3, 0], view[:3, 1], view[:3, 2] = x, y, z
    view[3, :3] = [-x @ eye, -y @ eye, -z @ eye]
    view[3, 3] = 1.0
    h = 1.0 / np.tan(fov_y * 0.5)
    zn, zf = SharedConsts.Z_NEAR, SharedConsts.Z_FAR
    q = zf / (zf - zn)
    proj = np.array([[h / (width / height), 0, 0, 0], [0, h, 0, 0],
                     [0, 0, q, 1], [0, 0, -q * zn, 0]], np.float32)
    return view @ proj


def projected_size_px(aabb, eye, focus, width: int, height: int) -> float:
    """Projected screen-bbox edge (px) of a world AABB ((2, 3) min/max)
    from a host-side camera pose; +inf when a corner is at or behind the
    near plane (the near preset is always safe)."""
    aabb = np.asarray(aabb, np.float32)
    corners = np.stack(np.meshgrid(*aabb.T, indexing="ij"), -1
                       ).reshape(8, 3)
    vp = _np_view_proj(eye, focus, float(width), float(height))
    hp = np.concatenate([corners, np.ones((8, 1), np.float32)], 1) @ vp
    if (hp[:, 3] <= SharedConsts.Z_NEAR * 0.5).any():
        return float("inf")
    px = (hp[:, 0] / hp[:, 3] * 0.5 + 0.5) * width
    py = (0.5 - hp[:, 1] / hp[:, 3] * 0.5) * height
    return float(max(px.max() - px.min(), py.max() - py.min()))


def derive_far_tiers(vertices, indices, mesh_world, width: int,
                     height: int, bound_px: float, dense_top: int = 16,
                     margin: float = 1.1):
    """The far-distance tier ladder of a mesh, from its own geometry (host
    numpy, once at set_mesh; see the JAX function for the derivation).

    Cameras all around the mesh at the distance where its projected AABB
    edge equals bound_px give the per-rank max of front-facing triangle
    bbox edges; a tier (count, kk) keeps its sample stride <= 1 px iff
    every rank it covers has edge <= kk. Returns (big_tiers, small_tiers)
    for `rasterize`, or None for a degenerate mesh."""
    v = np.asarray(vertices, np.float32)[:, :3]
    f = np.asarray(indices, np.int64)
    if f.shape[0] <= dense_top or v.shape[0] < 3:
        return None
    world = np.asarray(mesh_world, np.float32)
    vw = np.concatenate([v, np.ones((len(v), 1), np.float32)], 1) @ world
    vw = vw[:, :3]
    lo, hi = vw.min(0), vw.max(0)
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - lo)) * 0.5
    if radius <= 0.0 or bound_px <= 0.0:
        return None

    d0 = radius * 8.0
    probe = projected_size_px(
        np.stack([lo, hi]), center + np.array([0.0, 0.0, -d0], np.float32),
        center, width, height)
    if not np.isfinite(probe) or probe <= 0.0:
        return None
    d = max(d0 * probe / bound_px, radius * 1.5)

    n_ranks = min(f.shape[0], 1 << 16)
    profile = np.zeros(n_ranks, np.float32)
    for elev in (-0.4, 0.0, 0.35, 0.7):
        for az in np.linspace(0.0, 2 * np.pi, 12, endpoint=False):
            ce = np.cos(elev)
            eye = center + d * np.array(
                [np.sin(az) * ce, np.sin(elev), np.cos(az) * ce],
                np.float32)
            vp = _np_view_proj(eye, center, float(width), float(height))
            hp = np.concatenate(
                [vw, np.ones((len(vw), 1), np.float32)], 1) @ vp
            w = np.maximum(hp[:, 3], 1e-6)
            px = (hp[:, 0] / w * 0.5 + 0.5) * width
            py = (0.5 - hp[:, 1] / w * 0.5) * height
            x0, y0 = px[f[:, 0]], py[f[:, 0]]
            x1, y1 = px[f[:, 1]], py[f[:, 1]]
            x2, y2 = px[f[:, 2]], py[f[:, 2]]
            area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
            ex = np.maximum(np.maximum(x0, x1), x2) \
                - np.minimum(np.minimum(x0, x1), x2)
            ey = np.maximum(np.maximum(y0, y1), y2) \
                - np.minimum(np.minimum(y0, y1), y2)
            edge = np.where(area > 0, np.maximum(ex, ey), -1.0)
            srt = np.sort(edge)[::-1][:n_ranks]
            np.maximum(profile, srt, out=profile)

    p = profile * margin

    def boundary(kk):
        """First rank whose margined max edge fits a kk grid."""
        idx = np.nonzero(p <= kk)[0]
        return int(idx[0]) if len(idx) else n_ranks

    kk0 = int(np.ceil(p[dense_top]))
    levels = sorted({kk for kk in range(5, max(kk0, 6))
                     if 4 < kk <= kk0} | ({kk0} if kk0 > 4 else set()),
                    reverse=True)
    tiers = []
    at = dense_top
    for i, kk in enumerate(levels):
        end = boundary(levels[i + 1] if i + 1 < len(levels) else 5)
        if end > at:                 # span [at, end) rasterizes at kk
            tiers.append((end, kk))
            at = end
    if not tiers:
        return None
    small = []
    at_s = max(boundary(4.5), at)
    for kk, lo in ((3, 4.0), (2, None)):
        end = boundary(lo) if lo is not None else n_ranks
        if end > at_s:
            small.append((at_s, kk))
            at_s = end
    # big: ((count, kk), ...) with counts = span ends; small: ((start,
    # kk), ...) with absolute span starts
    return tuple(sorted(tiers)), tuple(small)


# --- device side ----------------------------------------------------------

def shadow_view_proj(state) -> torch.Tensor:
    """Orthographic light view-proj (`ObjectRenderer.cpp:175-185`):
    look-at from the light to the origin, ortho size sceneSize * 1.5,
    zNear 1, zFar 200."""
    dev = state.light_pos.device
    size = state.scene_size * 1.5
    # focus and up made on the device; each host scalar written into a
    # device tensor is still an upload that waits for the stream
    up = torch.zeros(3, device=dev)
    timing.host_read("mesh.shadow_up",
                     functools.partial(up.__setitem__, 1, 1.0))
    view = math3d.look_at_lh(state.light_pos[:3],
                             torch.zeros(3, device=dev), up)
    q = 1.0 / (200.0 - 1.0)
    proj = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    proj[0, 0] = 2.0 / size
    proj[1, 1] = 2.0 / size
    for at, v in (((2, 2), q), ((3, 2), -q * 1.0), ((3, 3), 1.0)):
        timing.host_read("mesh.shadow_proj",
                         functools.partial(proj.__setitem__, at, v))
    return view @ proj


def window_index(c, win: int, extent: int, dev):
    """Indices (win,) of a `win`-wide window centred at device scalar c,
    clipped into [0, extent), with no host read."""
    start = torch.clamp(torch.round(c - win * 0.5), 0, extent - win).long()
    return start + torch.arange(win, device=dev)


_BIG_TIERS = ((2048, 12), (128, 48), (8, 256))  # rasterize's default ladder


def _emit_plan(n_tris: int, k: int, big_tiers, capacity, dense_top: int,
               tail, small_tiers):
    """The coverage emits of `rasterize`, in its order -> (ordered, plan):
    `ordered` whether the triangles are ranked by screen edge, `plan` a
    list of (lo, hi, kk), each the ranks [lo, hi) of that order on a
    kk x kk grid, or (None, None, k) for every triangle in index order."""
    T = n_tris
    ordered = bool(big_tiers or dense_top or tail or small_tiers
                   or (capacity is not None and capacity < T))
    if not ordered:
        return False, [(None, None, k)]
    n_emit = capacity if (capacity is not None and capacity < T) else T
    big_max = min(max((c for c, _ in big_tiers or ()), default=0), n_emit)
    if small_tiers and n_emit > 8:
        starts = [max(min(st, n_emit), big_max + 1) for st, _ in small_tiers]
        plan = [(big_max, starts[0], k)]
        for i, (_, kk) in enumerate(small_tiers):
            end = starts[i + 1] if i + 1 < len(starts) else n_emit
            if end > starts[i]:
                plan.append((starts[i], end, kk))
    elif tail and n_emit > 8:
        frac, tail_k = tail
        mid = max(int(n_emit * (1.0 - frac)), big_max + 1)
        plan = [(big_max, mid, k), (mid, n_emit, tail_k)]
    elif n_emit < T or big_max:
        plan = [(big_max, n_emit, k)]
    else:
        plan = [(None, None, k)]
    at = min(dense_top, T)  # ranks [0, dense_top) go to the dense pass
    for count, kk in sorted(big_tiers or ()):
        count = min(count, T)
        if count <= at:
            continue
        plan.append((at, count, kk))
        at = count
    return True, plan


@functools.lru_cache(maxsize=64)  # a frame's levers repeat every frame
def raster_samples(n_tris: int, width: int, height: int, k: int = 4,
                   big_tiers=_BIG_TIERS, want_ids: bool = True,
                   cull: int = 0, capacity: int | None = None,
                   dense_top: int = 0, tail: tuple | None = None,
                   small_tiers: tuple | None = None,
                   dense_window: int | None = None,
                   band: tuple | None = None) -> int:
    """The coverage samples `rasterize` launches with these levers on a
    mesh of `n_tris` triangles, from the host: each emit's triangles x
    kk^2 (culled triangles emit too), plus the dense pass's triangles x
    the pixels it z-tests (its window, the band's rows or the screen).
    The ladders are tuples (hashable), as the config holds them."""
    del cull
    ordered, plan = _emit_plan(n_tris, k, big_tiers, capacity, dense_top,
                               tail, small_tiers)
    n = sum((n_tris if lo is None
             else max(0, min(hi, n_tris) - min(lo, n_tris))) * kk * kk
            for lo, hi, kk in plan)
    if dense_top and ordered and (not want_ids or n_tris < (1 << _TBITS)):
        if (band is None and dense_window is not None
                and 0 < dense_window <= min(width, height)):
            px = dense_window * dense_window
        else:
            px = (height // band[1] if band is not None else height) * width
        n += min(dense_top, n_tris) * px
    return n


@functools.lru_cache(maxsize=64)  # a frame's levers repeat every frame
def emit_segments(n_tris: int, k: int, big_tiers, capacity,
                  dense_top: int, tail, small_tiers):
    """`_emit_plan` as B9's segment table -> (ordered, segments): each
    segment (lo, count, kk, by_rank, start) emits the ranks [lo, lo +
    count) of the by-edge order (by_rank 1), or the triangles [lo, lo +
    count) in index order (0), on a kk x kk grid, as the coverage samples
    [start, start + count kk^2) of the launch; empty emits are left out.
    The levers are tuples (hashable), as the config holds them."""
    ordered, plan = _emit_plan(n_tris, k, big_tiers, capacity, dense_top,
                               tail, small_tiers)
    segments, start = [], 0
    for lo, hi, kk in plan:
        by_rank = int(lo is not None)
        lo, hi = (0, n_tris) if lo is None else (min(lo, n_tris),
                                                 min(hi, n_tris))
        if hi > lo:
            segments.append((lo, hi - lo, kk, by_rank, start))
            start += (hi - lo) * kk * kk
    return ordered, tuple(segments)


def rasterize(verts_clip, indices, width: int, height: int, k: int = 4,
              big_tiers=_BIG_TIERS,
              want_ids: bool = True, cull: int = 0,
              capacity: int | None = None, dense_top: int = 0,
              tail: tuple | None = None, small_tiers: tuple | None = None,
              dense_window: int | None = None, band: tuple | None = None,
              impl: str | None = None):
    """Scatter z-buffer rasterization with tiered coverage (the levers:
    `rasterize_plain`) -> (depth (H, W), tri_id (H, W) int64). B9
    (`ops/raster.py`) on CUDA tensors, `rasterize_plain` on the CPU;
    `impl` forces a side (`ops`'s dispatch rule)."""
    if not ops.use_kernel(impl, verts_clip):
        return rasterize_plain(
            verts_clip, indices, width, height, k=k, big_tiers=big_tiers,
            want_ids=want_ids, cull=cull, capacity=capacity,
            dense_top=dense_top, tail=tail, small_tiers=small_tiers,
            dense_window=dense_window, band=band)
    ordered, segments = emit_segments(indices.shape[0], k, big_tiers,
                                      capacity, dense_top, tail, small_tiers)
    return raster_ops.raster(
        verts_clip, indices, segments, ordered=ordered, width=width,
        height=height, want_ids=want_ids, cull=cull, dense_top=dense_top,
        dense_window=dense_window, band=band)


def rasterize_plain(verts_clip, indices, width: int, height: int,
                    k: int = 4, big_tiers=_BIG_TIERS,
                    want_ids: bool = True, cull: int = 0,
                    capacity: int | None = None, dense_top: int = 0,
                    tail: tuple | None = None,
                    small_tiers: tuple | None = None,
                    dense_window: int | None = None,
                    band: tuple | None = None):
    """Scatter z-buffer rasterization with tiered coverage; the plain
    version of B9.

    verts_clip (V, 4) clip positions; indices (T, 3) int64. Returns
    (depth (H, W) in [0, 1], tri_id (H, W) int64, -1 = empty).

    `band=(row_idx, n_bands)` returns only the pixel rows [row_idx,
    row_idx + 1) * H / n_bands, (H / n_bands, W) each: the per-triangle
    emit is computed whole, but only the band's samples enter the
    scatter-min (every other sample goes to the drop slot) and the dense
    pass runs over the band's rows; `dense_window` is ignored. It needs
    the packed-id path (T < 2^17) and H % n_bands == 0. The bands stacked
    in order are the unbanded raster without a dense window, bit for bit.

    Each triangle gets a k x k sample grid over its bbox, snapped to pixel
    centres; by the stable by-edge order, the big tiers ((count, kk),
    ...) give the largest triangles finer grids, `tail=(frac, kk)` or the
    absolute `small_tiers=((start, kk), ...)` give the smallest ones
    coarser ones, `capacity` caps the emitting triangles, `cull` (+1/-1)
    drops triangles whose signed screen area has the other sign, and the
    `dense_top` largest triangles are z-tested analytically at every
    pixel (or in a `dense_window`-square window centred on the geometry).
    The semantics of every lever are those of the JAX `rasterize`."""
    dev = verts_clip.device
    v = verts_clip
    w_clip = v[:, 3]
    ndc = v[:, :3] / torch.clamp(w_clip[:, None].abs(), min=1e-20) \
        * torch.sign(w_clip[:, None])
    px = (ndc[:, 0] * 0.5 + 0.5) * width
    py = (0.5 - ndc[:, 1] * 0.5) * height
    pz = ndc[:, 2]

    t0, t1, t2 = indices[:, 0], indices[:, 1], indices[:, 2]
    x0, y0, z0, w0 = px[t0], py[t0], pz[t0], w_clip[t0]
    x1, y1, z1, w1 = px[t1], py[t1], pz[t1], w_clip[t1]
    x2, y2, z2, w2 = px[t2], py[t2], pz[t2], w_clip[t2]
    tri_ok = (w0 > 1e-6) & (w1 > 1e-6) & (w2 > 1e-6)
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    big_area = area.abs() > 1e-12
    inv_area = torch.where(big_area, 1.0 / torch.where(big_area, area, 1.0),
                           0.0)
    tri_ok = tri_ok & big_area
    if cull:
        tri_ok = tri_ok & (area * cull > 0)

    T = indices.shape[0]
    tids_all = torch.arange(T, device=dev)
    # (T, 15) per-triangle table; the ids ride beside it as int64
    cols = torch.stack([x0, y0, z0, x1, y1, z1, x2, y2, z2, inv_area,
                        tri_ok.float(), xmin, ymin, xmax, ymax], dim=1)

    def emit(sel, kk: int):
        """Coverage samples of triangle subset `sel` (None = all) on a
        kk x kk grid -> (flat pix, flat zq, flat tid)."""
        rows = cols if sel is None else cols[sel]
        tid_c = tids_all if sel is None else tids_all[sel]
        r = [rows[:, i, None, None] for i in range(15)]
        x0c, y0c, z0c, x1c, y1c, z1c, x2c, y2c, z2c, inv_c = r[:10]
        ok_c = r[10] > 0.5
        xminc, yminc, xmaxc, ymaxc = r[11:15]
        sx = torch.clamp((xmaxc - xminc) / kk, min=1.0)  # stride >= 1 px
        sy = torch.clamp((ymaxc - yminc) / kk, min=1.0)
        offs = torch.arange(kk, dtype=torch.float32, device=dev)
        oy, ox = torch.meshgrid(offs, offs, indexing="ij")
        sxp = torch.floor(xminc + ox[None] * sx) + 0.5
        syp = torch.floor(yminc + oy[None] * sy) + 0.5
        b1 = ((sxp - x0c) * (y2c - y0c) - (x2c - x0c) * (syp - y0c)) * inv_c
        b2 = ((x1c - x0c) * (syp - y0c) - (sxp - x0c) * (y1c - y0c)) * inv_c
        b0 = 1.0 - b1 - b2
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        z = b0 * z0c + b1 * z1c + b2 * z2c
        # truncation toward zero, as the JAX int32 cast (a sample at
        # x = -0.5 lands on pixel 0)
        xi = sxp.to(torch.int64)
        yi = syp.to(torch.int64)
        in_vp = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        ok = inside & in_vp & ok_c & (z >= 0.0) & (z <= 1.0)
        pix = torch.where(ok, yi * width + xi, height * width)
        zq = torch.clamp(z * _ZQ, 0, _ZQ - 1).to(torch.int64)
        zq = torch.where(ok, zq, _BIG)
        tid = tid_c[:, None, None].expand(pix.shape)
        return pix.reshape(-1), zq.reshape(-1), tid.reshape(-1)

    pack_ids = want_ids and T < (1 << _TBITS)

    ordered, plan = _emit_plan(T, k, big_tiers, capacity, dense_top, tail,
                               small_tiers)
    order = None
    if ordered:
        edge = torch.where(tri_ok, torch.maximum(xmax - xmin, ymax - ymin),
                           -1.0)
        order = torch.argsort(-edge, stable=True)
    parts = [emit(None if lo is None else order[lo:hi], kk)
             for lo, hi, kk in plan]

    flat_pix = torch.cat([p[0] for p in parts])
    flat_zq = torch.cat([p[1] for p in parts])
    tids = torch.cat([p[2] for p in parts])
    n_px = height * width
    out_h, row0 = height, 0
    if band is not None:
        row_idx, n_bands = band
        if not pack_ids:
            raise ValueError("the banded raster needs the packed-id path "
                             f"(want_ids and T < 2^{_TBITS}, T = {T})")
        if height % n_bands:
            raise ValueError(f"{height} rows do not split into {n_bands} "
                             "bands")
        out_h = height // n_bands
        row0 = row_idx * out_h
        # band-local pixels; the dead-sample sentinel (height * width) and
        # every sample outside the band go to the drop slot
        band_px = out_h * width
        pix_l = flat_pix - row0 * width
        flat_pix = torch.where((pix_l >= 0) & (pix_l < band_px), pix_l,
                               band_px)
        n_px = band_px

    if pack_ids:
        # one scatter-min of (z15 << 17) | tid: nearest z wins, ties to
        # the lowest id
        packed = torch.where(flat_zq == _BIG, _BIG,
                             ((flat_zq >> (24 - 15)) << _TBITS) | tids)
        buf = torch.full((n_px + 1,), _BIG, dtype=torch.int64, device=dev)
        buf.scatter_reduce_(0, flat_pix, packed, "amin")
        winner = buf[:n_px].reshape(out_h, width)
    else:
        zbuf = torch.full((n_px + 1,), _BIG, dtype=torch.int64, device=dev)
        zbuf.scatter_reduce_(0, flat_pix, flat_zq, "amin")
        if want_ids:
            # ids past 2^17: the depth winner's samples scatter-min their
            # ids in a second pass (no dense pass on this path)
            win = flat_zq == zbuf[flat_pix]
            tid_buf = torch.full((n_px + 1,), _BIG, dtype=torch.int64,
                                 device=dev)
            tid_buf.scatter_reduce_(0, torch.where(win, flat_pix, n_px),
                                    tids, "amin")
            zb = zbuf[:n_px]
            depth = torch.where(zb == _BIG, 1.0,
                                zb.float() / _ZQ).reshape(height, width)
            tb = tid_buf[:n_px]
            tri_id = torch.where(tb == _BIG, -1, tb).reshape(height, width)
            return depth, tri_id
        winner = zbuf[:n_px].reshape(height, width)

    if dense_top and order is not None:
        dn = min(dense_top, T)
        dr = cols[order[:dn]]                                   # (dn, 15)
        dtid = tids_all[order[:dn]]
        use_dw = band is None and dense_window is not None and \
            0 < dense_window <= min(width, height)
        if use_dw:
            dw = int(dense_window)
            okm = cols[:, 10] > 0.5
            bx0 = torch.where(okm, cols[:, 11], 1e9).min()
            by0 = torch.where(okm, cols[:, 12], 1e9).min()
            bx1 = torch.where(okm, cols[:, 13], -1e9).max()
            by1 = torch.where(okm, cols[:, 14], -1e9).max()
            xs = window_index((bx0 + bx1) * 0.5, dw, width, dev)
            ys = window_index((by0 + by1) * 0.5, dw, height, dev)
            xg = (xs.float() + 0.5)[None, :]
            yg = (ys.float() + 0.5)[:, None]
            acc = winner[ys[:, None], xs[None, :]]
        else:
            xg = torch.arange(width, dtype=torch.float32, device=dev)[None] \
                + 0.5
            yg = (torch.arange(out_h, dtype=torch.float32, device=dev)
                  + float(row0))[:, None] + 0.5
            acc = winner
        r = [dr[:, i, None, None] for i in range(11)]
        dx0, dy0 = xg[None] - r[0], yg[None] - r[1]
        b1 = (dx0 * (r[7] - r[1]) - (r[6] - r[0]) * dy0) * r[9]
        b2 = ((r[3] - r[0]) * dy0 - dx0 * (r[4] - r[1])) * r[9]
        b0 = 1.0 - b1 - b2
        z = b0 * r[2] + b1 * r[5] + b2 * r[8]
        ok = ((b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (r[10] > 0.5)
              & (z >= 0.0) & (z <= 1.0))
        zq = torch.clamp(z * _ZQ, 0, _ZQ - 1).to(torch.int64)
        if pack_ids:
            p = ((zq >> (24 - 15)) << _TBITS) | dtid[:, None, None]
        else:
            p = zq
        dense = torch.minimum(acc, torch.where(ok, p, _BIG).amin(dim=0))
        if use_dw:
            winner = winner.clone()
            winner[ys[:, None], xs[None, :]] = dense
        else:
            winner = dense

    if pack_ids:
        depth = torch.where(winner == _BIG, 1.0,
                            (winner >> _TBITS).float() / float(1 << 15))
        tri_id = torch.where(winner == _BIG, -1,
                             winner & ((1 << _TBITS) - 1))
        return depth, tri_id
    depth = torch.where(winner == _BIG, 1.0, winner.float() / _ZQ)
    return depth, torch.full((out_h, width), -1, dtype=torch.int64,
                             device=dev)


def _triangle_planes(verts_clip, pos, nrm, indices, width, height):
    """Per-triangle screen-affine interpolation planes (T, 23):
    [x0, y0, value at vertex 0 (7), d/dx (7), d/dy (7)] of the planes
    {pos/w (3), nrm/w (3), 1/w}, anchored at vertex 0's screen position.
    Perspective-correct interpolation of a is (sum b_i a_i/w_i) /
    (sum b_i/w_i), a ratio of two affine functions of (x, y)."""
    v = verts_clip
    w_clip = torch.clamp(v[:, 3], min=1e-20)
    px = (v[:, 0] / w_clip * 0.5 + 0.5) * width
    py = (0.5 - v[:, 1] / w_clip * 0.5) * height
    inv_w = 1.0 / w_clip
    vtab = torch.cat([px[:, None], py[:, None], pos * inv_w[:, None],
                      nrm * inv_w[:, None], inv_w[:, None]], dim=1)
    r0, r1, r2 = (vtab[indices[:, i]] for i in range(3))
    x0, y0 = r0[:, 0], r0[:, 1]
    x1, y1 = r1[:, 0], r1[:, 1]
    x2, y2 = r2[:, 0], r2[:, 1]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    big_area = area.abs() > 1e-12
    inv_area = torch.where(big_area, 1.0 / torch.where(big_area, area, 1.0),
                           0.0)
    a0, a1, a2 = r0[:, 2:], r1[:, 2:], r2[:, 2:]
    e1, e2 = a1 - a0, a2 - a0
    gx = (e1 * (y2 - y0)[:, None] - e2 * (y1 - y0)[:, None]) \
        * inv_area[:, None]
    gy = (e2 * (x1 - x0)[:, None] - e1 * (x2 - x0)[:, None]) \
        * inv_area[:, None]
    return torch.cat([x0[:, None], y0[:, None], a0, gx, gy], dim=1)


def _interp_planes(tbl, tri_id, xs, ys):
    """tri_id (h, w) at pixel columns xs (w,) and rows ys (h,) -> (valid,
    pos (x, y, z), nrm (x, y, z)) fields, one plane-row gather per
    pixel."""
    t = torch.clamp(tri_id, 0, tbl.shape[0] - 1)
    row = tbl[t]                                              # (h, w, 23)
    dx = (xs.float() + 0.5)[None, :] - row[..., 0]
    dy = (ys.float() + 0.5)[:, None] - row[..., 1]

    def plane(i):
        return row[..., 2 + i] + row[..., 9 + i] * dx + row[..., 16 + i] * dy

    inv_w = 1.0 / torch.clamp(plane(6), min=1e-20)
    pos = tuple(plane(i) * inv_w for i in range(3))
    nrm = tuple(plane(3 + i) * inv_w for i in range(3))
    return tri_id >= 0, pos, nrm


def _shadow_map_compare(lsx, lsy, lsz, shadow_map, bias: float = 0.0027):
    """2 x 2 PCF compare at the light-clip position (`ShadowMap`,
    `PSBasePass.hlsl:73-79`): the four taps (y0, x0) .. (y0 + 1, x0 + 1)
    read directly, with the tap origin clipped into [0, n - 2] as the JAX
    quad table's is."""
    z = lsz - bias
    h, w = shadow_map.shape
    x = (lsx * 0.5 + 0.5) * w - 0.5
    y = (1.0 - (lsy * 0.5 + 0.5)) * h - 0.5

    def origin(vv, nn):
        # clamp before and after the cast: NaN or huge values stay in range
        return torch.clamp(torch.clamp(torch.floor(vv), -1.0, nn).long(),
                           0, nn - 2)

    x0, y0 = origin(x, w), origin(y, h)
    fx = torch.clamp(x - x0.float(), 0.0, 1.0)
    fy = torch.clamp(y - y0.float(), 0.0, 1.0)

    def lit(yi, xi):
        return (z <= shadow_map[yi, xi]).float()

    c0 = lit(y0, x0) * (1 - fx) + lit(y0, x0 + 1) * fx
    c1 = lit(y0 + 1, x0) * (1 - fx) + lit(y0 + 1, x0 + 1) * fx
    return c0 * (1 - fy) + c1 * fy


def shade_base_pass(ws, nrm, ls, cs, ts, eye, light_pos, light_color,
                    ambient, sh_coeffs, shadow_map,
                    has_light_probe: bool = True):
    """`PSBasePass.hlsl:94-153` over scalar fields: ws/nrm/ls are (x, y,
    z), cs/ts clip (x, y, w) of this and the previous frame. Returns
    ((r, g, b), (vx, vy)); the environment reflection is an SH
    reconstruction (`sh.eval_radiance_soa`)."""
    base_color = (1.0, 0.6, 0.2)
    diffuse_brdf = tuple(c / np.pi for c in base_color)

    wsx, wsy, wsz = ws
    shadow = _shadow_map_compare(ls[0], ls[1], ls[2], shadow_map)

    ninv = torch.rsqrt(torch.clamp(
        nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2], min=1e-20))
    nx, ny, nz = nrm[0] * ninv, nrm[1] * ninv, nrm[2] * ninv

    csx, csy, csw = cs
    tsx, tsy, tsw = ts
    csw = torch.clamp(csw, min=1e-20)
    tsw = torch.clamp(tsw, min=1e-20)
    velocity = ((csx / csw - tsx / tsw) * 0.5,
                (csy / csw - tsy / tsw) * -0.5)

    l = light_pos[:3] / torch.linalg.norm(light_pos[:3])
    no_l = torch.clamp(nx * l[0] + ny * l[1] + nz * l[2], 0.0, 1.0)

    vx_, vy_, vz_ = eye[0] - wsx, eye[1] - wsy, eye[2] - wsz
    vinv = torch.rsqrt(torch.clamp(vx_ * vx_ + vy_ * vy_ + vz_ * vz_,
                                   min=1e-20))
    vx_, vy_, vz_ = vx_ * vinv, vy_ * vinv, vz_ * vinv
    no_v = torch.clamp(nx * vx_ + ny * vy_ + nz * vz_, 0.0, 1.0)

    hx, hy, hz = vx_ + l[0], vy_ + l[1], vz_ + l[2]
    hinv = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    no_h = torch.clamp((nx * hx + ny * hy + nz * hz) * hinv, 0.0, 1.0)

    lcol = light_color[:3] * light_color[3]
    if has_light_probe:
        amb = sh_lib.eval_irradiance_soa(sh_coeffs, nx, ny, nz)
        vn = nx * vx_ + ny * vy_ + nz * vz_       # reflect(-V, N)
        rx = 2.0 * vn * nx - vx_
        ry = 2.0 * vn * ny - vy_
        rz = 2.0 * vn * nz - vz_
        rad = sh_lib.eval_radiance_soa(sh_coeffs, rx, ry, rz)
        # Karis analytic env BRDF (`PSBasePass.hlsl:135-141`), rough 0.4
        rough = 0.4
        c0 = (-1.0, -0.0275, -0.572, 0.022)
        c1 = (1.0, 0.0425, 1.04, -0.04)
        rv = tuple(rough * a + b for a, b in zip(c0, c1))
        a004 = torch.minimum(torch.full_like(no_v, rv[0] * rv[0]),
                             torch.exp2(-9.28 * no_v)) * rv[0] + rv[1]
        env = 0.04 * (-1.04 * a004 + rv[2]) + (1.04 * a004 + rv[3])
        rad = tuple(r * env for r in rad)
    else:
        ay = ambient[:3] * ambient[3]
        scale = 0.5 + 0.5 * (ny * 0.5 + 0.5)
        amb = tuple(ay[c] * scale for c in range(3))
        rad = (0.0, 0.0, 0.0)

    fresnel = (1.0 - no_v) ** 5
    spec_ref = 0.08
    fres = fresnel * (1.0 - spec_ref) + spec_ref
    spec = torch.pow(no_h, 64.0) * fres

    color = tuple(
        (diffuse_brdf[c] * no_l + spec) * (lcol[c] * shadow)
        + diffuse_brdf[c] * amb[c] + rad[c]
        for c in range(3))
    return color, velocity


def render_shadow_map(state, config: RenderConfig) -> torch.Tensor:
    """Depth-only light-view raster (`RenderShadow`,
    `ObjectRenderer.cpp:220-243`), always on the near ladder (the
    light view is a fixed orthographic frame), B9 on the card. The
    engine calls it when the mesh or the light changes; frames read the
    cached map."""
    sm = config.shadow_map_size
    shadow_wvp = state.mesh_world @ shadow_view_proj(state)
    clip_sh = math3d.transform_point(state.mesh_verts[:, :3], shadow_wvp)
    cull = 1 if config.mesh_backface_cull else 0
    cap = (_cull_capacity(state.mesh_indices.shape[0])
           if config.mesh_backface_cull else None)
    depth, _ = rasterize(clip_sh, state.mesh_indices, sm, sm,
                         big_tiers=NEAR_TIERS, want_ids=False, cull=cull,
                         capacity=cap, dense_top=16, tail=config.raster_tail)
    return depth


def _pt_soa(m, x, y, z):
    return (x * m[0, 0] + y * m[1, 0] + z * m[2, 0] + m[3, 0],
            x * m[0, 1] + y * m[1, 1] + z * m[2, 1] + m[3, 1],
            x * m[0, 2] + y * m[1, 2] + z * m[2, 2] + m[3, 2],
            x * m[0, 3] + y * m[1, 3] + z * m[2, 3] + m[3, 3])


def _vec_soa(m, x, y, z):
    return (x * m[0, 0] + y * m[1, 0] + z * m[2, 0],
            x * m[0, 1] + y * m[1, 1] + z * m[2, 1],
            x * m[0, 2] + y * m[1, 2] + z * m[2, 2])


class _FrameOperands(NamedTuple):
    """One device's per-frame operands of the base pass."""
    wvp: torch.Tensor         # (4, 4) world-view-proj of this frame
    s_vp: torch.Tensor        # (4, 4) shadow view-proj
    clip_jit: torch.Tensor    # (V, 4) jittered clip positions
    raster_kw: dict           # rasterize's tier levers for this preset
    center: tuple             # mesh bbox centre (px), device scalars


def _frame_operands(state, camera: Camera,
                    config: RenderConfig) -> _FrameOperands:
    width, height = config.width, config.height
    wvp = state.mesh_world @ camera.view_proj
    # the jitter rides as two f32-exact scalars (no host-to-device copy)
    jx, jy = (float(j) for j in halton_jitter(state.frame_idx,
                                               float(width), float(height)))
    clip = math3d.transform_point(state.mesh_verts[:, :3], wvp)
    clip_jit = torch.cat([clip[:, :1] + jx * clip[:, 3:4],
                          clip[:, 1:2] + jy * clip[:, 3:4], clip[:, 2:]],
                         dim=1)
    far = far_preset(config)
    raster_kw = dict(
        big_tiers=config.raster_far_tiers if far else NEAR_TIERS,
        cull=1 if config.mesh_backface_cull else 0,
        capacity=(_cull_capacity(state.mesh_indices.shape[0])
                  if config.mesh_backface_cull else None),
        dense_top=16, tail=config.raster_tail,
        small_tiers=config.raster_far_small if far else None)
    # projected mesh bbox centre (px): anchors the shade window here and
    # TAA's windowed reprojection downstream
    wc = clip[:, 3]
    okv = wc > 1e-6
    cxs = (clip[:, 0] / torch.clamp(wc, min=1e-6) * 0.5 + 0.5) * width
    cys = (0.5 - clip[:, 1] / torch.clamp(wc, min=1e-6) * 0.5) * height
    cx = (torch.where(okv, cxs, 1e9).min()
          + torch.where(okv, cxs, -1e9).max()) * 0.5
    cy = (torch.where(okv, cys, 1e9).min()
          + torch.where(okv, cys, -1e9).max()) * 0.5
    return _FrameOperands(wvp, shadow_view_proj(state), clip_jit, raster_kw,
                          (cx, cy))


def _shader(state, camera: Camera, config: RenderConfig,
            op: _FrameOperands):
    """-> shade(tri_w, xs, ys): the deferred shade of the pixels at rows ys
    (h,) and columns xs (w,) whose winning triangles are tri_w (h, w) ->
    ((r, g, b), (vx, vy), valid), each (h, w). Pure per-pixel work, so
    any cut of the screen shades to the same values."""
    world = state.mesh_world
    shadow_wvp = world @ op.s_vp
    tbl = _triangle_planes(op.clip_jit, state.mesh_verts[:, :3],
                           state.mesh_verts[:, 3:6], state.mesh_indices,
                           config.width, config.height)

    def shade(tri_w, xs, ys):
        valid, pl_, nl_ = _interp_planes(tbl, tri_w, xs, ys)
        wsx, wsy, wsz, _ = _pt_soa(world, *pl_)
        nrm_w = _vec_soa(world, *nl_)
        lsx, lsy, lsz, _ = _pt_soa(shadow_wvp, *pl_)
        csx, csy, _csz, csw = _pt_soa(op.wvp, *pl_)
        tsx, tsy, _tsz, tsw = _pt_soa(state.mesh_prev_wvp, *pl_)
        color, velocity = shade_base_pass(
            (wsx, wsy, wsz), nrm_w, (lsx, lsy, lsz), (csx, csy, csw),
            (tsx, tsy, tsw), camera.eye, state.light_pos,
            state.light_color, state.ambient, state.sh_coeffs,
            state.mesh_shadow_map, has_light_probe=config.has_light_probe)
        col = tuple(torch.where(valid, c, 0.0) for c in color)
        vel = tuple(torch.where(valid, c, 0.0) for c in velocity)
        return col, vel, valid

    return shade


def _window_fits(config: RenderConfig) -> bool:
    """The far preset is on and `mesh_shade_window` covers the preset
    pick's hysteresis ceiling, so the window provably contains the
    mesh."""
    return far_preset(config) and config.mesh_shade_window \
        >= far_ceiling(config)


def _shade_window(config: RenderConfig) -> int:
    """The side of the shade window, or 0 for a full-screen shade (the
    window must contain the mesh and be smaller than the screen)."""
    win = config.mesh_shade_window
    return win if _window_fits(config) and 0 < win < min(
        config.width, config.height) else 0


def _shade_px(config: RenderConfig) -> int:
    """The pixels the deferred shade covers: its window, or the screen."""
    win = _shade_window(config)
    return win * win if win else config.width * config.height


def _paste(fields, valid, ys, xs, height: int, width: int):
    """Window fields (5, h, w) and valid (h, w) at rows ys and columns xs
    -> full-screen (5, H, W) and (H, W), zero (False) outside."""
    yi, xi = ys[:, None], xs[None, :]
    out = fields.new_zeros((fields.shape[0], height, width))
    out[:, yi, xi] = fields
    mask = valid.new_zeros((height, width))
    mask[yi, xi] = valid
    return out, mask


def _span_index(span: Span, config: RenderConfig, extent: int, dev):
    """The pixel indices (size,) of one axis of a shaded rectangle."""
    if span.centre is None:
        return span.base + torch.arange(span.size, device=dev)
    return window_index(span.centre, config.mesh_shade_window, extent,
                        dev)[span.base:span.base + span.size]


def shade_plain(state, camera: Camera, config: RenderConfig,
                op: _FrameOperands, tri_id, rows: Span, cols: Span,
                tri_row0: int = 0, paste: bool = False):
    """The plain version of B8 (`deferred_shade`, its arguments):
    `_shader`'s closure on the rectangle's pixels, pasted into the full
    screen with `paste` -> (fields (5, h, w), valid (h, w))."""
    dev = tri_id.device
    ys = _span_index(rows, config, config.height, dev)
    xs = _span_index(cols, config, config.width, dev)
    col, vel, valid = _shader(state, camera, config, op)(
        tri_id[(ys - tri_row0)[:, None], xs[None, :]], xs, ys)
    fields = torch.stack(col + vel)
    if paste:
        return _paste(fields, valid, ys, xs, config.height, config.width)
    return fields, valid


def deferred_shade(state, camera: Camera, config: RenderConfig,
                   op: _FrameOperands, tri_id, rows: Span, cols: Span,
                   tri_row0: int = 0, paste: bool = False,
                   impl: str | None = None):
    """The deferred shade of one rectangle of the screen (a `Span` an
    axis, a centred one the shade window's) from the winning ids tri_id
    (th, W) of screen rows [tri_row0, tri_row0 + th) -> (fields (5, h, w)
    (r, g, b, vx, vy), valid (h, w)), or with `paste` the full screen's,
    0 and False outside the rectangle. B8 (`ops/mesh_shade.py`) on CUDA
    tensors, `shade_plain` on the CPU; `impl` forces a side (`ops`'s
    dispatch rule)."""
    if not ops.use_kernel(impl, tri_id):
        return shade_plain(state, camera, config, op, tri_id, rows, cols,
                           tri_row0=tri_row0, paste=paste)
    return shade_ops.mesh_shade(
        tri_id, rows, cols, op.clip_jit, state.mesh_verts,
        state.mesh_indices, state.mesh_world, op.s_vp, op.wvp,
        state.mesh_prev_wvp, camera.eye, state.light_pos, state.light_color,
        state.ambient, state.sh_coeffs, state.mesh_shadow_map,
        height=config.height, width=config.width,
        window=config.mesh_shade_window,
        has_light_probe=config.has_light_probe, tri_row0=tri_row0,
        paste=paste)


def render_mesh(state, camera: Camera, config: RenderConfig,
                impl: str | None = None) -> MeshOutput:
    """Base pass + deferred shade (the shadow map is cached in state).

    Under the far preset (the host pick guarantees the projected bbox <=
    raster_far_bound), the dense raster pass and the deferred shade run
    in a `mesh_shade_window` square around the mesh when the window
    provably contains it; the near preset shades the full screen. The
    raster is B9 (`ops/raster.py`) and the shade B8 (`ops/mesh_shade.py`),
    `impl` forces their side. Under a device mesh:
    `render_mesh_sharded`."""
    width, height = config.width, config.height
    with timing.span("mesh.operands"):
        op = _frame_operands(state, camera, config)
    dense_window = config.mesh_shade_window if _window_fits(config) else None
    with timing.span("mesh.raster"), (
            contextlib.nullcontext() if far_preset(config)
            else timing.span("mesh.near")):
        depth, tri_id = rasterize(
            op.clip_jit, state.mesh_indices, width, height,
            dense_window=dense_window, impl=impl, **op.raster_kw)
    timing.add("mesh.raster_samples", raster_samples(
        state.mesh_indices.shape[0], width, height,
        dense_window=dense_window, **op.raster_kw))
    timing.add("mesh.shade_px", _shade_px(config))
    with timing.span("mesh.shade"):
        win = _shade_window(config)
        if win:
            rows, cols = Span(0, win, op.center[1]), Span(0, win, op.center[0])
        else:
            rows, cols = Span(0, height), Span(0, width)
        fields, valid = deferred_shade(state, camera, config, op, tri_id,
                                       rows, cols, paste=bool(win),
                                       impl=impl)
    f = fields.unbind(0)
    return MeshOutput(color=f[:3], valid=valid, velocity=f[3:], depth=depth,
                      shadow=state.mesh_shadow_map, shadow_vp=op.s_vp,
                      new_prev_wvp=op.wvp, screen_center=op.center)


def render_mesh_sharded(states: dict, cameras: dict, config: RenderConfig,
                        mesh, impl: str | None = None) -> dict:
    """The mesh pass under a device mesh `mesh` (a
    `parallel.collectives.DeviceMesh`; counterpart of the JAX
    `render_mesh(..., device_mesh=...)`, `multivolumes_tpu/render/
    mesh.py:742-865`). `states` and `cameras` are replicated dicts
    {device: SceneState / Camera} over its physical devices, and so is
    the result {device: MeshOutput}.

    With a "rows" axis, H % rows == 0 and T < 2^17, band r rasterizes its
    rows on `mesh.device(r, 0)` (the per-triangle emit replicates, the
    z-buffer is the band's own; B9 on the card, `impl` forces its side)
    and the depth bands are all-gathered
    onto every physical device: the sweep on every volume shard and the
    composite on every band need the whole depth map. The deferred shade
    then runs
    * under the far preset's window, when the window splits into the
      rows: rows device r shades rows [r win / rows, (r + 1) win / rows)
      of the window from the all-gathered triangle ids (JAX
      `mesh.py:840-865`); when it does not split, the root shades the
      window straight into the screen;
    * under the near preset (the full screen): each band shades its own
      rows from its own ids. The JAX package lets GSPMD cut this shade;
      it is per-pixel work, so any cut gives the same values.
    Each piece is one `deferred_shade` (B8 on the card, `impl` forces its
    side). The band pieces are gathered (and a window's pasted) on
    `mesh.root`, where the screen passes run, so only the root's
    MeshOutput carries colour, velocity and validity (None elsewhere);
    every device's carries the depth map, the cached shadow map, the
    shadow view-proj, the new previous-frame world-view-proj and the
    mesh's screen centre, computed there from its replicated state (the
    root's centre anchors the windowed TAA reprojection, so nothing is
    read on the host).

    Otherwise (no rows axis, or the JAX package's other two conditions)
    the whole pass runs on each physical device, as the other replicated
    passes do: the JAX code's own else branch."""
    from multivolumes_tpu_torch.parallel import collectives as coll

    width, height = config.width, config.height
    rows, root = mesh.rows, mesh.root
    n_tris = states[root].mesh_indices.shape[0]
    if not ("rows" in mesh.axis_names and rows > 1 and height % rows == 0
            and n_tris < (1 << _TBITS)):
        return {dev: render_mesh(states[dev], cameras[dev], config, impl)
                for dev in mesh.physical}
    frame_ops = {dev: _frame_operands(states[dev], cameras[dev], config)
                 for dev in mesh.physical}
    band_devs = [mesh.device(r, 0) for r in range(rows)]
    bands = [rasterize(frame_ops[dev].clip_jit, states[dev].mesh_indices,
                       width, height, band=(r, rows), impl=impl,
                       **frame_ops[dev].raster_kw)
             for r, dev in enumerate(band_devs)]
    depth = coll.all_gather([b[0] for b in bands], 0, mesh, "mesh_depth")
    timing.add("mesh.raster_samples", sum(
        raster_samples(n_tris, width, height, band=(r, rows),
                       **frame_ops[dev].raster_kw)
        for r, dev in enumerate(band_devs)))
    timing.add("mesh.shade_px", _shade_px(config))

    def shade(dev, tri_w, rows_d, cols_d, tri_row0=0, paste=False):
        return deferred_shade(states[dev], cameras[dev], config,
                              frame_ops[dev], tri_w, rows_d, cols_d,
                              tri_row0=tri_row0, paste=paste, impl=impl)

    def onto_root(pieces):
        """The shaded pieces, in row order, gathered onto the root."""
        return (coll.all_gather([p[0] for p in pieces], 1, mesh,
                                "mesh_shade", devices=(root,))[root],
                coll.all_gather([p[1] for p in pieces], 0, mesh,
                                "mesh_valid", devices=(root,))[root])

    win = _shade_window(config)
    out_h = height // rows
    if win and win % rows == 0:
        tri = coll.all_gather([b[1] for b in bands], 0, mesh, "mesh_tri_id",
                              devices=tuple(dict.fromkeys(band_devs)))
        wb = win // rows
        fields, valid = onto_root([
            shade(dev, tri[dev], Span(r * wb, wb, frame_ops[dev].center[1]),
                  Span(0, win, frame_ops[dev].center[0]))
            for r, dev in enumerate(band_devs)])
        cx, cy = frame_ops[root].center
        fields, valid = _paste(
            fields, valid, _span_index(Span(0, win, cy), config, height, root),
            _span_index(Span(0, win, cx), config, width, root), height, width)
    elif win:
        # the root shades the whole window straight into the screen
        tri = coll.all_gather([b[1] for b in bands], 0, mesh, "mesh_tri_id",
                              devices=(root,))[root]
        cx, cy = frame_ops[root].center
        fields, valid = shade(root, tri, Span(0, win, cy), Span(0, win, cx),
                              paste=True)
    else:
        # the full-screen shade: per raster band, from the band's own ids
        fields, valid = onto_root([
            shade(dev, tri_b, Span(r * out_h, out_h), Span(0, width),
                  tri_row0=r * out_h)
            for r, (dev, (_d, tri_b)) in enumerate(zip(band_devs, bands))])
    shaded = (tuple(fields[:3]), tuple(fields[3:]), valid)
    return {dev: MeshOutput(
        color=shaded[0] if dev == root else None,
        valid=shaded[2] if dev == root else None,
        velocity=shaded[1] if dev == root else None,
        depth=depth[dev], shadow=states[dev].mesh_shadow_map,
        shadow_vp=op.s_vp, new_prev_wvp=op.wvp, screen_center=op.center)
        for dev, op in frame_ops.items()}
