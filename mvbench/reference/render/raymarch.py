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

from typing import NamedTuple, Optional

import torch

from mvbench.reference.config import SharedConsts

ABSORPTION = SharedConsts.ABSORPTION
ZERO_THRESHOLD = SharedConsts.ZERO_THRESHOLD
MAX_DIST = SharedConsts.MAX_DIST
FLT_MAX = 3.402823466e38


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


# --- AoS wrappers over the _soa forms (setup-time use and tests) ----------


