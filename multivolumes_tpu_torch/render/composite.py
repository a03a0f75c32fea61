"""Screen-space helpers shared by the composite and the sky.

Counterpart of `unproject_z`, `dir_to_face_uv_soa` and `screen_rays` in
`multivolumes_tpu/render/composite.py`. The per-pixel CubeCast gather
composite of that module is a reference twin, not ported yet.
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch.config import SharedConsts


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
