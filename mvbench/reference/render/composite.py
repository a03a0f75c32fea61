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

import torch

from mvbench.reference.config import SharedConsts
from mvbench.reference.render import raymarch

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


# --- the OIT composite -------------------------------------------------------


