"""Order-3 spherical harmonics: cube-map projection + irradiance evaluation.

Counterpart of `multivolumes_tpu/core/sh.py` (the reference's SH chain:
`XUSGSphericalHarmonics.h` projection, `SHIrradianceTypeless.hlsli`
evaluation). Coefficient order: L00, L1-1(y), L10(z), L11(x), L2-2(xy),
L2-1(yz), L20, L21(xz), L22.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sh_basis(d):
    """Real SH basis of order 3 at directions d: (..., 3) -> (..., 9)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            0.4886025119029199 * y,
            0.4886025119029199 * z,
            0.4886025119029199 * x,
            1.0925484305920792 * x * y,
            1.0925484305920792 * y * z,
            0.31539156525252005 * (3.0 * z * z - 1.0),
            1.0925484305920792 * x * z,
            0.5462742152960396 * (x * x - y * y),
        ],
        dim=-1,
    )


def cube_face_dirs(size: int) -> np.ndarray:
    """Unit directions for every texel of a 6-face cube map: (6, S, S, 3).

    D3D face order +X,-X,+Y,-Y,+Z,-Z with v pointing down
    (`CSRayMarch.hlsl:28-53`, GetLocalPos)."""
    ts = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(ts, ts, indexing="xy")
    mv = -v
    one = np.ones_like(u)
    faces = np.stack(
        [
            np.stack([one, mv, -u], -1),
            np.stack([-one, mv, u], -1),
            np.stack([u, one, v], -1),
            np.stack([u, -one, -v], -1),
            np.stack([u, mv, one], -1),
            np.stack([-u, mv, -one], -1),
        ]
    )
    return faces / np.linalg.norm(faces, axis=-1, keepdims=True)


def cube_texel_solid_angles(size: int) -> np.ndarray:
    """Per-texel solid-angle weights for one face: (S, S)."""
    ts = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(ts, ts, indexing="xy")
    r2 = 1.0 + u * u + v * v
    da = (2.0 / size) ** 2
    return (da / (r2 * np.sqrt(r2))).astype(np.float32)


def project_cube_map(radiance):
    """Project a radiance cube map onto SH-9: (6, S, S, 3) -> (9, 3)."""
    size = radiance.shape[1]
    dev = radiance.device
    dirs = torch.from_numpy(cube_face_dirs(size)).to(dev)
    w = torch.from_numpy(cube_texel_solid_angles(size)).to(dev)
    wb = sh_basis(dirs) * w[None, :, :, None]
    coeffs = torch.einsum("fuvk,fuvc->kc", wb, radiance.float())
    total_w = 6.0 * w.sum()
    return coeffs * (4.0 * math.pi / total_w)


def eval_irradiance(sh_coeffs, n):
    """Cosine-convolved irradiance at normals n: (9,3),(...,3) -> (...,3)."""
    c1, c2, c3, c4 = 0.429043, 0.511664, 0.247708, 0.886227
    x, y, z = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    L = sh_coeffs
    irr = (
        (c1 * (x * x - y * y)) * L[8]
        + (c3 * (3.0 * z * z - 1.0)) * L[6]
        + c4 * L[0]
        + 2.0 * c1 * (L[4] * x * y + L[7] * x * z + L[5] * y * z)
        + 2.0 * c2 * (L[3] * x + L[1] * y + L[2] * z)
    )
    return torch.clamp(irr, min=0.0)


def eval_irradiance_soa(sh_coeffs, x, y, z):
    """`eval_irradiance` over scalar direction fields -> (r, g, b)."""
    c1, c2, c3, c4 = 0.429043, 0.511664, 0.247708, 0.886227
    L = sh_coeffs
    outs = []
    for ch in range(3):
        irr = (
            (c1 * (x * x - y * y)) * L[8, ch]
            + (c3 * (3.0 * z * z - 1.0)) * L[6, ch]
            + c4 * L[0, ch]
            + 2.0 * c1 * (L[4, ch] * x * y + L[7, ch] * x * z
                          + L[5, ch] * y * z)
            + 2.0 * c2 * (L[3, ch] * x + L[1, ch] * y + L[2, ch] * z)
        )
        outs.append(torch.clamp(irr, min=0.0))
    return tuple(outs)


def eval_radiance_soa(sh_coeffs, x, y, z):
    """Band-limited radiance sum_k c_k Y_k(d) over scalar direction fields
    -> (r, g, b), clamped at 0 (the mesh's rough environment reflection)."""
    ys = (
        torch.full_like(x, 0.28209479177387814),
        0.4886025119029199 * y,
        0.4886025119029199 * z,
        0.4886025119029199 * x,
        1.0925484305920792 * x * y,
        1.0925484305920792 * y * z,
        0.31539156525252005 * (3.0 * z * z - 1.0),
        1.0925484305920792 * x * z,
        0.5462742152960396 * (x * x - y * y),
    )
    outs = []
    for ch in range(3):
        acc = ys[0] * sh_coeffs[0, ch]
        for k in range(1, 9):
            acc = acc + ys[k] * sh_coeffs[k, ch]
        outs.append(torch.clamp(acc, min=0.0))
    return tuple(outs)


