"""DirectXMath-convention 3D math on torch tensors.

Counterpart of `multivolumes_tpu/core/math3d.py`: left-handed, row-vector
times matrix, clip z in [0, 1]. `transform_point(p, M)` is HLSL
`mul(float4(p, 1), M)`. Every function batches along leading axes and
creates tensors on the device of its inputs (or the `device` argument).
"""

from __future__ import annotations

import functools
import math

import torch

from multivolumes_tpu_torch.utils import timing


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def look_at_lh(eye, focus, up):
    """XMMatrixLookAtLH equivalent: row-vector view matrix."""
    eye, focus, up = _f32(eye), _f32(focus, eye.device), _f32(up, eye.device)
    z = normalize(focus - eye)
    x = normalize(torch.linalg.cross(up, z))
    y = torch.linalg.cross(z, x)
    t = torch.stack([-(x * eye).sum(), -(y * eye).sum(), -(z * eye).sum()])
    m = torch.zeros((4, 4), dtype=torch.float32, device=eye.device)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[3, :3] = t
    # a host scalar written into a device tensor: an upload that waits
    timing.host_read("math3d.look_at",
                     functools.partial(m.__setitem__, (3, 3), 1.0))
    return m


def perspective_fov_lh(fov_y: float, aspect: float, z_near: float,
                       z_far: float, device=None):
    """XMMatrixPerspectiveFovLH equivalent (clip z in [0,1])."""
    h = 1.0 / torch.tan(_f32(fov_y) * 0.5)
    w = h / aspect
    q = z_far / (z_far - z_near)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = q
    m[2, 3] = 1.0
    m[3, 2] = -q * z_near
    return m.to(device)


def orthographic_lh(width: float, height: float, z_near: float,
                    z_far: float, device=None):
    """XMMatrixOrthographicLH equivalent."""
    q = 1.0 / (z_far - z_near)
    return _f32([[2.0 / width, 0.0, 0.0, 0.0],
                 [0.0, 2.0 / height, 0.0, 0.0],
                 [0.0, 0.0, q, 0.0],
                 [0.0, 0.0, -q * z_near, 1.0]], device)


def scaling(s, device=None):
    s = torch.broadcast_to(_f32(s, device), (3,))
    return torch.diag(torch.cat([s, s.new_ones(1)]))


def translation(t, device=None):
    t = _f32(t, device)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[3, :3] = t
    return m


def rotation_y(angle, device=None):
    c, s = math.cos(angle), math.sin(angle)
    return _f32([[c, 0.0, -s, 0.0],
                 [0.0, 1.0, 0.0, 0.0],
                 [s, 0.0, c, 0.0],
                 [0.0, 0.0, 0.0, 1.0]], device)


def transform_point(p, m):
    """HLSL `mul(float4(p, 1), M)` -> homogeneous float4.

    p: (..., 3), m: (..., 4, 4) -> (..., 4).
    """
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return torch.einsum("...i,...ij->...j", ph, m)


def transform_point3(p, m):
    """Affine transform only: `mul(float4(p,1), (float4x3)M)`."""
    return transform_point(p, m)[..., :3]


def transform_vector(v, m):
    """HLSL `mul(v, (float3x3)M)` — rotate/scale only, no translation."""
    return torch.einsum("...i,...ij->...j", v, m[..., :3, :3])


def project_point(p, m):
    """Transform + perspective divide -> (..., 3) NDC xyz."""
    h = transform_point(p, m)
    return h[..., :3] / h[..., 3:4]


def inverse(m):
    """`torch.linalg.inv`, whose singularity check reads the device."""
    return timing.host_read("math3d.inverse", lambda: torch.linalg.inv(m))


def normalize(v, eps: float = 1e-20):
    """Safe vector normalize along the last axis."""
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))
