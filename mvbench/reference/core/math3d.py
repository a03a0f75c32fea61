"""DirectXMath-convention 3D math on torch tensors.

Counterpart of `multivolumes_tpu/core/math3d.py`: left-handed, row-vector
times matrix, clip z in [0, 1]. `transform_point(p, M)` is HLSL
`mul(float4(p, 1), M)`. Every function batches along leading axes and
creates tensors on the device of its inputs (or the `device` argument).
"""

from __future__ import annotations

import torch


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
    m[3, 3] = 1.0
    return m


def scaling(s, device=None):
    s = torch.broadcast_to(_f32(s, device), (3,))
    return torch.diag(torch.cat([s, s.new_ones(1)]))


def translation(t, device=None):
    t = _f32(t, device)
    m = torch.eye(4, dtype=torch.float32, device=t.device)
    m[3, :3] = t
    return m


def transform_point(p, m):
    """HLSL `mul(float4(p, 1), M)` -> homogeneous float4.

    p: (..., 3), m: (..., 4, 4) -> (..., 4).
    """
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return torch.einsum("...i,...ij->...j", ph, m)


def transform_point3(p, m):
    """Affine transform only: `mul(float4(p,1), (float4x3)M)`."""
    return transform_point(p, m)[..., :3]


def inverse(m):
    return torch.linalg.inv(m)


def normalize(v, eps: float = 1e-20):
    """Safe vector normalize along the last axis."""
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))
