"""Linear-clamp texture sampling on tensors (D3D `LINEAR_CLAMP` semantics).

Counterpart of `multivolumes_tpu/ops/trilinear.py`: `indexed_trilinear_soa`
is what the view and light marches sample with; the AoS samplers
(`sample_trilinear`, `sample_bilinear`, `sample_point`, `indexed_trilinear`,
`gather4_bilinear`) take the JAX functions' shapes and addressing. Texel
centres at (i + 0.5)/N, clamp addressing, separable linear filter. A 3D
texture is (D, H, W, C) indexed [z, y, x, c]; u walks W, v walks H, w
walks D. A 2D texture is (H, W, C) or (H, W); v walks H.
"""

from __future__ import annotations

import torch


def _indexed_trilerp(stack, idx, u, v, w):
    """The linear-clamp trilinear filter of stack (N, D, H, W[, C]) at
    (u, v, w) of volume idx -> (...[, C])."""
    d, h, ww = stack.shape[1:4]
    x = u * ww - 0.5
    y = v * h - 0.5
    z = w * d - 0.5
    x0f, y0f, z0f = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0f, y - y0f, z - z0f
    if stack.ndim == 5:
        fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]

    def cidx(vv, nn):
        return torch.clamp(vv.long(), 0, nn - 1)

    x0, x1 = cidx(x0f, ww), cidx(x0f + 1, ww)
    y0, y1 = cidx(y0f, h), cidx(y0f + 1, h)
    z0, z1 = cidx(z0f, d), cidx(z0f + 1, d)
    idx = idx.long()

    def tap(zi, yi, xi):
        return stack[idx, zi, yi, xi]

    c00 = tap(z0, y0, x0) * (1 - fx) + tap(z0, y0, x1) * fx
    c01 = tap(z0, y1, x0) * (1 - fx) + tap(z0, y1, x1) * fx
    c10 = tap(z1, y0, x0) * (1 - fx) + tap(z1, y0, x1) * fx
    c11 = tap(z1, y1, x0) * (1 - fx) + tap(z1, y1, x1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def indexed_trilinear_soa(stack, idx, u, v, w):
    """Trilinear sample from a stack of volumes with a per-sample index.

    stack: (N, D, H, W, C); idx, u, v, w: (...,) -> tuple of C (...,)."""
    out = _indexed_trilerp(stack, idx, u, v, w)
    return tuple(out[..., ci] for ci in range(stack.shape[-1]))


