"""Display mapping and sky rendering.

Counterpart of `tone_map`, `tone_map_ch`, `_upsample_matrix`,
`render_environment` and `srgb_encode` in
`multivolumes_tpu/render/postprocess.py`: the tone
map of `PSToneMap.hlsl:19-28`, the environment pass of `PSEnvironment.hlsl:
46-69` (sampled at reduced resolution, bilinearly upsampled) and the
sRGB encode of the PNG output.
"""

from __future__ import annotations

import torch

from mvbench.reference.render import composite


def tone_map_ch(r, g, b):
    """x * 1.05 / (x + 0.7), then |x|^1.25, per channel field."""

    def f(x):
        x = x * 1.05 / (x + 0.7)
        return torch.pow(x.abs(), 1.25)

    return f(r), f(g), f(b)


def _upsample_matrix(n_out: int, n_in: int, device=None):
    """(n_out, n_in) bilinear upsample matrix (texel-centre aligned)."""
    rows = torch.arange(n_out, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    src = torch.clamp((rows + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1.0)
    return torch.clamp(1.0 - (src - cols).abs(), min=0.0)


def sample_cube(radiance, dx, dy, dz):
    """Bilinear linear-clamp sample of a (6, R, R, 3) cube along
    directions -> (r, g, b) fields."""
    n = radiance.shape[1]
    face, u, v = composite.dir_to_face_uv_soa(dx, dy, dz)
    x, y = u * n - 0.5, v * n - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = torch.where(x0f < 0, 0.0, x - x0f)[..., None]
    fy = torch.where(y0f < 0, 0.0, y - y0f)[..., None]
    x0 = torch.clamp(x0f.long(), 0, n - 1)
    y0 = torch.clamp(y0f.long(), 0, n - 1)
    x1 = torch.clamp(x0 + 1, max=n - 1)
    y1 = torch.clamp(y0 + 1, max=n - 1)
    rad = radiance.float()
    out = ((rad[face, y0, x0] * (1 - fx) + rad[face, y0, x1] * fx) * (1 - fy)
           + (rad[face, y1, x0] * (1 - fx) + rad[face, y1, x1] * fx) * fy)
    return out[..., 0], out[..., 1], out[..., 2]


def render_environment(radiance, screen_to_world, eye, width: int,
                       height: int, scale: int = 2):
    """Sky colour for every pixel -> 3 x (H, W) fields, sampled at
    1/scale resolution (kept >= ~160 columns) and upsampled."""
    scale = min(scale, max(1, width // 160))
    while scale > 1 and (width % scale or height % scale):
        scale -= 1
    wl, hl = (width // scale, height // scale) if scale > 1 else (width,
                                                                  height)
    _xy, (dx, dy, dz) = composite.screen_rays(wl, hl, screen_to_world, eye)
    low = sample_cube(radiance, dx, dy, dz)
    if (wl, hl) == (width, height):
        return low
    dev = radiance.device
    mu = _upsample_matrix(width, wl, dev)
    mv = _upsample_matrix(height, hl, dev)
    return tuple(mv @ c @ mu.T for c in low)


