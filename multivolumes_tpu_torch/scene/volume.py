"""Density-volume creation (procedural sources).

Counterpart of `multivolumes_tpu/scene/volume.py`. The fields are built in
numpy exactly as there (same `numpy.random.RandomState` seeds), then
handed to torch, so both packages get the same volumes bit for bit.
Volumes are (D, H, W, 4): RGB albedo, A density.
"""

from __future__ import annotations

import numpy as np
import torch


def _grid(grid_size: int):
    ts = (np.arange(grid_size, dtype=np.float32) + 0.5) / grid_size * 2.0 - 1.0
    return np.meshgrid(ts, ts, ts, indexing="ij")  # z, y, x


def init_grid_data(grid_size: int, corner_free: bool = False) -> np.ndarray:
    """Procedural test volume `CSInitGridData.hlsl:10-27`: (1-r^2)^4 * 2
    falloff with an orange/blue gradient. `corner_free` clamps (1-r^2) at
    zero first (the pure blob, without the corner bulbs)."""
    z, y, x = _grid(grid_size)
    a = 1.0 - (x * x + y * y + z * z)
    if corner_free:
        a = np.maximum(a, 0.0)
    a = a * a
    a = np.clip(a * a * 2.0, 0.0, 1.0)

    color_u = np.array([1.0, 0.6, 0.0], np.float32)
    color_d = np.array([0.5, 0.8, 1.0], np.float32)
    t = np.clip(y * 0.5 + 0.2, 0.0, 1.0)[..., None]
    color = color_d * (1.0 - t) + color_u * t
    return np.concatenate([color, a[..., None]], axis=-1).astype(np.float32)


def init_grid_variant(grid_size: int, seed: int) -> np.ndarray:
    """Procedural stand-in for one of the reference's DDS sources: the
    sphere falloff modulated by low-frequency cosine lobes."""
    z, y, x = _grid(grid_size)
    rng = np.random.RandomState(seed + 12345)
    a = 1.0 - (x * x + y * y + z * z)
    a = np.clip(a, 0.0, None) ** 2
    mod = np.ones_like(a)
    for _ in range(3):
        k = rng.uniform(1.5, 4.0, size=3)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        mod *= 0.5 + 0.5 * np.cos(k[0] * np.pi * x + ph[0]) * np.cos(
            k[1] * np.pi * y + ph[1]
        ) * np.cos(k[2] * np.pi * z + ph[2])
    a = np.clip(a * (0.35 + 1.3 * mod) * 2.0, 0.0, 1.0)

    hue = rng.uniform(0, 1, size=3)
    color_u = 0.4 + 0.6 * np.roll(np.array([1.0, 0.6, 0.1], np.float32),
                                  seed % 3) * hue[0]
    color_d = 0.4 + 0.6 * np.roll(np.array([0.4, 0.7, 1.0], np.float32),
                                  seed % 3)
    t = np.clip(y * 0.5 + 0.2, 0.0, 1.0)[..., None]
    color = (color_d * (1.0 - t) + color_u * t).astype(np.float32)
    return np.concatenate([color, a[..., None]], axis=-1).astype(np.float32)


def r32f_to_rgba(density, device=None) -> torch.Tensor:
    """An imported R32F density grid (D, H, W) -> the engine's RGBA layout
    (`CSR32FToRGBA16F.hlsl:16-26`): white albedo, alpha = density / 4.
    The reference also resamples to the engine grid through a linear
    sampler; callers resize first if the shapes differ."""
    density = torch.from_numpy(np.array(density, np.float32)).to(device)
    rgb = torch.ones(density.shape + (3,), dtype=torch.float32,
                     device=density.device)
    return torch.cat([rgb, density[..., None] * 0.25], dim=-1)


def make_volume_sources(num_srcs: int, grid_size: int,
                        device=None) -> torch.Tensor:
    """Stack of source density textures: (num_srcs, D, H, W, 4) f32.
    Source 0 is the canonical CSInitGridData blob; the rest are variants."""
    vols = [init_grid_data(grid_size, corner_free=True)]
    vols += [init_grid_variant(grid_size, i) for i in range(1, num_srcs)]
    return torch.from_numpy(np.stack(vols)).to(device)
