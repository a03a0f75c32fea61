"""Halton low-discrepancy sequence for the mesh's sub-pixel jitter.

Counterpart of `multivolumes_tpu/core/halton.py` (the reference's
`XUSG::Halton` / `IncrementalHalton`, `XUSGHalton.h:8-13`, consumed by
`ObjectRenderer::UpdateFrame`, `ObjectRenderer.cpp:192-197`):
jitter = (halton2(i), halton3(i)) * 2 - 1, divided by the viewport. The
frame index is a host integer here, so the jitter is host arithmetic.
"""

from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> float:
    """Radical inverse of `index` in `base`."""
    f, r = 1.0, 0.0
    i = int(index)
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton23(index: int) -> tuple[float, float]:
    return halton(index, 2), halton(index, 3)


def halton_jitter(frame_idx: int, viewport_w: float,
                  viewport_h: float) -> np.ndarray:
    """(2,) f32 projection-space jitter of frame `frame_idx`: the period-64
    table of the JAX package, index 1-based (IncrementalHalton advances
    before its first use), in f32 as the JAX table is."""
    h = np.array(halton23(int(frame_idx) % 64 + 1), np.float32)
    scale = np.array([1.0 / viewport_w, 1.0 / viewport_h], np.float32)
    return (h * np.float32(2.0) - np.float32(1.0)) * scale
