"""Camera state and the per-frame matrix bundle.

Counterpart of `multivolumes_tpu/core/camera.py`: initial eye (4, 16, -80)
looking at the origin, perspective fov pi/4 with zNear 1 / zFar 1000, and
the orbit animation `eye = (sin(t/2)*60, 6, cos(t/2)*60)`, and
`band_camera`, the off-centre projection of one row band of a frame. The
cameras are made on the card unless `device` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from mvbench.reference.core import math3d


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: torch.Tensor    # (3,)
    view: torch.Tensor   # (4, 4) row-vector view matrix
    proj: torch.Tensor   # (4, 4)

    @property
    def view_proj(self) -> torch.Tensor:
        return self.view @ self.proj

    @property
    def screen_to_world(self) -> torch.Tensor:
        """Inverse of viewProj — `g_screenToWorld` in cbPerFrame."""
        return math3d.inverse(self.view_proj)


