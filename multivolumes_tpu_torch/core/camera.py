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

from multivolumes_tpu_torch.config import SharedConsts
from multivolumes_tpu_torch.core import math3d


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


def make_camera(eye, focus, aspect: float,
                fov_y: float = SharedConsts.FOV_ANGLE_Y,
                z_near: float = SharedConsts.Z_NEAR,
                z_far: float = SharedConsts.Z_FAR, device="cuda") -> Camera:
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    view = math3d.look_at_lh(eye, focus, [0.0, 1.0, 0.0])
    proj = math3d.perspective_fov_lh(fov_y, aspect, z_near, z_far,
                                     device=eye.device)
    return Camera(eye=eye, view=view, proj=proj)


def band_camera(camera: Camera, k: int, bands: int) -> Camera:
    """Off-centre projection for horizontal row band k of `bands`: a frame
    rendered at height H / bands with this camera holds rows [k H / bands,
    (k + 1) H / bands) of the full frame, at the same pixel centres. The
    projection is post-multiplied by a clip-space y scale and offset,
    y' = s y + (1 - s + 2 k) w with s = bands, so band row j lands on the
    NDC y of full-frame row k H / bands + j."""
    s = float(bands)
    band = torch.tensor(
        [[1.0, 0.0, 0.0, 0.0],
         [0.0, s, 0.0, 0.0],
         [0.0, 0.0, 1.0, 0.0],
         [0.0, 1.0 - s + 2.0 * k, 0.0, 1.0]], dtype=torch.float32,
        device=camera.proj.device)
    return Camera(eye=camera.eye, view=camera.view, proj=camera.proj @ band)


def default_camera(aspect: float, device="cuda") -> Camera:
    """Start pose from `MultiVolumes.cpp:273-278`."""
    return make_camera([4.0, 16.0, -80.0], [0.0, 0.0, 0.0], aspect,
                       device=device)


def orbit_camera(time_s: float, aspect: float, device="cuda") -> Camera:
    """Auto-animation pose from `MultiVolumes.cpp:328-337`."""
    t = torch.tensor(time_s, dtype=torch.float32) * 0.5
    r = 60.0
    eye = torch.stack([torch.sin(t) * r, torch.tensor(6.0),
                       torch.cos(t) * r]).to(device)
    return make_camera(eye, [0.0, 0.0, 0.0], aspect, device=device)
