"""Per-volume visibility culling, face masks, LOD and scheme selection.

Counterpart of `multivolumes_tpu/render/cull.py` (the `CSVolumeCull`
kernel, `CSVolumeCull.hlsl:13-78` + `VolumeCull.hlsli`) as batched tensor
math over the volume axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.render.perframe import PerObject
from multivolumes_tpu_torch.utils import timing

# cube corner i = (x: i&1, y: (i>>1)&1, z: i>>2) in {-1, +1}
_CORNERS = np.array(
    [[(i & 1) * 2 - 1, ((i >> 1) & 1) * 2 - 1, (i >> 2) * 2 - 1]
     for i in range(8)], np.float32)
# the 12 unique cube edges as corner-index pairs (`VolumeCull.hlsli:119-138`)
_EDGES = np.array(
    [(0, 1), (3, 2), (1, 3), (2, 0), (6, 7), (5, 4),
     (4, 6), (7, 5), (4, 0), (2, 6), (7, 3), (1, 5)], np.int64)
# per-face corner loops; face order +X,-X,+Y,-Y,+Z,-Z
_FACE_LOOPS = np.array(
    [[1, 3, 7, 5], [0, 2, 6, 4], [2, 3, 7, 6],
     [0, 1, 5, 4], [4, 5, 7, 6], [0, 1, 3, 2]], np.int64)


class CullResult(NamedTuple):
    visible: torch.Tensor        # (N,) bool
    mip_level: torch.Tensor      # (N,) int32
    smp_count: torch.Tensor      # (N,) int32 clamped ray sample count
    face_mask: torch.Tensor      # (N, 6) bool
    use_cube_map: torch.Tensor   # (N,) bool
    max_edge_px: torch.Tensor    # (N,) float32

    def take(self, idx) -> "CullResult":
        """Rows `idx` of every field."""
        return CullResult(*(x[idx] for x in self))


def project_corners(world_view_proj, viewport):
    """All 8 corners to viewport space: (N,4,4),(2,) -> (N,8,3) xy px + z."""
    corners = timing.host_read("cull.corners", lambda: torch.from_numpy(
        _CORNERS).to(world_view_proj.device))
    h = math3d.transform_point(corners[None], world_view_proj[:, None])
    ndc = h[..., :3] / h[..., 3:4]
    xy = ndc[..., :2] * 0.5 + 0.5
    xy = torch.stack([xy[..., 0], 1.0 - xy[..., 1]], dim=-1)
    return torch.cat([xy * viewport, ndc[..., 2:3]], dim=-1)


def cull_volumes(per_object: PerObject, eye, viewport,
                 num_samples: int, cube_map_size: int, num_mips: int,
                 adaptive: bool = True, upscale: float = 2.0,
                 ray_sample_count_scale: float = 2.0) -> CullResult:
    """Batched CSVolumeCull. viewport: (2,) float (w, h) in pixels."""
    dev = per_object.world.device
    viewport = timing.host_read("cull.viewport", lambda: torch.as_tensor(
        viewport, dtype=torch.float32, device=dev))
    v = project_corners(per_object.world_view_proj, viewport)  # (N,8,3)

    in_view = (((v[..., :2] >= 0.0) & (v[..., :2] <= viewport)).all(-1)
               & (v[..., 2] > 0.0) & (v[..., 2] < 1.0))
    visible = in_view.any(-1)

    eye_local = math3d.transform_point3(eye, per_object.world_i)  # (N,3)
    pos_vis = eye_local < 1.0
    neg_vis = eye_local > -1.0
    face_mask = torch.stack(
        [pos_vis[:, 0], neg_vis[:, 0], pos_vis[:, 1],
         neg_vis[:, 1], pos_vis[:, 2], neg_vis[:, 2]], dim=-1)

    xy = v[..., :2]
    # each host index array is an upload that waits for the stream
    e = (timing.host_read("cull.edges", lambda: xy[:, _EDGES[:, 1]])
         - timing.host_read("cull.edges", lambda: xy[:, _EDGES[:, 0]]))
    max_edge = torch.linalg.norm(e, dim=-1).amax(-1)

    # LOD estimate (`EstimateCubeMapLOD`, `VolumeCull.hlsli:267-294`)
    s = max_edge / upscale
    ray_sample_amt = ray_sample_count_scale * s / math.sqrt(3.0)
    smp_count = torch.clamp(torch.ceil(ray_sample_amt).int(), max=num_samples)
    ray_sample_amt = torch.minimum(ray_sample_amt, smp_count.float())
    s_clamped = ray_sample_amt / ray_sample_count_scale * math.sqrt(3.0)
    level = torch.clamp(
        torch.log2(cube_map_size / torch.clamp(s_clamped, min=1e-6)),
        min=0.0).int()
    mip_level = torch.clamp(level, max=num_mips - 1)

    # projected coverage: visible-face quad areas
    loops = timing.host_read("cull.face_loops",
                             lambda: xy[:, _FACE_LOOPS])   # (N,6,4,2)
    e0 = loops[:, :, 1] - loops[:, :, 0]
    e1 = loops[:, :, 2] - loops[:, :, 1]
    e2 = loops[:, :, 3] - loops[:, :, 2]
    e3 = loops[:, :, 0] - loops[:, :, 3]
    area = 0.5 * _det2(e0, e1).abs() + 0.5 * _det2(e2, e3).abs()
    proj_cov = torch.where(face_mask, area, 0.0).sum(-1)

    if adaptive:
        edge_px = cube_map_size >> torch.clamp(mip_level, max=num_mips - 1)
        cube_map_pix = ((edge_px * edge_px).float()
                        * face_mask.sum(-1).float())
        use_cube_map = cube_map_pix <= proj_cov
    else:
        use_cube_map = torch.ones_like(visible)

    return CullResult(
        visible=visible,
        mip_level=mip_level,
        smp_count=smp_count,
        face_mask=face_mask & visible[:, None],
        use_cube_map=use_cube_map & visible,
        max_edge_px=max_edge,
    )


def _det2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
