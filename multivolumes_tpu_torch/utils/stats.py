"""Per-frame render statistics from the cull result.

Counterpart of `multivolumes_tpu/utils/stats.py`: the reference computes
its visibility lists and LOD decisions on the GPU and never reads them
back (its only metric is the FPS in the window title,
`MultiVolumes.cpp:766-812`); here the cull result is a tuple of tensors,
so the app's `--stats` line is a few reductions and one host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrameStats(NamedTuple):
    num_volumes: torch.Tensor    # ()
    visible: torch.Tensor        # () volumes passing viewport culling
    cube_path: torch.Tensor      # () volumes on the cube-map scheme
    pixel_path: torch.Tensor     # () volumes on the per-pixel scheme
    visible_faces: torch.Tensor  # () total marched faces
    mip_histogram: torch.Tensor  # (8,) visible volumes per mip level
    mean_samples: torch.Tensor   # () mean clamped ray sample count
    max_edge_px: torch.Tensor    # () largest projected cube edge


def frame_stats(cull) -> FrameStats:
    vis = cull.visible
    dev = vis.device
    visible = vis.long().sum()
    cube = (vis & cull.use_cube_map).long().sum()
    mips = torch.zeros((8,), dtype=torch.long, device=dev)
    mips.index_add_(0, torch.clamp(cull.mip_level.long(), 0, 7), vis.long())
    return FrameStats(
        num_volumes=torch.tensor(vis.shape[0], device=dev),
        visible=visible,
        cube_path=cube,
        pixel_path=visible - cube,
        visible_faces=cull.face_mask.long().sum(),
        mip_histogram=mips,
        mean_samples=torch.where(vis, cull.smp_count, 0).float().mean(),
        max_edge_px=torch.where(vis, cull.max_edge_px, 0.0).max(),
    )


def format_stats(stats: FrameStats) -> str:
    s = FrameStats(*(x.cpu() for x in stats))
    return (
        f"volumes {int(s.visible)}/{int(s.num_volumes)} visible, "
        f"{int(s.cube_path)} cube-map / {int(s.pixel_path)} per-pixel, "
        f"{int(s.visible_faces)} faces, "
        f"mips {s.mip_histogram[:5].tolist()}, "
        f"mean samples {float(s.mean_samples):.1f}, "
        f"max edge {float(s.max_edge_px):.0f} px"
    )
