"""Per-frame constant data: the PerObject matrix bundle.

Counterpart of `multivolumes_tpu/render/perframe.py`
(`MultiRayCaster::UpdateFrame`, `MultiRayCaster.cpp:316-353`): per volume
{WorldViewProj, WorldViewProjI, WorldI, World}, row-vector convention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multivolumes_tpu_torch.core import math3d


class PerObject(NamedTuple):
    world_view_proj: torch.Tensor    # (N, 4, 4)
    world_view_proj_i: torch.Tensor  # (N, 4, 4)
    world_i: torch.Tensor            # (N, 4, 4)
    world: torch.Tensor              # (N, 4, 4)

    def take(self, idx) -> "PerObject":
        """Rows `idx` of every field."""
        return PerObject(*(x[idx] for x in self))


def build_per_object(volume_worlds, view_proj) -> PerObject:
    """(N,4,4), (4,4) -> PerObject."""
    wvp = volume_worlds @ view_proj
    return PerObject(wvp, math3d.inverse(wvp), math3d.inverse(volume_worlds),
                     volume_worlds)
