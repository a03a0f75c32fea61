"""Scene and frame state as a dataclass of tensors.

Counterpart of `multivolumes_tpu/scene/state.py`, TAA history and the
opaque mesh included. Differences from the JAX state, each deliberate:

* no oriented 3-variant stacks. The sweep kernel folds the per-face
  orientation (a permutation plus flips, `sweep.FACE_VARIANT` /
  `FACE_FLIPS`) into its addressing, so it reads the plain channel-last
  stacks: `volumes_sweep` (N_src, D, H, W, 4) and `light_sweep`
  (N, L, L, L, 4) in the sweep dtype, the light's 4th channel zero so a
  texel is one aligned load. `vol_zmax` is computed per axis from the
  plain stack;
* no `mesh_shadow_quads`: that quad-packed copy of the shadow map is a
  TPU gather layout; the port's PCF reads its four taps directly;
* `frame_idx` is a Python int (the cohort ids are host arithmetic), and
  the frame updates the light stacks in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mvbench.reference.config import RenderConfig
from mvbench.reference.core import math3d, sh as sh_lib


@dataclasses.dataclass
class SceneState:
    frame_idx: int
    volumes: torch.Tensor        # (N_src, D, H, W, 4) f32 density sources
    volumes_sweep: torch.Tensor  # (N_src, D, H, W, 4) sweep dtype
    vol_zmax: torch.Tensor       # (N_src, 3, D) per-slab max density along
                                 # each sweep variant's leading axis
    vol_tex_ids: torch.Tensor    # (N,) int64 source id per volume
    volume_worlds: torch.Tensor  # (N, 4, 4) row-vector world transforms
    light_maps: torch.Tensor     # (N, 3, L, L, L) f32
    light_sweep: torch.Tensor    # (N, L, L, L, 4) sweep dtype, channel 3 = 0
    light_sout: torch.Tensor     # (N, L, L) cached outgoing transmittance
    sh_coeffs: torch.Tensor      # (9, 3)
    radiance: torch.Tensor       # (6, R, R, 3) environment cube
    light_pos: torch.Tensor      # (4,) xyz + 1
    light_color: torch.Tensor    # (4,) rgb + intensity
    ambient: torch.Tensor        # (4,) rgb + intensity
    rho_light: torch.Tensor      # (N_src, L, L, L)
    ao_static: torch.Tensor      # (N_src, L, L, L)
    grad_dir: torch.Tensor       # (N_src, 3, L, L, L)
    taa_history: torch.Tensor    # (4, H, W) f32 resolved colour + history
                                 # metadata (channel 3)
    mesh_verts: torch.Tensor     # (V, 6) f32 position + normal
    mesh_indices: torch.Tensor   # (T, 3) int64; one placeholder triangle
                                 # when no mesh is loaded
    mesh_world: torch.Tensor     # (4, 4) from config.mesh_pos_scale
    mesh_prev_wvp: torch.Tensor  # (4, 4) last frame's world-view-proj
    mesh_shadow_map: torch.Tensor  # (Sm, Sm) light-view clip z, 1 = empty
    scene_size: torch.Tensor     # () mesh extent x scale (shadow ortho)

    @property
    def num_volumes(self) -> int:
        return self.volume_worlds.shape[0]


def sweep_dtype(config: RenderConfig) -> torch.dtype:
    return torch.bfloat16 if config.use_bf16 else torch.float32


def volume_grid_worlds(num_volumes: int, size: float, center) -> np.ndarray:
    """Grid layout of volume world matrices (`SetVolumesWorld`,
    `MultiRayCaster.cpp:277-303`): ceil(sqrt(N)) columns spaced 1.5*size
    in xz, each world = scale(size/2) * translate(pos)."""
    if num_volumes < 1:
        raise ValueError("num_volumes must be >= 1")
    center = np.asarray(center, np.float32)
    row_length = int(np.ceil(np.sqrt(float(num_volumes))))
    col_length = int(np.ceil(num_volumes / row_length))
    worlds = np.zeros((num_volumes, 4, 4), np.float32)
    half = size * 0.5
    pos_z = center[2] - (col_length / 2.0 - 0.5) * size * 1.5
    idx = 0
    for _m in range(col_length):
        pos_x = center[0] - (row_length / 2.0 - 0.5) * size * 1.5
        for _n in range(row_length):
            if idx < num_volumes:
                w = np.eye(4, dtype=np.float32)
                w[0, 0] = w[1, 1] = w[2, 2] = half
                w[3, :3] = (pos_x, center[1], pos_z)
                worlds[idx] = w
            idx += 1
            pos_x += size * 1.5
        pos_z += size * 1.5
    return worlds


def default_radiance(size: int = 64) -> np.ndarray:
    """Procedural sky radiance cube (sun + horizon gradient) standing in
    for the reference's `LA_Radiance.dds`."""
    dirs = sh_lib.cube_face_dirs(size)
    sun_dir = np.array([0.577, 0.577, -0.577], np.float32)
    cos_sun = np.clip(np.einsum("fuvc,c->fuv", dirs, sun_dir), 0.0, 1.0)
    sun = (cos_sun ** 64)[..., None] * np.array([8.0, 6.0, 4.0], np.float32)
    horiz = np.clip(dirs[..., 1:2] * 0.5 + 0.5, 0.0, 1.0)
    sky = (1.0 - horiz) * np.array([0.25, 0.2, 0.15], np.float32) \
        + horiz * np.array([0.4, 0.6, 1.0], np.float32)
    return (sky + sun).astype(np.float32)


def slab_density_max(vols_sweep) -> torch.Tensor:
    """(N_src, D, H, W, 4) -> (N_src, 3, D): the max density of each slab
    of the three sweep variants (variant 0 slabs along z, 1 along x, 2
    along y; see sweep.FACE_VARIANT). Drives the sweep kernel's exact
    transparent-slab skip."""
    a = vols_sweep[..., 3].float()
    return torch.stack([a.amax(dim=(2, 3)), a.amax(dim=(1, 2)),
                        a.amax(dim=(1, 3))], dim=1)


def to_light_sweep(maps, dtype) -> torch.Tensor:
    """(C, 3, L, L, L) light maps -> (C, L, L, L, 4) sweep stack rows."""
    m = maps.movedim(1, -1)
    return torch.cat([m, torch.zeros_like(m[..., :1])], dim=-1).to(dtype)


def mesh_world_matrix(config: RenderConfig, device=None) -> torch.Tensor:
    """scale(s) @ translate(x, y, z) of `config.mesh_pos_scale`."""
    mx, my, mz, ms = config.mesh_pos_scale
    return math3d.scaling(ms, device) @ math3d.translation(
        [mx, my, mz], device)


