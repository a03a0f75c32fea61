"""The reference scene: the engine's set-up worked out again.

A frozen copy of what `MultiRayCaster` does at set-up on the path the
benchmark drives (`MultiRayCaster(cfg)`, `load_volume_data` of every
source, `set_mesh`, the [m] toggle), and of its per-frame raster-preset
pick, written against the frozen modules of this package. It starts from
the benchmark's own inputs (the seeded R32F densities, the OBJ file, the
cameras) and takes nothing the program made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mvbench.reference.config import RenderConfig
from mvbench.reference.core import sh as sh_lib
from mvbench.reference.precision import EXACT
from mvbench.reference.render import lightsweep
from mvbench.reference.render import mesh as mesh_lib
from mvbench.reference.render.perframe import build_per_object
from mvbench.reference.scene import io_obj
from mvbench.reference.scene import state as state_lib


def r32f_to_rgba(density, device) -> torch.Tensor:
    """An R32F density grid (D, H, W) -> the engine's RGBA layout
    (`CSR32FToRGBA16F.hlsl:16-26`): white albedo, alpha = density / 4."""
    density = torch.as_tensor(np.asarray(density, np.float32),
                              device=device)
    return torch.cat([torch.ones(density.shape + (3,), device=device),
                      density[..., None] * 0.25], dim=-1)


@dataclasses.dataclass
class Scene:
    state: state_lib.SceneState
    config: RenderConfig
    mesh_aabb: np.ndarray | None   # world AABB (2, 3) of the mesh, host


def light_refresh(state, config, shadow: bool, prec=EXACT):
    """Full light-map refresh of every volume, shadowed by the mesh when
    `shadow` -> the state with new maps, stacks and footprints."""
    po = build_per_object(state.volume_worlds, torch.eye(
        4, dtype=torch.float32, device=state.volume_worlds.device))
    maps, sout = lightsweep.ray_march_light_sweep_update(
        state.rho_light, state.ao_static, state.grad_dir, state.vol_tex_ids,
        po, state.light_pos, state.light_color, state.ambient,
        state.sh_coeffs, config.max_light_samples, config.light_axis,
        has_light_probe=config.has_light_probe,
        shadow_map=state.mesh_shadow_map if shadow else None,
        shadow_vp=mesh_lib.shadow_view_proj(state) if shadow else None)
    maps = prec.f32(maps)
    return dataclasses.replace(
        state, light_maps=maps,
        light_sweep=prec.stack(state_lib.to_light_sweep(
            maps, state_lib.sweep_dtype(config))),
        light_sout=sout)


def build_scene(config: RenderConfig, densities, mesh_path, show_mesh: bool,
                device, prec=EXACT) -> Scene:
    """The state after set-up: every source loaded from `densities`
    (N_src R32F grids), the light sweep axis baked, then, with a
    `mesh_path`, the mesh placed, its far ladder derived, its shadow map
    drawn and the light refreshed under it; `show_mesh` is the [m]
    toggle after that."""
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    n = config.num_volumes
    sdt = state_lib.sweep_dtype(config)
    vols = torch.stack([r32f_to_rgba(d, device) for d in densities])
    vols_sweep = prec.stack(vols.to(sdt))
    cx, cy, cz, size = config.vol_pos_scale
    worlds = torch.from_numpy(state_lib.volume_grid_worlds(
        n, size, (cx, cy, cz))).to(device)
    radiance = torch.from_numpy(state_lib.default_radiance(64)).to(device)
    rho_light, ao_static, grad_dir = lightsweep.precompute_static(
        vols, config.light_grid_size, config.max_light_samples)
    light_pos = torch.tensor([75.0, 75.0, -75.0, 1.0], **f32)
    config = config.with_(light_axis=lightsweep.light_axis(light_pos))
    lgs = config.light_grid_size
    state = state_lib.SceneState(
        frame_idx=0, volumes=vols, volumes_sweep=vols_sweep,
        vol_zmax=state_lib.slab_density_max(vols_sweep),
        vol_tex_ids=torch.arange(n, device=device) % config.num_volume_srcs,
        volume_worlds=worlds,
        light_maps=torch.zeros((n, 3, lgs, lgs, lgs), **f32),
        light_sweep=torch.zeros((n, lgs, lgs, lgs, 4), dtype=sdt,
                                device=device),
        light_sout=torch.zeros((n, lgs, lgs), **f32),
        sh_coeffs=sh_lib.project_cube_map(radiance), radiance=radiance,
        light_pos=light_pos,
        light_color=torch.tensor([1.0, 0.7, 0.3, 3.0 * np.pi], **f32),
        ambient=torch.tensor([0.4, 0.6, 1.0, 2.0 * np.pi], **f32),
        rho_light=rho_light, ao_static=ao_static, grad_dir=grad_dir,
        taa_history=torch.zeros((4, config.height, config.width), **f32),
        mesh_verts=torch.zeros((3, 6), **f32),
        mesh_indices=torch.zeros((1, 3), dtype=torch.int64, device=device),
        mesh_world=state_lib.mesh_world_matrix(config, device),
        mesh_prev_wvp=torch.eye(4, **f32),
        mesh_shadow_map=torch.ones((config.shadow_map_size,) * 2, **f32),
        scene_size=torch.tensor(1.0, **f32))
    aabb = None
    if mesh_path is not None:
        mesh = io_obj.load_obj(mesh_path)
        mx, my, mz, ms = config.mesh_pos_scale
        state = dataclasses.replace(
            state, mesh_verts=torch.as_tensor(mesh.vertices, **f32),
            mesh_indices=torch.from_numpy(
                np.asarray(mesh.indices, np.int64)).to(device),
            scene_size=torch.tensor(mesh.scene_size * ms, **f32))
        verts = np.asarray(mesh.vertices, np.float32)[:, :3] * ms \
            + np.asarray([mx, my, mz], np.float32)
        aabb = np.stack([verts.min(0), verts.max(0)])
        ladder = mesh_lib.derive_far_tiers(
            mesh.vertices, mesh.indices, state.mesh_world.cpu().numpy(),
            config.width, config.height, config.raster_far_bound)
        far_tiers, far_small = ladder if ladder else (None, None)
        config = config.with_(show_mesh=True, raster_far_tiers=far_tiers,
                              raster_far_small=far_small)
        state = dataclasses.replace(
            state, mesh_shadow_map=mesh_lib.render_shadow_map(state, config))
    state = light_refresh(state, config, mesh_path is not None, prec)
    config = config.with_(show_mesh=mesh_path is not None and show_mesh)
    return Scene(state, config, aabb)


def raster_preset(config: RenderConfig, aabb, eye, preset: str) -> str:
    """The engine's per-frame pick of the mesh raster's tier ladder from
    the host-side eye (`select_raster_preset`): "far" once the mesh's
    projected bbox is within raster_far_bound, back to "near" above 1.05
    times it."""
    if aabb is None or not config.show_mesh or not config.raster_far_tiers:
        return preset
    e = mesh_lib.projected_size_px(aabb, eye, (0.0, 0.0, 0.0),
                                   config.width, config.height)
    bound = float(config.raster_far_bound)
    if preset == "far":
        return "near" if e > bound * 1.05 else preset
    return "far" if e <= bound else preset
