"""Engine facade: the `MultiRayCaster`-shaped public API.

Counterpart of `multivolumes_tpu/engine.py`, over the reference's
component interfaces (`Content/MultiRayCaster.h:31-50`,
`ObjectRenderer.h`, `LightProbe.h`): the engine owns its scene state and
device (the card unless told otherwise), bakes the light-sweep axis from
the light direction, renders frames one at a time (`render`) or K at a
time (`render_block`), both with TAA by default, and takes the
reference's setters for volumes, worlds, samples, the light, the
ambient, the radiance and the opaque mesh (`set_mesh`). Each setter
rebuilds the state fields that depend on what it set; with a mesh, the
light refreshes the shadow map first. `select_raster_preset` picks the
mesh raster's tier ladder for the next frame from a host-side camera
pose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as camera_lib
from multivolumes_tpu_torch.core import math3d, sh as sh_lib
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import lightsweep
from multivolumes_tpu_torch.render import mesh as mesh_lib
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene import io_obj
from multivolumes_tpu_torch.scene import state as state_lib
from multivolumes_tpu_torch.scene import volume as volume_lib


class MultiRayCaster:
    """Volume-rendering engine with the reference's host API."""

    def __init__(self, config: RenderConfig, device="cuda"):
        self.device = torch.device(device)
        frame_lib.check_supported(config)
        self.config = config
        self.state = state_lib.create_scene(config, self.device)
        self._mesh_aabb = None        # world AABB (2, 3) of the mesh, host
        self._set_light_axis()

    @property
    def has_mesh(self) -> bool:
        return self.state.mesh_indices.shape[0] > 1

    def _set_light_axis(self) -> None:
        """Bake the shear-warp sweep axis (argmax |light dir|) into the
        config: the light is a host-side scene setting. The reference
        light march has no sweep axis."""
        if self.config.light_mode != "sweep":
            return
        self.config = self.config.with_(
            light_axis=lightsweep.light_axis(self.state.light_pos))

    def _f32(self, x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, np.float32)).to(self.device)

    # --- MultiRayCaster API (`MultiRayCaster.h:31-50`) -------------------

    def load_volume_data(self, i: int, density) -> None:
        """R32F density grid -> volume source i (`LoadVolumeData`,
        `MultiRayCaster.cpp:168-209`)."""
        self._set_volume(i, volume_lib.r32f_to_rgba(density, self.device))

    def load_volume_file(self, i: int, path: str) -> None:
        """DDS R32F volume file -> volume source i (`MultiRayCaster.cpp:
        168-209`: DDS::Loader parse + `CSR32FToRGBA16F` convert)."""
        from multivolumes_tpu_torch.scene import io_dds

        tex = io_dds.load_dds(path)
        if not tex.is_volume or tex.data.shape[-1] != 1:
            raise ValueError(f"{path}: not an R32F volume DDS")
        self.load_volume_data(i, tex.data[..., 0])

    def set_radiance_file(self, path: str) -> None:
        """DDS radiance cube -> environment + SH projection
        (`LightProbe::Init`, `LightProbe.cpp:29-61`)."""
        from multivolumes_tpu_torch.scene import io_dds

        tex = io_dds.load_dds(path)
        if not tex.is_cube:
            raise ValueError(f"{path}: not a cube-map DDS")
        self.set_radiance(np.asarray(tex.data, np.float32)[..., :3])

    def init_volume_data(self, i: int) -> None:
        """Procedural volume (`InitVolumeData`, `MultiRayCaster.cpp:
        243-264`)."""
        self._set_volume(i, self._f32(volume_lib.init_grid_data(
            self.config.grid_size)))

    def _set_volume(self, i: int, vol: torch.Tensor) -> None:
        """Replace source i and rebuild what derives from the sources: the
        sweep-dtype stack, its slab maxima, the static light fields and
        the light maps."""
        cfg = self.config
        volumes = self.state.volumes.clone()
        volumes[i] = vol
        vols_sweep = volumes.to(state_lib.sweep_dtype(cfg))
        rho, ao, gd = lightsweep.precompute_static(
            volumes, cfg.light_grid_size, cfg.max_light_samples)
        self.state = dataclasses.replace(
            self.state, volumes=volumes, volumes_sweep=vols_sweep,
            vol_zmax=state_lib.slab_density_max(vols_sweep),
            rho_light=rho, ao_static=ao, grad_dir=gd)
        self._refresh_light_cache()

    def _refresh_light_cache(self) -> None:
        """Full light-map refresh (all volumes) after a setter that
        invalidates the per-frame cohort state: density upload, a light,
        ambient or SH change, or a new mesh shadow map. The cached outgoing
        footprints (`light_sout`) depend on density, light direction and
        scale, so world moves alone do not need this. A loaded mesh
        shadows the maps (whether or not it is shown, as the JAX engine
        does). The reference light march refreshes one volume a frame and
        has no cache: nothing to do there."""
        if self.config.light_mode != "sweep":
            return
        st, cfg = self.state, self.config
        po = build_per_object(st.volume_worlds, torch.eye(
            4, dtype=torch.float32, device=self.device))
        maps, sout = lightsweep.ray_march_light_sweep_update(
            st.rho_light, st.ao_static, st.grad_dir, st.vol_tex_ids, po,
            st.light_pos, st.light_color, st.ambient, st.sh_coeffs,
            cfg.max_light_samples, cfg.light_axis,
            has_light_probe=cfg.has_light_probe,
            shadow_map=st.mesh_shadow_map if self.has_mesh else None,
            shadow_vp=mesh_lib.shadow_view_proj(st) if self.has_mesh
            else None)
        self.state = dataclasses.replace(
            st, light_maps=maps,
            light_sweep=state_lib.to_light_sweep(maps, st.light_sweep.dtype),
            light_sout=sout)

    def set_volumes_world(self, size: float, center) -> None:
        worlds = state_lib.volume_grid_worlds(self.config.num_volumes, size,
                                              center)
        self._check_worlds(worlds)
        self.state = dataclasses.replace(self.state,
                                         volume_worlds=self._f32(worlds))

    def _check_worlds(self, worlds) -> None:
        """The shear-warp light sweep (`render/lightsweep.py`) assumes
        uniform-scale, rotation-free volume worlds (it reads world[0, 0]
        as the scale); rotated or anisotropic worlds would shadow wrong,
        so they are refused there. The reference light march takes any
        world."""
        if self.config.light_mode != "sweep":
            return
        w = np.asarray(worlds, np.float32).reshape(-1, 4, 4)
        upper = w[:, :3, :3]
        s = upper[:, 0, 0]
        expect = s[:, None, None] * np.eye(3, dtype=np.float32)
        if not np.allclose(upper, expect, atol=1e-5 * np.abs(s).max()):
            raise ValueError(
                "light_mode='sweep' requires uniform-scale, unrotated "
                "volume worlds; use light_mode='reference' for rotated or "
                "anisotropic volumes (see render/lightsweep.py)")

    def set_volume_world(self, i: int, size: float, pos,
                         rotation_y: float = 0.0) -> None:
        """World of volume i: scale(size / 2), then a rotation of
        `rotation_y` radians about y (light_mode "reference" only), then
        the translation to `pos`."""
        w = math3d.scaling(size * 0.5, self.device)
        if rotation_y:
            w = w @ math3d.rotation_y(rotation_y, self.device)
        w = w @ math3d.translation(np.asarray(pos, np.float32), self.device)
        self._check_worlds(w.cpu().numpy()[None])
        worlds = self.state.volume_worlds.clone()
        worlds[i] = w
        self.state = dataclasses.replace(self.state, volume_worlds=worlds)

    def set_max_samples(self, max_ray_samples: int,
                        max_light_samples: int) -> None:
        self.config = self.config.with_(max_ray_samples=max_ray_samples,
                                        max_light_samples=max_light_samples)

    def set_light(self, pos, color, intensity: float) -> None:
        self.state = dataclasses.replace(
            self.state, light_pos=self._f32([*pos, 1.0]),
            light_color=self._f32([*color, intensity]))
        self._set_light_axis()
        self._refresh_shadow_map()
        self._refresh_light_cache()

    def _refresh_shadow_map(self) -> None:
        """Re-rasterize the cached light-view shadow map (the reference
        renders it every frame; mesh, light and world are static between
        setter calls here)."""
        if self.has_mesh:
            self.state = dataclasses.replace(
                self.state, mesh_shadow_map=mesh_lib.render_shadow_map(
                    self.state, self.config))

    def set_ambient(self, color, intensity: float) -> None:
        self.state = dataclasses.replace(
            self.state, ambient=self._f32([*color, intensity]))
        self._refresh_light_cache()

    def set_sh(self, sh_coeffs) -> None:
        self.state = dataclasses.replace(self.state,
                                         sh_coeffs=self._f32(sh_coeffs))
        self._refresh_light_cache()

    def set_radiance(self, radiance) -> None:
        """Radiance environment + SH projection (`LightProbe::
        TransformSH`)."""
        radiance = self._f32(radiance)
        self.state = dataclasses.replace(
            self.state, radiance=radiance,
            sh_coeffs=sh_lib.project_cube_map(radiance))
        self._refresh_light_cache()

    def set_mesh(self, path: str) -> None:
        """OBJ mesh + world placement (`ObjectRenderer::Init`): loads the
        file, places it by `config.mesh_pos_scale`, derives the far tier
        ladder on the host, shows it, and refreshes the shadow map and
        then the light maps."""
        mesh = io_obj.load_obj(path)
        mx, my, mz, ms = self.config.mesh_pos_scale
        self.state = dataclasses.replace(
            self.state,
            mesh_verts=self._f32(mesh.vertices),
            mesh_indices=torch.from_numpy(
                np.asarray(mesh.indices, np.int64)).to(self.device),
            mesh_world=state_lib.mesh_world_matrix(self.config, self.device),
            scene_size=self._f32(mesh.scene_size * ms))
        # host-side copies for the per-frame raster-preset pick: the world
        # AABB and the mesh's own far ladder
        verts_np = np.asarray(mesh.vertices, np.float32)[:, :3] * ms \
            + np.asarray([mx, my, mz], np.float32)
        self._mesh_aabb = np.stack([verts_np.min(0), verts_np.max(0)])
        ladder = mesh_lib.derive_far_tiers(
            mesh.vertices, mesh.indices,
            self.state.mesh_world.cpu().numpy(), self.config.width,
            self.config.height, self.config.raster_far_bound)
        far_tiers, far_small = ladder if ladder else (None, None)
        self.config = self.config.with_(show_mesh=True,
                                        raster_far_tiers=far_tiers,
                                        raster_far_small=far_small)
        self._refresh_shadow_map()
        self._refresh_light_cache()

    def select_raster_preset(self, eye, focus=(0.0, 0.0, 0.0)) -> str:
        """Pick the mesh raster's tier ladder for the next frame from a
        host-side camera pose (floats or numpy, never a device tensor):
        "far" once the mesh's projected bbox is within raster_far_bound,
        back to "near" above 1.05 times it (the hysteresis keeps an
        orbiting camera from flipping). Returns the preset."""
        cfg = self.config
        if (self._mesh_aabb is None or not cfg.show_mesh
                or not cfg.raster_far_tiers):
            return cfg.raster_preset
        e = mesh_lib.projected_size_px(self._mesh_aabb, eye, focus,
                                       cfg.width, cfg.height)
        bound = float(cfg.raster_far_bound)
        preset = cfg.raster_preset
        if preset == "far":
            if e > bound * 1.05:
                preset = "near"
        elif e <= bound:
            preset = "far"
        if preset != cfg.raster_preset:
            self.config = cfg.with_(raster_preset=preset)
        return preset

    # --- frame loop -------------------------------------------------------

    def render(self, camera: Optional[camera_lib.Camera] = None,
               use_taa: bool = True) -> torch.Tensor:
        """Render one frame, advancing the engine state. Returns the
        display-mapped (H, W, 3) image on the engine's device."""
        if camera is None:
            camera = camera_lib.default_camera(self.config.aspect_ratio,
                                               device=self.device)
        out = frame_lib.render_frame(self.state, camera, self.config,
                                     use_taa=use_taa)
        self.state = out.state
        return out.image

    def render_block(self, cameras: Sequence[camera_lib.Camera],
                     use_taa: bool = True) -> torch.Tensor:
        """Render one frame per camera (`render_frames`), advancing the
        engine state. Returns planar (K, 3, H, W) display images."""
        images, self.state = frame_lib.render_frames(
            self.state, cameras, self.config, use_taa=use_taa)
        return images
