"""The reference frame: `(state, camera) -> (image, hdr, state)`.

A frozen copy of the port's main-path frame (`render/frame.py:
render_frame` of `multivolumes_tpu_torch` at the commit this benchmark
was written against), one device, plain versions only:

    prep (per-object matrices, cull/LOD) -> mesh (raster, deferred shade)
    -> light (cohort refresh) -> sweep (LOD cube-map march) -> sky ->
    composite (tile OIT) -> tail (background blend) -> taa -> tone map

Only the settings the benchmark's configurations use are kept: the
plane sweep with LOD buckets, the shear-warp light sweep, the tile
composite. Anything else raises.

`prec` rounds what each pass stores (see `mvbench/reference/precision.
py`): the identity for the reference, a lower precision for the control.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mvbench.reference.config import RenderConfig
from mvbench.reference.precision import EXACT
from mvbench.reference.render import cull as cull_lib
from mvbench.reference.render import lightsweep, postprocess
from mvbench.reference.render import mesh as mesh_lib
from mvbench.reference.render import taa as taa_lib
from mvbench.reference.render import tilecast
from mvbench.reference.render import sweep as sweep_lib
from mvbench.reference.render import warp as warp_lib
from mvbench.reference.render.perframe import build_per_object
from mvbench.reference.scene.state import SceneState, to_light_sweep


class FrameOutput(NamedTuple):
    image: torch.Tensor   # (H, W, 3) display-mapped
    hdr: torch.Tensor     # (H, W, 4) pre-TAA scene colour
    state: SceneState


def check_supported(config: RenderConfig) -> None:
    """Raise for a setting the frozen frame does not carry."""
    if (config.march_mode != "sweep" or config.light_mode != "sweep"
            or config.point_light
            or config.composite_mode not in ("auto", "tile")
            or config.lod_bucket_caps is None
            or not config.adaptive_raymarch or config.composite_scale != 1):
        raise ValueError("the reference frame carries the main path only: "
                         "sweep march and light, tile composite, LOD "
                         "buckets, full-resolution composite")


def cohort(config: RenderConfig, frame_idx: int, device):
    """Volume ids whose light maps this frame refreshes (round-robin,
    `config.light_refresh` per frame; all of them when it is <= 0)."""
    n = config.num_volumes
    c = n if config.light_refresh <= 0 else min(config.light_refresh, n)
    return (frame_idx * c + torch.arange(c, device=device)) % n


def render_frame(state: SceneState, camera, config: RenderConfig,
                 use_taa: bool = True, prec=EXACT) -> FrameOutput:
    """Render one frame and advance the state (frame index, the light
    cohort's maps and footprints, the TAA history)."""
    check_supported(config)
    width, height = config.width, config.height
    has_mesh = bool(config.show_mesh and state.mesh_indices.shape[0] > 1)

    # --- prep ----------------------------------------------------------------
    view_proj = camera.view_proj
    screen_to_world = camera.screen_to_world
    eye = camera.eye
    per_object = build_per_object(state.volume_worlds, view_proj)
    dev = per_object.world.device
    cull = cull_lib.cull_volumes(
        per_object, eye, [width, height], config.max_ray_samples,
        config.cube_map_size, config.num_cube_mips,
        adaptive=config.adaptive_raymarch)

    # --- opaque mesh ---------------------------------------------------------
    mesh_out = depth_map = None
    if has_mesh:
        mesh_out = mesh_lib.render_mesh(state, camera, config)
        depth_map = mesh_out.depth

    # --- light: refresh one cohort -------------------------------------------
    ids = cohort(config, state.frame_idx, dev)
    axis = (config.light_axis if config.light_axis is not None
            else lightsweep.light_axis(state.light_pos))
    maps_c, light_sout = lightsweep.ray_march_light_sweep_update(
        state.rho_light, state.ao_static, state.grad_dir,
        state.vol_tex_ids, per_object, state.light_pos,
        state.light_color, state.ambient, state.sh_coeffs,
        config.max_light_samples, axis,
        has_light_probe=config.has_light_probe, sub_ids=ids,
        sout_cache=state.light_sout,
        shadow_map=mesh_out.shadow if has_mesh else None,
        shadow_vp=mesh_out.shadow_vp if has_mesh else None)
    maps_c = prec.f32(maps_c)
    state.light_maps[ids] = maps_c.to(state.light_maps.dtype)
    state.light_sweep[ids] = prec.stack(to_light_sweep(
        maps_c, state.light_sweep.dtype))

    # --- view-space cube-map march -------------------------------------------
    lod_cull = cull._replace(use_cube_map=cull.visible)
    swept = sweep_lib.ray_march_view_sweep_lod(
        state.volumes_sweep, state.vol_tex_ids, state.light_sweep,
        per_object, lod_cull, eye, config.cube_map_size,
        warp_lib.screen_basis(screen_to_world, eye),
        bucket_caps=config.lod_bucket_caps, vol_zmax=state.vol_zmax,
        depth_map=depth_map, sorted_output=True, pack=False)
    cube_maps = swept.cube_maps._replace(
        color=prec.f32(swept.cube_maps.color))
    cull_for_composite = cull._replace(mip_level=swept.mips,
                                       use_cube_map=cull.visible)

    # --- sky -----------------------------------------------------------------
    sky = tuple(prec.f32(x) for x in postprocess.render_environment(
        state.radiance, screen_to_world, eye, width, height,
        scale=config.sky_scale))

    # --- OIT composite -------------------------------------------------------
    volumes = tuple(prec.f32(x) for x in tilecast.composite_oit_tile(
        cube_maps, per_object, cull_for_composite, eye, screen_to_world,
        width, height, num_layers=config.oit_layers, order=swept.order,
        swap_sorted=swept.swap, depth_map=depth_map))

    # --- tail, TAA, tone map -------------------------------------------------
    sc = tuple(prec.f32(x) for x in blend_background(
        volumes, sky, width, height, mesh_out))
    if use_taa:
        reproj_ok = (mesh_lib.far_preset(config)
                     and config.taa_reproj_window
                     >= mesh_lib.far_ceiling(config) + 16)
        _, new_history = taa_lib.temporal_aa(
            sc, state.taa_history,
            mesh_out.velocity if has_mesh else None,
            reproj_center=mesh_out.screen_center if has_mesh else None,
            reproj_window=config.taa_reproj_window if reproj_ok else 0)
        new_history = prec.f32(new_history)
        rr, rg, rb = new_history[:3]
    else:
        rr, rg, rb = sc[:3]
        new_history = state.taa_history
    image = torch.stack(postprocess.tone_map_ch(rr, rg, rb), dim=-1)

    new_state = dataclasses.replace(
        state, frame_idx=state.frame_idx + 1, light_sout=light_sout,
        taa_history=new_history,
        mesh_prev_wvp=mesh_out.new_prev_wvp if has_mesh
        else state.mesh_prev_wvp)
    return FrameOutput(image=image, hdr=torch.stack(sc, dim=-1),
                       state=new_state)


def blend_background(volumes, sky, width: int, height: int, mesh_out=None):
    """Composite (r, g, b, a) over the sky, or over the opaque mesh where
    it covers -> scene (r, g, b, a) at (height, width)."""
    vr, vg, vb, va = volumes
    bg_r, bg_g, bg_b = sky
    t = 1.0 - va
    if mesh_out is not None:
        valid = mesh_out.valid
        bg_r, bg_g, bg_b = (torch.where(valid, c, b) for c, b in zip(
            mesh_out.color, (bg_r, bg_g, bg_b)))
        sc_a = va + t * valid.float()
    else:
        sc_a = va
    return (vr + t * bg_r, vg + t * bg_g, vb + t * bg_b, sc_a)
