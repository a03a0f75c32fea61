"""The frame: `(state, camera) -> (image, hdr, state)`.

Counterpart of `multivolumes_tpu/render/frame.py:render_frame` and
`render_frames` for one device, in the order of its passes:

    prep (per-object matrices, cull/LOD) -> mesh (raster, deferred shade;
    with show_mesh and a loaded mesh) -> light (cohort refresh, B3/B4)
    -> sweep (LOD cube-map march, B1) -> sky -> composite (tile OIT, B2)
    -> tail (background blend) -> taa (TAA resolve, B5) -> tone map

With the mesh, its depth bounds the sweep's rays and weights the
composite's taps (B2's depth variant), its cached shadow map shades the
light cohort (B3's shadow-map variant), it is the opaque background of
the volumes, and its velocity reprojects the TAA history.

PyTorch runs eagerly, so there is no jit boundary; the frame reads no
device value on the host except where the composite prep checks the swap
flags. The light stacks of `state` are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core.camera import Camera
from multivolumes_tpu_torch.render import cull as cull_lib
from multivolumes_tpu_torch.render import lightsweep, postprocess
from multivolumes_tpu_torch.render import mesh as mesh_lib
from multivolumes_tpu_torch.render import taa as taa_lib
from multivolumes_tpu_torch.render import tilecast
from multivolumes_tpu_torch.render import sweep as sweep_lib
from multivolumes_tpu_torch.render import warp as warp_lib
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene.state import SceneState, to_light_sweep


class FrameOutput(NamedTuple):
    image: torch.Tensor   # (H, W, 3) display-mapped; (3, H, W) if planar
    hdr: torch.Tensor     # (H, W, 4) pre-tonemap scene colour; (4, H, W)
    state: SceneState


def check_supported(config: RenderConfig, mesh=None) -> None:
    """Raise for the settings whose passes are not ported yet (each is a
    queue entry in ROADMAP.md)."""
    missing = []
    if mesh is not None:
        missing.append("multi-device sharding")
    if config.march_mode != "sweep" or config.light_mode != "sweep":
        missing.append("the reference march twins (march_mode/light_mode "
                    "'reference')")
    if config.point_light:
        missing.append("point lights (the reference light march)")
    if config.composite_mode not in ("auto", "tile"):
        missing.append(f"composite_mode={config.composite_mode!r} (the warp "
                    "and gather composite twins)")
    if config.lod_bucket_caps is None or not config.adaptive_raymarch:
        missing.append("the un-bucketed sweep (lod_bucket_caps=None or "
                    "adaptive_raymarch=False)")
    if missing:
        raise NotImplementedError(
            "not ported to multivolumes_tpu_torch yet: " + "; ".join(missing)
            + " (see ROADMAP.md)")


def render_frame(state: SceneState, camera: Camera, config: RenderConfig,
                 show_mesh: Optional[bool] = None, use_taa: bool = True,
                 mesh=None, planar: bool = False, impl: str | None = None,
                 timer=None) -> FrameOutput:
    """Render one frame and advance the state (frame index, the light
    cohort's maps and footprints, the TAA history). `planar` returns the
    image and hdr channel-leading, the image tone-mapped inside the TAA
    resolve. `impl` forces the kernels' side (see `ops`); `timer`, if
    given, is called with each pass name as the pass starts and with None
    at the end."""
    check_supported(config, mesh)
    width, height = config.width, config.height
    mark = timer if timer is not None else (lambda name: None)
    show_mesh = config.show_mesh if show_mesh is None else show_mesh
    has_mesh = bool(show_mesh and state.mesh_indices.shape[0] > 1)

    mark("prep")
    view_proj = camera.view_proj
    screen_to_world = camera.screen_to_world
    eye = camera.eye
    per_object = build_per_object(state.volume_worlds, view_proj)
    dev = per_object.world.device
    cull = cull_lib.cull_volumes(
        per_object, eye, [width, height], config.max_ray_samples,
        config.cube_map_size, config.num_cube_mips,
        adaptive=config.adaptive_raymarch)

    # --- opaque mesh: raster + deferred shade (shadow map cached) -------
    mesh_out = depth_map = None
    if has_mesh:
        mark("mesh")
        mesh_out = mesh_lib.render_mesh(state, camera, config)
        depth_map = mesh_out.depth

    # --- light: refresh one cohort round-robin (config.light_refresh) ----
    mark("light")
    n = config.num_volumes
    c = n if config.light_refresh <= 0 else min(config.light_refresh, n)
    ids = (state.frame_idx * c + torch.arange(c, device=dev)) % n
    axis = (config.light_axis if config.light_axis is not None
            else lightsweep.light_axis(state.light_pos))
    maps_c, light_sout = lightsweep.ray_march_light_sweep_update(
        state.rho_light, state.ao_static, state.grad_dir, state.vol_tex_ids,
        per_object, state.light_pos, state.light_color, state.ambient,
        state.sh_coeffs, config.max_light_samples, axis,
        has_light_probe=config.has_light_probe, sub_ids=ids,
        sout_cache=state.light_sout, impl=impl,
        shadow_map=mesh_out.shadow if has_mesh else None,
        shadow_vp=mesh_out.shadow_vp if has_mesh else None)
    state.light_maps[ids] = maps_c.to(state.light_maps.dtype)
    state.light_sweep[ids] = to_light_sweep(maps_c, state.light_sweep.dtype)

    # --- view-space LOD cube-map march ----------------------------------
    mark("sweep")
    swap_basis = warp_lib.screen_basis(screen_to_world, eye)
    lod_cull = cull._replace(use_cube_map=cull.visible)
    swept = sweep_lib.ray_march_view_sweep_lod(
        state.volumes_sweep, state.vol_tex_ids, state.light_sweep,
        per_object, lod_cull, eye, config.cube_map_size, swap_basis,
        bucket_caps=config.lod_bucket_caps, vol_zmax=state.vol_zmax,
        impl=impl, depth_map=depth_map)
    cull_for_composite = cull._replace(mip_level=swept.mips,
                                       use_cube_map=cull.visible)

    # --- background: sky ------------------------------------------------
    mark("sky")
    bg_r, bg_g, bg_b = postprocess.render_environment(
        state.radiance, screen_to_world, eye, width, height,
        scale=config.sky_scale)

    # --- OIT composite over the background ------------------------------
    mark("composite")
    cs = config.composite_scale if not has_mesh else 1
    if cs > 1 and width % cs == 0 and height % cs == 0:
        cw, ch = width // cs, height // cs
    else:
        cw, ch = width, height
    vr, vg, vb, va = tilecast.composite_oit_tile(
        swept.cube_maps, per_object, cull_for_composite, eye,
        screen_to_world, cw, ch, num_layers=config.oit_layers,
        order=swept.order, swap_sorted=swept.swap, depth_map=depth_map,
        impl=impl)

    mark("tail")
    if (cw, ch) != (width, height):
        mu = postprocess._upsample_matrix(width, cw, dev)
        mv = postprocess._upsample_matrix(height, ch, dev)
        vr, vg, vb, va = (mv @ x @ mu.T for x in (vr, vg, vb, va))
    t = 1.0 - va
    if has_mesh:
        # the mesh is the opaque background (alpha 1), the sky elsewhere
        valid = mesh_out.valid
        bg_r, bg_g, bg_b = (torch.where(valid, c, b) for c, b in zip(
            mesh_out.color, (bg_r, bg_g, bg_b)))
        sc_a = va + t * valid.float()
    else:
        sc_a = va  # the sky has alpha 0
    sc = (vr + t * bg_r, vg + t * bg_g, vb + t * bg_b, sc_a)

    # --- TAA (the mesh is the one velocity writer) + tone map ------------
    image = None
    if use_taa:
        mark("taa")
        # the windowed reprojection only under the far preset, whose host
        # pick keeps the mesh inside raster_far_bound, and only when the
        # window covers the pick's 1.05x hysteresis ceiling plus the
        # velocity dilation; else the whole screen
        reproj_ok = (mesh_lib.far_preset(config)
                     and config.taa_reproj_window
                     >= mesh_lib.far_ceiling(config) + 16)
        taa_out = taa_lib.temporal_aa(
            sc, state.taa_history,
            mesh_out.velocity if has_mesh else None,
            tonemap_out=planar, impl=impl,
            reproj_center=mesh_out.screen_center if has_mesh else None,
            reproj_window=config.taa_reproj_window if reproj_ok else 0)
        if planar:
            (rr, rg, rb), new_history, image = taa_out
        else:
            (rr, rg, rb), new_history = taa_out
    else:
        rr, rg, rb = sc[:3]
        new_history = state.taa_history
    mark("tonemap")
    ax = 0 if planar else -1
    if image is None:
        image = torch.stack(postprocess.tone_map_ch(rr, rg, rb), dim=ax)
    hdr = torch.stack(sc, dim=ax)
    mark(None)

    new_state = dataclasses.replace(
        state, frame_idx=state.frame_idx + 1, light_sout=light_sout,
        taa_history=new_history,
        mesh_prev_wvp=mesh_out.new_prev_wvp if has_mesh
        else state.mesh_prev_wvp)
    return FrameOutput(image=image, hdr=hdr, state=new_state)


def render_frames(state: SceneState, cameras: Sequence[Camera],
                  config: RenderConfig, use_taa: bool = True,
                  show_mesh: Optional[bool] = None):
    """Render K frames, one per camera, carrying the state from each to
    the next exactly as K `render_frame` calls do. Returns ((K, 3, H, W)
    planar display images, the advanced state)."""
    images = []
    for camera in cameras:
        out = render_frame(state, camera, config, show_mesh=show_mesh,
                           use_taa=use_taa, planar=True)
        images.append(out.image)
        state = out.state
    return torch.stack(images, 0), state
