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

The config picks the light, march and composite passes as the JAX frame
does (`frame_passes`).

PyTorch runs eagerly, so there is no jit boundary. The main path makes
the host wait for the device only inside `utils.timing.host_read`, which
counts and times each wait: the inverses' singularity checks and the
small uploads from host memory that PyTorch follows with a stream sync;
the reference marches read their done masks every few steps and the warp
composite its branch flags once a volume. The light stacks of `state` are
updated in place.

With a device mesh (`render_frame(..., mesh=mesh)`, the state a
`parallel.sharding.ShardedState`) the same passes run as the sharded
frame step: the sweep split over the mesh's volume axis, the composite
and the TAA resolve over its row axis where it has one, the opaque
mesh's raster and shade over its row axis too, everything else
replicated, once per physical device (`_render_frame_sharded`), in every
setting above.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core.camera import Camera
from multivolumes_tpu_torch.render import composite as composite_lib
from multivolumes_tpu_torch.render import cull as cull_lib
from multivolumes_tpu_torch.render import lightmarch, lightsweep
from multivolumes_tpu_torch.render import postprocess, raymarch
from multivolumes_tpu_torch.render import mesh as mesh_lib
from multivolumes_tpu_torch.ops import taa as taa_ops
from multivolumes_tpu_torch.render import taa as taa_lib
from multivolumes_tpu_torch.render import tilecast
from multivolumes_tpu_torch.render import sweep as sweep_lib
from multivolumes_tpu_torch.render import warp as warp_lib
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene.state import SceneState, to_light_sweep
from multivolumes_tpu_torch.utils import timing


class FrameOutput(NamedTuple):
    image: torch.Tensor   # (H, W, 3) display-mapped; (3, H, W) if planar
    hdr: torch.Tensor     # (H, W, 4) pre-tonemap scene colour; (4, H, W)
    state: SceneState


def frame_passes(config: RenderConfig):
    """The passes `config` picks -> (light, march, composite), as the JAX
    frame does, in the frame and the sharded step alike. light: "sweep"
    (the cohort refresh, B3 / B4), or "reference" for `light_mode=
    "reference"` or `point_light` (the gather light march of one volume a
    frame). march: "lod" (the LOD buckets), "unbucketed" for
    `lod_bucket_caps=None` or `adaptive_raymarch=False` (one B1 launch at
    full resolution), or "reference" (per ray). composite: "tile" (B2) for
    "auto" and "tile", "warp" (the tile warps), or "gather" (the CubeCast
    gather), always after the reference march. Raises for settings the
    JAX package does not have either."""
    bad = []
    if config.march_mode not in ("sweep", "reference"):
        bad.append(f"march_mode={config.march_mode!r}")
    if config.light_mode not in ("sweep", "reference"):
        bad.append(f"light_mode={config.light_mode!r}")
    if config.composite_mode not in ("auto", "tile", "warp", "gather"):
        bad.append(f"composite_mode={config.composite_mode!r}")
    if bad:
        raise ValueError("unknown setting: " + ", ".join(bad))
    light = "reference" if config.point_light else config.light_mode
    march = ("reference" if config.march_mode == "reference"
             else "lod" if config.lod_bucket_caps is not None
             and config.adaptive_raymarch else "unbucketed")
    composite = ("gather" if march == "reference"
                 else "tile" if config.composite_mode == "auto"
                 else config.composite_mode)
    return light, march, composite


def check_supported(config: RenderConfig) -> None:
    """Raise for settings the JAX package does not have either."""
    frame_passes(config)


def render_frame(state: SceneState, camera: Camera, config: RenderConfig,
                 show_mesh: Optional[bool] = None, use_taa: bool = True,
                 mesh=None, planar: bool = False, impl: str | None = None,
                 timer=None) -> FrameOutput:
    """Render one frame and advance the state (frame index, the light
    cohort's maps and footprints, the TAA history). `planar` returns the
    image and hdr channel-leading, the image tone-mapped inside the TAA
    resolve. `impl` forces the kernels' side (see `ops`); `timer`, if
    given, is called with each pass name as the pass starts and with None
    at the end; the frame's spans (`utils.timing.SPANS`) are recorded at
    the same marks, under the state's frame index. With `mesh` (a
    `parallel.collectives.DeviceMesh`), `state` is a `ShardedState` on
    that mesh and so is the returned state; the image and hdr are
    assembled on `mesh.root`."""
    check_supported(config)
    show_mesh = config.show_mesh if show_mesh is None else show_mesh

    def mark(name):
        timing.SPANS.mark(name, timer)

    with timing.SPANS.frame(state.frame_idx):
        if mesh is not None:
            return _render_frame_sharded(state, camera, config, mesh,
                                         show_mesh, use_taa, planar, impl,
                                         mark)
        return _render_frame_local(state, camera, config, show_mesh,
                                   use_taa, planar, impl, mark)


def _render_frame_local(state: SceneState, camera: Camera,
                        config: RenderConfig, show_mesh: bool, use_taa: bool,
                        planar: bool, impl, mark) -> FrameOutput:
    """The frame on one device (`render_frame` without a device mesh)."""
    light, march, composite = frame_passes(config)
    width, height = config.width, config.height
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
        mesh_out = mesh_lib.render_mesh(state, camera, config, impl)
        depth_map = mesh_out.depth

    # --- light ------------------------------------------------------------
    mark("light")
    light_sout = state.light_sout
    if light == "sweep":
        # refresh one cohort round-robin (config.light_refresh)
        ids = _cohort(config, state.frame_idx, dev)
        # an axis the engine did not bake is read from the device
        axis = (config.light_axis if config.light_axis is not None
                else timing.host_read("light.axis", lambda: (
                    lightsweep.light_axis(state.light_pos))))
        _maps, light_sout = lightsweep.ray_march_light_sweep_update(
            state.rho_light, state.ao_static, state.grad_dir,
            state.vol_tex_ids, per_object, state.light_pos,
            state.light_color, state.ambient, state.sh_coeffs,
            config.max_light_samples, axis,
            has_light_probe=config.has_light_probe, sub_ids=ids,
            sout_cache=state.light_sout, impl=impl,
            shadow_map=mesh_out.shadow if has_mesh else None,
            shadow_vp=mesh_out.shadow_vp if has_mesh else None,
            store=(state.light_maps, state.light_sweep, ids))
    else:
        # reference semantics: the gather march of one volume a frame;
        # its row of the sweep's stack follows
        lightmarch.ray_march_light(
            state.volumes, state.vol_tex_ids, state.light_maps, per_object,
            cull, state.frame_idx,
            mesh_out.shadow if has_mesh else None,
            mesh_out.shadow_vp if has_mesh else None,
            state.light_pos, state.light_color, state.ambient,
            state.sh_coeffs, config.max_light_samples,
            has_light_probe=config.has_light_probe,
            point_light=config.point_light)
        vid = lightmarch.select_update_volume(
            cull.visible, state.frame_idx).reshape(1)
        state.light_sweep.index_copy_(0, vid, to_light_sweep(
            state.light_maps.index_select(0, vid), state.light_sweep.dtype))

    # --- view-space cube-map march ----------------------------------------
    mark("sweep")
    n = config.num_volumes
    s = config.cube_map_size
    order = swap = lod_order = lod_buckets = None
    use_tile = composite == "tile"
    if march == "reference":
        cube_maps = raymarch.ray_march_view(
            state.volumes, state.vol_tex_ids, state.light_maps.movedim(1, -1),
            per_object, cull, eye, depth_map, s, config.max_ray_samples,
            adaptive=config.adaptive_raymarch)
        cull_for_composite = cull
    elif march == "lod":
        # the sweep marches every visible face; the composite reads the
        # effective mips the buckets gave
        lod_cull = cull._replace(use_cube_map=cull.visible)
        swept = sweep_lib.ray_march_view_sweep_lod(
            state.volumes_sweep, state.vol_tex_ids, state.light_sweep,
            per_object, lod_cull, eye, s,
            warp_lib.screen_basis(screen_to_world, eye) if use_tile
            else None,
            bucket_caps=config.lod_bucket_caps, vol_zmax=state.vol_zmax,
            impl=impl, depth_map=depth_map, sorted_output=use_tile,
            pack=composite == "gather")
        cube_maps = swept.cube_maps
        cull_for_composite = cull._replace(mip_level=swept.mips,
                                           use_cube_map=cull.visible)
        if use_tile:
            order, swap = swept.order, swept.swap
        else:
            # the warp's footprint classes mirror the sweep's buckets
            lod_order, lod_buckets = sweep_lib.lod_partition(
                lod_cull, n, s, config.lod_bucket_caps)
    else:
        # every volume at full resolution, all on the cube-map path (the
        # reference's non-adaptive mode, `CSVolumeCull.hlsl:69`)
        cull_for_composite = cull._replace(
            mip_level=torch.zeros_like(cull.mip_level),
            use_cube_map=cull.visible)
        cube_maps = sweep_lib.ray_march_view_sweep(
            state.volumes_sweep, state.vol_tex_ids, state.light_sweep,
            per_object, cull_for_composite, eye, depth_map, s,
            num_planes=config.sweep_planes, vol_zmax=state.vol_zmax,
            impl=impl)
        if config.packed_composite and composite == "gather":
            # the gather composite reads f16 pairs (the LOD sweep packs
            # its own maps for it whatever packed_composite says, as in
            # JAX)
            cube_maps = cube_maps._replace(
                color=composite_lib.pack_cube_f16(cube_maps.color))

    # --- background: sky ------------------------------------------------
    mark("sky")
    bg_r, bg_g, bg_b = postprocess.render_environment(
        state.radiance, screen_to_world, eye, width, height,
        scale=config.sky_scale)

    # --- OIT composite over the background ------------------------------
    mark("composite")
    cw, ch = _composite_size(config, has_mesh)
    volumes = _composite(
        config, composite, march, has_mesh, cube_maps, per_object,
        cull_for_composite, eye, screen_to_world, depth_map, cw, ch, order,
        swap, lod_order, lod_buckets, state.volumes, state.vol_tex_ids,
        state.light_maps, impl)

    mark("tail")
    sc = _blend_background(volumes, (bg_r, bg_g, bg_b), width, height,
                           mesh_out)

    image, hdr, new_history = _resolve_and_map(
        sc, state.taa_history, config, use_taa, planar, impl, mark,
        mesh_out=mesh_out)
    mark(None)

    new_state = dataclasses.replace(
        state, frame_idx=state.frame_idx + 1, light_sout=light_sout,
        taa_history=new_history,
        mesh_prev_wvp=mesh_out.new_prev_wvp if has_mesh
        else state.mesh_prev_wvp)
    return FrameOutput(image=image, hdr=hdr, state=new_state)


def _cohort(config: RenderConfig, frame_idx: int, device=None):
    """Volume ids whose light maps this frame refreshes (round-robin,
    `config.light_refresh` per frame; all of them when it is <= 0): a
    tensor made on `device`, or a host list without one."""
    n = config.num_volumes
    c = n if config.light_refresh <= 0 else min(config.light_refresh, n)
    if device is None:
        return [(frame_idx * c + i) % n for i in range(c)]
    return (frame_idx * c + torch.arange(c, device=device)) % n


def _composite(config: RenderConfig, composite: str, march: str,
               has_mesh: bool, cube_maps, per_object, cull, eye,
               screen_to_world, depth_map, cw: int, ch: int, order, swap,
               lod_order, lod_buckets, volumes, vol_tex_ids, light_maps, impl):
    """The OIT composite of one device at (cw, ch) -> (r, g, b, a): the
    screen-tile kernel, the tile warps or the per-pixel CubeCast
    (`composite`), which marches through `light_maps` (N, 4, L, L, L)
    after the reference march."""
    if composite == "tile":
        return tilecast.composite_oit_tile(
            cube_maps, per_object, cull, eye, screen_to_world, cw, ch,
            num_layers=config.oit_layers, order=order, swap_sorted=swap,
            depth_map=depth_map, impl=impl)
    if composite == "warp":
        return warp_lib.composite_oit_warp(
            cube_maps, per_object, cull, eye, screen_to_world, depth_map, cw,
            ch, num_layers=config.oit_layers, tile=_warp_tile(config),
            lod_order=lod_order, lod_buckets=lod_buckets)
    return composite_lib.composite_oit(
        cube_maps, volumes, vol_tex_ids,
        None if light_maps is None else light_maps.movedim(1, -1),
        per_object, cull, eye, screen_to_world, depth_map, cw, ch,
        config.max_ray_samples, num_layers=config.oit_layers,
        adaptive=config.adaptive_raymarch,
        use_raycast=march == "reference", has_depth=has_mesh)


def _warp_tile(config: RenderConfig) -> int:
    """The warp composite's tile (`config.warp_tile`, else by scene size)."""
    if config.warp_tile is not None:
        return config.warp_tile
    return 512 if config.num_volumes <= 8 else 384


def _composite_size(config: RenderConfig, has_mesh: bool):
    """(width, height) the composite runs at (`config.composite_scale`)."""
    width, height = config.width, config.height
    cs = config.composite_scale if not has_mesh else 1
    if cs > 1 and width % cs == 0 and height % cs == 0:
        return width // cs, height // cs
    return width, height


def _blend_background(volumes, sky, width: int, height: int, mesh_out=None):
    """Composite (r, g, b, a) over the sky, or over the opaque mesh where
    it covers -> scene (r, g, b, a) at (height, width)."""
    vr, vg, vb, va = volumes
    bg_r, bg_g, bg_b = sky
    ch, cw = va.shape
    if (cw, ch) != (width, height):
        mu = postprocess._upsample_matrix(width, cw, va.device)
        mv = postprocess._upsample_matrix(height, ch, va.device)
        vr, vg, vb, va = (mv @ x @ mu.T for x in (vr, vg, vb, va))
    t = 1.0 - va
    if mesh_out is not None:
        # the mesh is the opaque background (alpha 1), the sky elsewhere
        valid = mesh_out.valid
        bg_r, bg_g, bg_b = (torch.where(valid, c, b) for c, b in zip(
            mesh_out.color, (bg_r, bg_g, bg_b)))
        sc_a = va + t * valid.float()
    else:
        sc_a = va  # the sky has alpha 0
    return (vr + t * bg_r, vg + t * bg_g, vb + t * bg_b, sc_a)


def _resolve_and_map(sc, history, config: RenderConfig, use_taa: bool,
                     planar: bool, impl, mark, mesh_out=None,
                     device_mesh=None):
    """TAA (the mesh is the one velocity writer) and the tone map ->
    (image, hdr, new history). With a `device_mesh` the tone map is its
    own pass, as in the JAX package, and where the mesh has a rows axis
    the resolve runs in row bands."""
    has_mesh = mesh_out is not None
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
        fuse_tm = planar and device_mesh is None
        taa_out = taa_lib.temporal_aa(
            sc, history,
            mesh_out.velocity if has_mesh else None,
            tonemap_out=fuse_tm, impl=impl,
            reproj_center=mesh_out.screen_center if has_mesh else None,
            reproj_window=config.taa_reproj_window if reproj_ok else 0,
            device_mesh=device_mesh)
        if fuse_tm:
            (rr, rg, rb), new_history, image = taa_out
        else:
            (rr, rg, rb), new_history = taa_out
    else:
        rr, rg, rb = sc[:3]
        new_history = history
    mark("tonemap")
    ax = 0 if planar else -1
    if image is None:
        image = torch.stack(postprocess.tone_map_ch(rr, rg, rb), dim=ax)
    return image, torch.stack(sc, dim=ax), new_history


def _render_frame_sharded(sharded, camera: Camera, config: RenderConfig,
                          mesh, show_mesh: bool, use_taa: bool, planar: bool,
                          impl, mark) -> FrameOutput:
    """The sharded frame step (counterpart of the JAX package's
    `render_frame(..., mesh=mesh)` under GSPMD, stated explicitly):

    * prep, cull and the light refresh run replicated, once per physical
      device, on the all-gathered world matrices; the refresh writes a
      replicated light stack once per physical device (logical shards of
      one device alias it), and under `shard_light_stacks` only the owner
      shard of each refreshed volume changes its local row (the sweep
      light's cohort, or the reference light's one volume a frame);
    * with an opaque mesh its pass runs before the light: on a rows axis
      the raster and the shade in row bands, the depth map all-gathered
      onto every device and the shaded fields onto the root
      (`mesh.render_mesh_sharded`), else replicated; its cached
      shadow map shades every refresh (B3's shadow-map variant), its
      depth bounds every shard's rays and weights the composite (B2's
      depth variant, in row bands on a rows axis), it is the background
      of the volumes, and its velocity reprojects the TAA history on the
      root (windowed under the far preset) before the resolve;
    * the cube-map march runs per index of the volume axis (the LOD
      sweep with the caps divided by the shards, the un-bucketed sweep in
      one B1 launch a shard, or the reference march), and its cube maps
      are all-gathered (the one large movement of the frame);
    * without a rows axis the screen passes (sky, composite, tail, TAA,
      tone map) run replicated too; with one, the tile composite and the
      TAA resolve run one row band per device and the rest on
      `mesh.root`, the warp and gather composites included (the gather
      composite of the reference march reads the whole light stack,
      all-gathered there under `shard_light_stacks`).
    """
    from multivolumes_tpu_torch.parallel import collectives as coll

    light, march, composite = frame_passes(config)
    width, height = config.width, config.height
    nd, rows = mesh.n_volumes_axis, mesh.rows
    has_rows = "rows" in mesh.axis_names
    root = mesh.root
    if sharded.shard_light != config.shard_light_stacks:
        raise ValueError(
            f"the state was sharded with shard_light={sharded.shard_light} "
            f"but config.shard_light_stacks={config.shard_light_stacks}")
    has_mesh = bool(show_mesh
                    and sharded.local(0, 0).mesh_indices.shape[0] > 1)
    # the shards each physical device hosts: {device: {d: local state}}
    hosted = {}
    for r in range(rows):
        for d in range(nd):
            hosted.setdefault(mesh.device(r, d), {}).setdefault(
                d, sharded.local(r, d))
    rep = {dev: next(iter(shards.values())) for dev, shards in hosted.items()}
    by_d = [sharded.local(0, d) for d in range(nd)]
    frame_idx = sharded.frame_idx

    mark("prep")
    cams = {dev: Camera(*c) for dev, c in coll.broadcast(
        (camera.eye, camera.view, camera.proj), mesh, "camera").items()}
    eye = {dev: c.eye for dev, c in cams.items()}
    screen_to_world = {dev: c.screen_to_world for dev, c in cams.items()}
    worlds = coll.all_gather([s.volume_worlds for s in by_d], 0, mesh,
                             "volume_worlds")
    tex_ids = coll.all_gather([s.vol_tex_ids for s in by_d], 0, mesh,
                              "vol_tex_ids")
    per_object = {dev: build_per_object(worlds[dev], cams[dev].view_proj)
                  for dev in mesh.physical}
    cull = {dev: cull_lib.cull_volumes(
        per_object[dev], eye[dev], [width, height], config.max_ray_samples,
        config.cube_map_size, config.num_cube_mips,
        adaptive=config.adaptive_raymarch) for dev in mesh.physical}

    # --- opaque mesh: raster + deferred shade, row-banded on a rows axis
    mesh_out = {dev: None for dev in mesh.physical}
    depth_map = None
    if has_mesh:
        mark("mesh")
        mesh_out = mesh_lib.render_mesh_sharded(rep, cams, config, mesh,
                                                impl)
        depth_map = {dev: m.depth for dev, m in mesh_out.items()}

    mark("light")
    shard_light = sharded.shard_light
    if light == "sweep":
        _sweep_light_sharded(config, mesh, rep, hosted, by_d, tex_ids,
                             per_object, mesh_out, shard_light, impl)
    else:
        _reference_light_sharded(config, mesh, rep, hosted, tex_ids,
                                 per_object, cull, mesh_out, shard_light)

    mark("sweep")
    n, s = config.num_volumes, config.cube_map_size
    use_tile = composite == "tile"
    reps = lambda name: {dev: getattr(st, name)              # noqa: E731
                         for dev, st in rep.items()}
    # the shards' light stacks: their own under shard_light, else their
    # rows of the replicated stack
    light_sweep = ([b.light_sweep for b in by_d] if shard_light
                   else reps("light_sweep"))
    order = swap = lod_order = lod_buckets = None
    if march == "reference":
        # the reference march per volume shard, on its rows of the light
        # maps (channel-last) and of the global cull
        def march_shard(dev, d, rows):
            maps = (by_d[d].light_maps if shard_light
                    else rep[dev].light_maps[rows])
            return raymarch.ray_march_view(
                rep[dev].volumes, by_d[d].vol_tex_ids, maps.movedim(1, -1),
                per_object[dev].take(rows), cull[dev].take(rows), eye[dev],
                None if depth_map is None else depth_map[dev], s,
                config.max_ray_samples, adaptive=config.adaptive_raymarch)

        cube_maps = sweep_lib.march_volume_shards(mesh, n, march_shard,
                                                  depth_map is not None)
        cull_c = cull
    elif march == "lod":
        lod_cull = {dev: c._replace(use_cube_map=c.visible)
                    for dev, c in cull.items()}
        swept = sweep_lib.ray_march_view_sweep_lod_sharded(
            mesh, reps("volumes_sweep"), [b.vol_tex_ids for b in by_d],
            light_sweep, per_object, lod_cull, eye, s,
            {dev: warp_lib.screen_basis(screen_to_world[dev], eye[dev])
             for dev in mesh.physical} if use_tile else None,
            bucket_caps=config.lod_bucket_caps, vol_zmax=reps("vol_zmax"),
            impl=impl, light_sharded=shard_light, depth_map=depth_map,
            sorted_output=use_tile, pack=composite == "gather")
        cube_maps = {dev: sw.cube_maps for dev, sw in swept.items()}
        cull_c = {dev: c._replace(mip_level=swept[dev].mips,
                                  use_cube_map=c.visible)
                  for dev, c in cull.items()}
        if use_tile:
            order = {dev: sw.order for dev, sw in swept.items()}
            swap = {dev: sw.swap for dev, sw in swept.items()}
        else:
            # the warp's footprint classes from the global cull and caps,
            # as in the JAX frame (a shard's divided caps may have marched
            # a volume at another mip: ROADMAP.md section C)
            lod_order, lod_buckets = {}, None
            for dev in mesh.physical:
                lod_order[dev], lod_buckets = sweep_lib.lod_partition(
                    lod_cull[dev], n, s, config.lod_bucket_caps)
    else:
        # every volume at full resolution, one B1 launch per volume shard
        cull_c = {dev: c._replace(mip_level=torch.zeros_like(c.mip_level),
                                  use_cube_map=c.visible)
                  for dev, c in cull.items()}
        cube_maps = sweep_lib.ray_march_view_sweep_sharded(
            mesh, reps("volumes_sweep"), [b.vol_tex_ids for b in by_d],
            light_sweep, per_object, cull_c, eye, depth_map, s,
            num_planes=config.sweep_planes, vol_zmax=reps("vol_zmax"),
            impl=impl, light_sharded=shard_light,
            pack=config.packed_composite and composite == "gather")

    cw, ch = _composite_size(config, has_mesh)
    light_maps = None
    if march == "reference":
        # the gather composite marches its per-pixel layers through the
        # whole light stack: gathered where the composite runs
        light_maps = (coll.all_gather(
            [b.light_maps for b in by_d], 0, mesh, "light_maps",
            devices=(root,) if has_rows else None)
            if shard_light else reps("light_maps"))
    new_history = {}
    # the screen passes: replicated without a rows axis, else on the root
    for dev in ((root,) if has_rows else mesh.physical):
        mark("sky")
        sky = postprocess.render_environment(
            rep[dev].radiance, screen_to_world[dev], eye[dev], width, height,
            scale=config.sky_scale)
        mark("composite")
        if use_tile and has_rows:
            volumes = tilecast.composite_oit_tile_sharded(
                mesh, cube_maps, per_object, cull_c, eye, screen_to_world,
                cw, ch, num_layers=config.oit_layers, order=order,
                swap_sorted=swap, depth_map=depth_map, impl=impl)
        else:
            at = lambda x: None if x is None else x[dev]     # noqa: E731
            volumes = _composite(
                config, composite, march, has_mesh, cube_maps[dev],
                per_object[dev], cull_c[dev], eye[dev], screen_to_world[dev],
                at(depth_map), cw, ch, at(order), at(swap), at(lod_order),
                lod_buckets, rep[dev].volumes, tex_ids[dev], at(light_maps),
                impl)
        if has_rows:
            history = coll.all_gather(
                [sharded.local(r, 0).taa_history for r in range(rows)], 1,
                mesh, "taa_history", devices=(root,))[root]
        else:
            history = rep[dev].taa_history
        mark("tail")
        sc = _blend_background(volumes, sky, width, height, mesh_out[dev])
        out = _resolve_and_map(sc, history, config, use_taa, planar, impl,
                               mark, mesh_out=mesh_out[dev], device_mesh=mesh)
        new_history[dev] = out[2]
        if dev == root:
            image, hdr = out[:2]
    mark(None)

    bands = taa_ops.row_bands(height, rows)
    locals_ = []
    for r in range(rows):
        for d in range(nd):
            dev = mesh.device(r, d)
            if has_rows:
                y0, y1 = bands[r]
                hist = coll.to_device(new_history[root][:, y0:y1], dev)
            else:
                hist = new_history[dev]
            loc = sharded.local(r, d)
            locals_.append(dataclasses.replace(
                loc, frame_idx=frame_idx + 1, taa_history=hist,
                mesh_prev_wvp=mesh_out[dev].new_prev_wvp if has_mesh
                else loc.mesh_prev_wvp))
    return FrameOutput(image=image, hdr=hdr,
                       state=dataclasses.replace(sharded,
                                                 locals=tuple(locals_)))


def _sweep_light_sharded(config, mesh, rep, hosted, by_d, tex_ids,
                         per_object, mesh_out, shard_light: bool, impl):
    """The sweep light's cohort refresh (B3 / B4) of the sharded step, once
    per physical device on the gathered worlds and texture ids: it writes
    a replicated stack once a device, or under `shard_light` each hosted
    shard's own rows of the cohort (the cohort ids are host arithmetic)."""
    from multivolumes_tpu_torch.parallel import collectives as coll

    frame_idx = by_d[0].frame_idx
    ids_host = _cohort(config, frame_idx)
    nl = config.num_volumes // mesh.n_volumes_axis
    axis = (config.light_axis if config.light_axis is not None
            else timing.host_read("light.axis", lambda: (
                lightsweep.light_axis(rep[mesh.root].light_pos))))
    if shard_light:
        sout_all = coll.all_gather([s.light_sout for s in by_d], 0, mesh,
                                   "light_sout")
    for dev in mesh.physical:
        st, m_out = rep[dev], mesh_out[dev]
        ids = _cohort(config, frame_idx, dev)
        maps_c, sout = lightsweep.ray_march_light_sweep_update(
            st.rho_light, st.ao_static, st.grad_dir, tex_ids[dev],
            per_object[dev], st.light_pos, st.light_color, st.ambient,
            st.sh_coeffs, config.max_light_samples, axis,
            has_light_probe=config.has_light_probe, sub_ids=ids,
            sout_cache=sout_all[dev] if shard_light else st.light_sout,
            impl=impl,
            shadow_map=None if m_out is None else m_out.shadow,
            shadow_vp=None if m_out is None else m_out.shadow_vp,
            store=None if shard_light else (st.light_maps, st.light_sweep,
                                            ids))
        if not shard_light:
            continue
        for d, loc in hosted[dev].items():
            own = [i for i, v in enumerate(ids_host) if v // nl == d]
            if not own:
                continue
            pick = torch.tensor(own, device=dev)
            at = ids[pick] - d * nl
            loc.light_maps[at] = maps_c[pick].to(loc.light_maps.dtype)
            loc.light_sweep[at] = to_light_sweep(maps_c[pick],
                                                 loc.light_sweep.dtype)
            loc.light_sout[at] = sout[ids[pick]]


def _reference_light_sharded(config, mesh, rep, hosted, tex_ids, per_object,
                             cull, mesh_out, shard_light: bool):
    """The reference light of the sharded step (the gather march of one
    volume a frame, `lightmarch.march_light_map`), once per physical
    device on the gathered worlds and the global cull. Under
    `shard_light` every hosted shard writes its row at the volume's local
    index, the new map where it owns the volume and its own row
    elsewhere: a masked write, so the owner needs no host read of the
    volume id."""
    nl = config.num_volumes // mesh.n_volumes_axis
    frame_idx = rep[mesh.root].frame_idx
    for dev in mesh.physical:
        st, m_out = rep[dev], mesh_out[dev]
        vid, new_map = lightmarch.march_light_map(
            st.volumes, tex_ids[dev], per_object[dev], cull[dev], frame_idx,
            None if m_out is None else m_out.shadow,
            None if m_out is None else m_out.shadow_vp,
            st.light_pos, st.light_color, st.ambient, st.sh_coeffs,
            config.max_light_samples, config.light_grid_size,
            has_light_probe=config.has_light_probe,
            point_light=config.point_light)
        targets = ([(st, vid, None)] if not shard_light else
                   [(loc, torch.clamp(vid - d * nl, 0, nl - 1),
                     vid[0] // nl == d) for d, loc in hosted[dev].items()])
        for loc, at, own in targets:
            row = new_map.to(loc.light_maps.dtype)[None]
            row_sweep = to_light_sweep(row, loc.light_sweep.dtype)
            if own is not None:
                row = torch.where(own, row, loc.light_maps[at])
                row_sweep = torch.where(own, row_sweep, loc.light_sweep[at])
            loc.light_maps.index_copy_(0, at, row)
            loc.light_sweep.index_copy_(0, at, row_sweep)


def render_frames(state: SceneState, cameras: Sequence[Camera],
                  config: RenderConfig, use_taa: bool = True,
                  show_mesh: Optional[bool] = None, mesh=None):
    """Render K frames, one per camera, carrying the state from each to
    the next exactly as K `render_frame` calls do. Returns ((K, 3, H, W)
    planar display images, the advanced state). `mesh`: see
    `render_frame`."""
    images = []
    for camera in cameras:
        out = render_frame(state, camera, config, show_mesh=show_mesh,
                           use_taa=use_taa, planar=True, mesh=mesh)
        images.append(out.image)
        state = out.state
    return torch.stack(images, 0), state
