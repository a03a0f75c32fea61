"""Multi-device scaling: shard the volume axis and the pixel rows over a
device mesh.

Counterpart of `multivolumes_tpu/parallel/sharding.py`. The plan is the
JAX package's:

- mesh: 1-D ("volumes",) or 2-D ("rows", "volumes"). The per-volume axis
  is the natural parallel axis: cube-map marching and light maps are
  independent per volume;
- per-volume state (worlds, tex ids, optionally the light stacks) is
  sharded on that axis; the marched cube maps are all-gathered into the
  screen composite, which needs every volume's small map at every pixel;
- with a rows axis the composite and the TAA resolve run on bands of
  pixel rows, and the TAA history is stored in those bands;
- the opaque mesh's tables (vertices, indices, world, previous-frame
  matrix, cached shadow map) are replicated; with a rows axis its raster
  and shade run in row bands (`render/mesh.py:render_mesh`).

The JAX version states shardings on one jitted step and lets GSPMD place
the collectives. Here one process drives every device and the movements
are explicit (`parallel/collectives.py`): a `ShardedState` holds one local
`SceneState` view per mesh position, and `render_frame(..., mesh=mesh)`
runs each pass where the plan puts it. A mesh may name one device several
times (*logical shards*), which is how the CPU tests and a one-card
machine run the plan with D > 1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.ops.taa import row_bands
from multivolumes_tpu_torch.parallel import collectives
from multivolumes_tpu_torch.parallel.collectives import DeviceMesh
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.scene import state as state_lib
from multivolumes_tpu_torch.scene.state import SceneState


def make_mesh(devices: Sequence, rows: int = 1) -> DeviceMesh:
    """1-D volume mesh over `devices`, or 2-D (rows x volumes) when
    rows > 1: `devices` has n_volumes_axis * rows entries, row-major, and
    may repeat a device (logical shards)."""
    devices = tuple(torch.device(d) for d in devices)
    if rows < 1 or not devices or len(devices) % rows:
        raise ValueError(f"{len(devices)} devices do not fill {rows} rows")
    nd = len(devices) // rows
    if rows > 1:
        return DeviceMesh(("rows", "volumes"), {"rows": rows, "volumes": nd},
                          devices)
    return DeviceMesh(("volumes",), {"volumes": nd}, devices)


def state_shardings(mesh: DeviceMesh, state: SceneState,
                    shard_light: bool = False) -> dict:
    """Per-field plan {field: "rep" | "volumes" | "rows"}: the volume axis
    sharded, the screen-size history row-sharded on a 2-D mesh, the rest
    replicated. The light stacks are the dominant carried state:
    replicated by default (the sharded sweep slices its local volumes out
    with no per-frame movement), sharded over the volume axis with
    `shard_light` (`config.shard_light_stacks`) for memory scaling: each
    device then holds 1 / D of them, the sweep reads its local shard and
    the cohort refresh writes only rows their shard owns."""
    light = "volumes" if shard_light else "rep"
    plan = {f.name: "rep" for f in dataclasses.fields(state)}
    plan.update(vol_tex_ids="volumes", volume_worlds="volumes",
                light_maps=light, light_sweep=light, light_sout=light,
                taa_history="rows" if "rows" in mesh.axis_names else "rep")
    return plan


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """A scene state laid out on a mesh: one local `SceneState` view per
    mesh position. Volume-sharded fields hold the position's slice of the
    volume axis, `taa_history` its band of rows, replicated fields one
    copy per distinct physical device (logical shards of one device share
    the tensor, so an in-place update is made once)."""
    mesh: DeviceMesh
    shard_light: bool
    locals: tuple            # row-major (rows, volumes) local SceneStates

    def local(self, r: int, d: int) -> SceneState:
        return self.locals[r * self.mesh.n_volumes_axis + d]

    @property
    def frame_idx(self) -> int:
        return self.locals[0].frame_idx


def shard_state(state: SceneState, mesh: DeviceMesh,
                shard_light: bool = False) -> ShardedState:
    """Lay `state` out on `mesh`. Shards on the device `state` lies on
    are views of its tensors, so a sharded step updates the light stacks
    of `state` in place, as an unsharded frame does."""
    plan = state_shardings(mesh, state, shard_light=shard_light)
    nd, rows = mesh.n_volumes_axis, mesh.rows
    n = state.vol_tex_ids.shape[0]
    height = state.taa_history.shape[1]
    if n % nd:
        raise ValueError(f"{n} volumes do not divide over {nd} shards")
    bands = row_bands(height, rows)
    if len(bands) != rows:
        raise ValueError(f"{height} pixel rows do not fill {rows} bands")
    nl = n // nd
    cache = {}

    def place(name, r, d):
        x = getattr(state, name)
        if not isinstance(x, torch.Tensor):
            return x
        dev = mesh.device(r, d)
        kind = plan[name]
        key = (name, dev, d if kind == "volumes" else
               r if kind == "rows" else None)
        if key not in cache:
            if kind == "volumes":
                x = x[d * nl:(d + 1) * nl]
            elif kind == "rows":
                x = x[:, bands[r][0]:bands[r][1]]
            cache[key] = collectives.to_device(x, dev)
        return cache[key]

    return ShardedState(mesh, shard_light, tuple(
        SceneState(**{f.name: place(f.name, r, d)
                      for f in dataclasses.fields(state)})
        for r in range(rows) for d in range(nd)))


def unshard_state(sharded: ShardedState) -> SceneState:
    """The global state of a `ShardedState`, on `mesh.root`."""
    mesh = sharded.mesh
    first = sharded.local(0, 0)
    plan = state_shardings(mesh, first, shard_light=sharded.shard_light)

    def whole(name):
        kind = plan[name]
        if kind == "volumes":
            parts, axis = [sharded.local(0, d) for d in
                           range(mesh.n_volumes_axis)], 0
        elif kind == "rows":
            parts, axis = [sharded.local(r, 0) for r in range(mesh.rows)], 1
        else:
            return getattr(first, name)
        return torch.cat([collectives.to_device(getattr(p, name), mesh.root)
                          for p in parts], dim=axis)

    return SceneState(**{f.name: whole(f.name)
                         for f in dataclasses.fields(first)})


def make_sharded_step(cfg: RenderConfig, mesh: DeviceMesh):
    """step(sharded_state, camera) -> (image on `mesh.root`, sharded
    state): the frame with TAA on the mesh."""

    def step(state: ShardedState, camera):
        out = frame_lib.render_frame(state, camera, cfg, use_taa=True,
                                     mesh=mesh)
        return out.image, out.state

    return step


def _devices(n_devices: int, device) -> list:
    """`n_devices` mesh entries on `device` (logical shards of it), or,
    for "cuda" on a machine with that many cards, the cards."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if torch.cuda.device_count() >= n_devices:
            return [torch.device("cuda", i) for i in range(n_devices)]
        device = torch.device("cuda", torch.cuda.current_device())
    return [device] * n_devices


def placement_check(n_devices: int, shard_light: bool = False,
                    device="cuda") -> dict:
    """Run one sharded step on a tiny config and verify the movement
    pattern of the plan from the mesh's log:

    * the sweep is partitioned over volumes, so its sharded cube-map
      output must be all-gathered into the screen composite: assert that
      gather exists (N * 6 * 4 * S * S elements);
    * nothing bigger moves per frame (a bigger movement would mean that
      the volume or light stacks travel, which would void the scaling);
    * with `shard_light`, no light stack moves at all and a local stack
      holds N / D volumes.

    Returns a summary dict (also used by the placement test)."""
    cfg = RenderConfig(
        width=96, height=64, grid_size=16, light_grid_size=16,
        max_ray_samples=16, max_light_samples=8,
        num_volumes=max(n_devices, 2), num_volume_srcs=2,
        cube_map_size=8, shadow_map_size=32,
        shard_light_stacks=shard_light,
    )
    mesh = make_mesh(_devices(n_devices, device))
    state = state_lib.create_scene(cfg, device=mesh.root)
    camera = cam_lib.default_camera(cfg.aspect_ratio, device=mesh.root)
    sharded = shard_state(state, mesh, shard_light=shard_light)
    mesh.log.clear()
    make_sharded_step(cfg, mesh)(sharded, camera)
    colls = list(mesh.log)

    n, s = cfg.num_volumes, cfg.cube_map_size
    cube_elems = n * 6 * 4 * s * s
    cube_gathers = [c for c in colls if c[:2] == ("cube_maps", cube_elems)]
    assert cube_gathers, (
        "expected the sharded sweep's cube-map all-gather "
        f"({cube_elems} elems); movements: {colls}")
    too_big = [c for c in colls if c[1] > cube_elems]
    assert not too_big, (
        "movements larger than the cube-map all-gather (the sweep inputs "
        f"or light stacks are moving per frame): {too_big}")
    if shard_light:
        stack = state.light_sweep.numel() // n
        moved = [c for c in colls if c[1] >= stack * (n // n_devices)
                 and c[0] != "cube_maps"]
        assert not moved, f"a light stack moved: {moved}"
        local = sharded.local(0, 0).light_sweep.shape[0]
        assert local == n // n_devices, (local, n, n_devices)
    return {
        "collectives": colls,
        "cube_gather_elems": cube_elems,
        "largest_elems": max(c[1] for c in colls) if colls else 0,
    }


def dryrun(n_devices: int, device="cuda") -> None:
    """Execute one sharded frame step on tiny shapes: on the card by
    default, where the `n_devices` are the machine's cards or, with fewer
    cards than that, logical shards of one."""
    cfg = RenderConfig(
        width=96, height=64, grid_size=16, light_grid_size=8,
        max_ray_samples=16, max_light_samples=8,
        num_volumes=max(n_devices, 2), num_volume_srcs=2,
        cube_map_size=16, shadow_map_size=32,
    )
    devices = _devices(n_devices, device)
    # with >= 4 devices validate the full 2-D (rows x volumes) story:
    # volume-sharded sweep + row-sharded composite/TAA in one step
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh = make_mesh(devices, rows=2)
    else:
        mesh = make_mesh(devices)
    state = state_lib.create_scene(cfg, device=mesh.root)
    camera = cam_lib.default_camera(cfg.aspect_ratio, device=mesh.root)

    step = make_sharded_step(cfg, mesh)
    img, new_state = step(shard_state(state, mesh), camera)
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    assert img.shape == (cfg.height, cfg.width, 3)
    assert new_state.frame_idx == 1
    assert bool(torch.isfinite(img).all())
