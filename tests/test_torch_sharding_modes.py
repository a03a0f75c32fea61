"""The port's sharded frame step in the settings outside the main path:
the reference light and point lights (the gather light march of one
volume a frame), the un-bucketed sweep (`lod_bucket_caps=None`,
`adaptive_raymarch=False`: one B1 launch per volume shard), the warp and
gather composites and the full reference semantics (the reference march
per volume shard, the gather composite with its per-pixel march), on
logical CPU meshes (one device named several times).

Tolerances, each with its source:
* against the port's unsharded frame of the same setting, over two
  frames: images and TAA history at atol 2e-5, the light stacks and the
  outgoing footprints equal (tests/test_sharding.py:41-43; at this
  configuration every volume is in the first LOD bucket with and without
  the per-shard caps);
* against the JAX sharded step (`parallel.sharding.make_sharded_step`,
  which runs each of these settings on the virtual CPU devices:
  `python tests/torch_parity.py` prints how far it is from the JAX
  unsharded frame in each): the golden limits, mean < 2e-3 and p99.9 <
  3e-2 (tests/test_goldens.py);
* the warp composite where per-shard caps move a volume to another LOD
  bucket: the port's sharded frame against the JAX sharded frame at mean
  < 1e-5 and max < 1e-4, f32 reassociation between the packages (both
  take the warp's footprint classes from the global cull and caps;
  ROADMAP.md section C), far below the mean 3.5e-3 and max 0.32 by which
  each parts from its unsharded frame there.

The configuration is that of tests/test_torch_sharding.py (96 x 64, 4
volumes, cube maps 16) in f32, with `light_axis` baked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (clone_state, image_stats, jax_state_dict, n,
                          one_torch_thread, port_camera, port_config)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.parallel import sharding as jsh
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.parallel import sharding as psh
from multivolumes_tpu_torch.render import cull as pcull
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.render import sweep as psw
from multivolumes_tpu_torch.render import tilecast as ptile
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene import state as pstate

assert one_torch_thread  # the module-wide fixture, used by every test

CFG = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                   max_ray_samples=16, max_light_samples=8, num_volumes=4,
                   num_volume_srcs=2, cube_map_size=16, shadow_map_size=32,
                   use_bf16=False, light_axis=2)
CPU = torch.device("cpu")
MESHES = {"4": (4, 1), "2x2": (2, 2)}    # name -> (volume shards, rows)
REFERENCE = dict(march_mode="reference", light_mode="reference",
                 composite_mode="gather")
SETTINGS = {
    "unbucketed": dict(lod_bucket_caps=None),
    "non_adaptive": dict(adaptive_raymarch=False),
    "unbucketed_warp": dict(lod_bucket_caps=None, composite_mode="warp"),
    "unbucketed_gather": dict(lod_bucket_caps=None,
                              composite_mode="gather"),
    "warp": dict(composite_mode="warp"),
    "gather": dict(composite_mode="gather"),
    "reference_light": dict(light_mode="reference"),
    "point_light": dict(point_light=True),
    "reference_march": dict(march_mode="reference"),
    "reference": REFERENCE,
}


def _port_mesh(nd, rows):
    return psh.make_mesh([CPU] * (nd * rows), rows=rows)


@pytest.fixture(scope="module")
def scene():
    """The JAX scene and camera, and the port's copies of them."""
    st = jstate.create_scene(CFG)
    cam = jcam.default_camera(CFG.aspect_ratio)
    return st, cam, pstate.state_from_numpy(jax_state_dict(st)), \
        port_camera(cam)


def _sharded_frames(cfg, ps, cam, nd, rows, shard_light=False, frames=2):
    cfg = cfg.with_(shard_light_stacks=shard_light)
    mesh = _port_mesh(nd, rows)
    step = psh.make_sharded_step(cfg, mesh)
    state = psh.shard_state(clone_state(ps), mesh, shard_light=shard_light)
    images = []
    for _ in range(frames):
        img, state = step(state, cam)
        images.append(img)
    return images, state, mesh


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded frames per setting, made on first use:
    {setting: (images, state)}."""
    return {}


def _unsharded(cache, name, cfg, ps, cam, frames=2):
    if name not in cache:
        state, images = clone_state(ps), []
        for _ in range(frames):
            out = pframe.render_frame(state, cam, cfg)
            state = out.state
            images.append(out.image)
        cache[name] = (images, state)
    return cache[name]


@pytest.mark.parametrize("shard_light", [False, True],
                         ids=["replicated", "shard_light"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_sharded_setting_matches_unsharded_port(scene, unsharded, setting,
                                                mesh_name, shard_light):
    _st, _cam, ps, cam = scene
    cfg = port_config(CFG.with_(**SETTINGS[setting]))
    nd, rows = MESHES[mesh_name]
    images, state, mesh = _sharded_frames(cfg, ps, cam, nd, rows,
                                          shard_light=shard_light)
    want_images, single = _unsharded(unsharded, setting, cfg, ps, cam)
    for img, want in zip(images, want_images):
        assert img.shape == (CFG.height, CFG.width, 3)
        np.testing.assert_allclose(n(img), n(want), atol=2e-5)
    assert state.frame_idx == single.frame_idx == 2
    whole = psh.unshard_state(state)
    np.testing.assert_allclose(n(whole.taa_history), n(single.taa_history),
                               atol=2e-5)
    for name in ("light_maps", "light_sweep", "light_sout"):
        assert torch.equal(getattr(whole, name), getattr(single, name)), name
    names = [c[0] for c in mesh.log]
    assert "cube_maps" in names
    # the light stack moves only for the gather composite's per-pixel
    # march of the reference march, and only when it is sharded
    moves_light = (shard_light and SETTINGS[setting].get("march_mode")
                   == "reference")
    assert ("light_maps" in names) == moves_light


def test_reference_light_refreshes_one_volume_a_frame(scene):
    """Under the reference light each frame rewrites one volume's row of
    the light stacks and no other, on each owner shard: two frames on
    four volume shards with sharded stacks change two rows (each frame's
    volume is the next visible one) and keep the others bit for bit."""
    _st, _cam, ps, cam = scene
    cfg = port_config(CFG.with_(light_mode="reference"))
    before = clone_state(ps)
    _images, state, _mesh = _sharded_frames(cfg, ps, cam, 4, 1,
                                            shard_light=True)
    whole = psh.unshard_state(state)
    changed = [int(v) for v in range(CFG.num_volumes) if not torch.equal(
        whole.light_maps[v], before.light_maps[v])]
    assert changed == [0, 1], changed
    assert torch.equal(whole.light_sout, before.light_sout)


@pytest.mark.parametrize("setting", ["unbucketed", "reference"])
def test_sharded_setting_matches_jax(scene, setting):
    """Two frames of the un-bucketed tile setting and of the full
    reference semantics on 2 rows x 2 volume shards against the JAX
    sharded step."""
    st, jcam_, ps, cam = scene
    jcfg = CFG.with_(**SETTINGS[setting])
    jm_ = jsh.make_mesh(2, rows=2)
    step = jsh.make_sharded_step(jcfg, jm_)
    jst = jsh.shard_state(st, jm_)
    images, state, _mesh = _sharded_frames(port_config(jcfg), ps, cam, 2, 2)
    for k, img in enumerate(images):
        jimg, jst = step(jst, jcam_)
        mean, p999, mx = image_stats(img, jimg, 99.9)
        print(f"{setting} 2x2 frame {k}: mean {mean:.2e} p99.9 {p999:.2e} "
              f"max {mx:.2e}")
        assert mean < 2e-3 and p999 < 3e-2, (k, mean, p999, mx)
    whole = psh.unshard_state(state)
    mean, p999, mx = image_stats(whole.taa_history[:3], jst.taa_history[:3],
                                 99.9)
    assert mean < 2e-3 and p999 < 3e-2, (mean, p999, mx)
    np.testing.assert_allclose(n(whole.light_maps), np.asarray(jst.light_maps),
                               atol=1e-4, rtol=1e-5)


def test_warp_classes_under_per_shard_caps_follow_jax(scene):
    """Caps (2, 1, inf) on 2 volume shards, from an eye close enough that
    every volume projects at mip 0: each shard's divided caps (1, 1, inf)
    march one of its volumes at S, while the warp's footprint classes come
    from the global cull and caps, as in the JAX frame. Volume 2 is then
    marched at S (n_eff 16) on its shard but falls in a global class of
    extent 8, so the warp reads an 8-texel corner of a 16-texel map: the
    sharded warp frame parts from the unsharded one far more than the
    sharded tile frame does (the tile composite has no classes). The port
    does what the JAX package does: its sharded warp frame is the JAX
    sharded warp frame up to f32 reassociation (ROADMAP.md section C)."""
    st, _jc, ps, _pc = scene
    jcfg = CFG.with_(lod_bucket_caps=(2, 1, 1 << 30), composite_mode="warp")
    jcam_ = jcam.make_camera(jnp.array([0.0, 10.0, -30.0]),
                             jnp.array([0.0, 0.0, 0.0]), CFG.aspect_ratio)
    cam = port_camera(jcam_)
    jm_ = jsh.make_mesh(2)
    jimg, _jst = jsh.make_sharded_step(jcfg, jm_)(jsh.shard_state(st, jm_),
                                                  jcam_)
    parted = {}
    for mode in ("warp", "tile"):
        cfg = port_config(jcfg.with_(composite_mode=mode))
        (img,), _state, _mesh = _sharded_frames(cfg, ps, cam, 2, 1,
                                                frames=1)
        want = pframe.render_frame(clone_state(ps), cam, cfg).image
        parted[mode] = image_stats(img, want, 99.9)
        print(f"{mode}: sharded vs unsharded mean {parted[mode][0]:.3e} "
              f"p99.9 {parted[mode][1]:.3e} max {parted[mode][2]:.3e}")
        if mode == "warp":
            mean, _p, mx = image_stats(img, jimg, 99.9)
            assert mean < 1e-5 and mx < 1e-4, (mean, mx)
    assert parted["warp"][0] > 2e-3 and parted["warp"][1] > 0.1
    assert parted["tile"][0] < 2e-3 and parted["tile"][1] < 0.1


@pytest.mark.parametrize("with_depth", [False, True],
                         ids=["plain", "depth_sel"])
def test_tile_prep_of_unsorted_maps_is_contiguous(scene, with_depth):
    """Kernel B2 takes contiguous operands (`ops.check_cuda`). On the
    un-bucketed sweep's maps (volume order, not pre-swapped) the tile
    prep swaps the faces itself, and a `where` over a transposed view
    keeps the view's strides: the un-bucketed frame with the tile
    composite raised on the card. The plain version on the CPU does not
    look at strides, so this holds the operands themselves."""
    _st, _cam, ps, _pc = scene
    # an orbit pose where 6 of the 24 faces take the Catmull-Smith swap
    cam = pcam.orbit_camera(1.7, CFG.aspect_ratio, device="cpu")
    po = build_per_object(ps.volume_worlds, cam.view_proj)
    cull = pcull.cull_volumes(po, cam.eye, [CFG.width, CFG.height],
                              CFG.max_ray_samples, CFG.cube_map_size,
                              CFG.num_cube_mips)
    cull = cull._replace(mip_level=torch.zeros_like(cull.mip_level),
                         use_cube_map=cull.visible)
    dm = None
    if with_depth:
        yy, xx = torch.meshgrid(torch.arange(64.0), torch.arange(96.0),
                                indexing="ij")
        dm = torch.where((yy - 32.0) ** 2 + (xx - 48.0) ** 2 < 20.0 ** 2,
                         0.9885, 1.0)
    maps = psw.ray_march_view_sweep(
        ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep, po, cull, cam.eye,
        dm, CFG.cube_map_size, vol_zmax=ps.vol_zmax)
    color_sel, depth_sel = ptile._tile_prep(
        maps, po, cull, cam.eye, cam.screen_to_world, CFG.width, CFG.height,
        depth_map=dm)[:2]
    # some faces are swapped, so the prep did transpose
    assert not torch.equal(color_sel, maps.color)
    assert color_sel.is_contiguous()
    assert (depth_sel is not None) == with_depth
    if with_depth:
        assert depth_sel.is_contiguous()
