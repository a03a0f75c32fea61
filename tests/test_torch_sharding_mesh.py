"""The opaque mesh under a device mesh: the port's row-banded raster and
shade and the sharded frame step with the mesh, against the JAX package
and against the port's own unsharded mesh pass and frame, on logical CPU
meshes (one device named several times) and the procedural test torus
(`torch_parity.write_test_mesh`, about 2k triangles) loaded through the
JAX engine's `set_mesh` and carried across.

Tolerances, each with its source:
* a raster band against the JAX banded raster (`rasterize(band=...)`):
  the triangle ids equal on every pixel either covers, the depth within
  one 15-bit quantisation step (2^-15) where both cover, as
  tests/test_torch_mesh.py holds the unbanded raster;
* the port's bands stacked in order against its unbanded raster: bit for
  bit (the same samples enter the same per-pixel minimum);
* `render_mesh_sharded` against the unsharded one: colour and
  velocity at atol 1e-5 (per-pixel work cut into other pieces), validity
  and depth equal;
* the whole sharded step with the mesh against the JAX sharded step on 2
  rows x 2 volume shards: the golden limits, mean < 2e-3 and p99.9 <
  3e-2 (tests/test_sharding.py:81-128 holds the JAX step against its
  unsharded frame; the port's frame is held against the JAX frame at
  these limits in tests/test_torch_mesh.py);
* the sharded step with the mesh against the port's unsharded mesh
  frame: images and history at atol 2e-5 (tests/test_sharding.py:41-43;
  at this configuration every volume is in the first LOD bucket with and
  without the per-shard caps), light maps and `mesh_prev_wvp` equal.

The configuration is tests/test_torch_mesh.py's (160 x 120, 4 volumes,
f32, `light_axis` baked, a far-preset bound of 80 px, a shade window of
96 and a reprojection window of 112): 120 and 96 split into 2 and 3
row bands, so the shade window is banded too; 5 rows split the screen
but not the window, which the root then shades."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (clone_state, image_stats, jax_state_dict, n,
                          one_torch_thread, port_camera, port_config, t,
                          write_test_mesh)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.engine import MultiRayCaster as JaxEngine
from multivolumes_tpu.parallel import sharding as jsh
from multivolumes_tpu.render import mesh as jmesh
from multivolumes_tpu_torch.parallel import sharding as psh
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.render import mesh as pmesh
from multivolumes_tpu_torch.scene import state as pstate

assert one_torch_thread  # the module-wide fixture, used by every test

CFG = RenderConfig(width=160, height=120, grid_size=16, light_grid_size=8,
                   max_ray_samples=24, max_light_samples=8, num_volumes=4,
                   num_volume_srcs=2, cube_map_size=32, shadow_map_size=64,
                   use_bf16=False, light_axis=2, raster_far_bound=80,
                   mesh_shade_window=96, taa_reproj_window=112)
CPU = torch.device("cpu")
ZSTEP = 2.0 ** -15
# two frames looking down on the mesh, whose box projects at 79-84 px
# (inside the far preset's hysteresis ceiling) and which covers every
# band of 2 and of 3 rows
EYES = ((0.0, 19.0, 10.5), (0.5, 19.0, 11.0))
FOCUS = (0.0, -5.4, 0.0)
PRESETS = ("near", "far")
MESHES = {"4": (4, 1), "2x2": (2, 2)}    # name -> (volume shards, rows)
BANDS = [(rows, r) for rows in (2, 3) for r in range(rows)]


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The JAX engine with the test mesh: (config with the far ladder,
    state)."""
    path = write_test_mesh(tmp_path_factory.mktemp("mesh") / "torus.obj",
                           2000)
    je = JaxEngine(CFG)
    je.set_mesh(path)
    assert je.config.raster_far_tiers, "the test mesh needs a far ladder"
    return je.config, je.state


@pytest.fixture(scope="module")
def port_state(jax_mesh):
    return pstate.state_from_numpy(jax_state_dict(jax_mesh[1]))


def _cfg(cfg, preset):
    return cfg.with_(raster_preset=preset)


def _port_mesh(nd, rows):
    return psh.make_mesh([CPU] * (nd * rows), rows=rows)


def _jax_camera(k):
    return jcam.make_camera(jnp.array(EYES[k]), jnp.array(FOCUS),
                            CFG.aspect_ratio)


# --- the banded raster ----------------------------------------------------

def _jax_banded_raster(pcfg, idx, kw, rows):
    """The JAX `rasterize(band=(r, rows))`, jitted with the band index r
    traced (its dense window given, which the band mode ignores)."""
    jidx = jnp.asarray(idx.numpy().astype(np.int32))
    jkw = dict(kw, dense_window=pcfg.mesh_shade_window)
    return jax.jit(lambda v, r: jmesh.rasterize(
        v, jidx, pcfg.width, pcfg.height, band=(r, rows), **jkw))


@pytest.fixture(scope="module")
def raster_case(jax_mesh, port_state):
    """Per preset: the jittered clip positions of a frame, the raster
    levers, the JAX banded raster jitted once per band count (the band
    index traced) and the port's unbanded rasters without and with the
    dense window."""
    cfg, st = jax_mesh
    cam = port_camera(_jax_camera(0))
    out = {}
    for preset in PRESETS:
        pcfg = port_config(_cfg(cfg, preset))
        op = pmesh._frame_operands(port_state, cam, pcfg)
        idx = port_state.mesh_indices
        kw = op.raster_kw
        jitted = {rows: _jax_banded_raster(pcfg, idx, kw, rows)
                  for rows in (2, 3)}
        whole = pmesh.rasterize(op.clip_jit, idx, pcfg.width, pcfg.height,
                                **kw)
        window = pmesh.rasterize(op.clip_jit, idx, pcfg.width, pcfg.height,
                                 dense_window=pcfg.mesh_shade_window, **kw)
        out[preset] = (pcfg, op, kw, jitted, whole, window)
    return out


@pytest.mark.parametrize("rows,r", BANDS, ids=[f"{r}of{rows}"
                                               for rows, r in BANDS])
@pytest.mark.parametrize("preset", PRESETS)
def test_raster_band_matches_jax(raster_case, port_state, preset, rows, r):
    pcfg, op, kw, jitted, _whole, _window = raster_case[preset]
    dj, tj = jitted[rows](jnp.asarray(n(op.clip_jit)), jnp.int32(r))
    dp, tp = pmesh.rasterize(op.clip_jit, port_state.mesh_indices,
                             pcfg.width, pcfg.height, band=(r, rows), **kw)
    assert tuple(tp.shape) == (pcfg.height // rows, pcfg.width)
    tj, tp = np.asarray(tj), tp.numpy()
    either = (tj >= 0) | (tp >= 0)
    share = float((tj == tp)[either].mean())
    print(f"{preset} band {r} of {rows}: tri_id agrees on {share:.6f} of "
          f"{int(either.sum())} pixels")
    assert either.sum() > 200 and share == 1.0
    both = (tj >= 0) & (tp >= 0)
    assert np.abs(n(dp)[both] - n(dj)[both]).max() <= ZSTEP


@pytest.mark.parametrize("rows", [2, 3])
@pytest.mark.parametrize("preset", PRESETS)
def test_raster_bands_assemble_the_unbanded_raster(raster_case, port_state,
                                                   preset, rows):
    """Bit for bit against the raster without a dense window; under the
    far preset also against the raster with the window, which contains
    the mesh."""
    pcfg, op, kw, _jitted, whole, window = raster_case[preset]
    bands = [pmesh.rasterize(op.clip_jit, port_state.mesh_indices,
                             pcfg.width, pcfg.height, band=(r, rows), **kw)
             for r in range(rows)]
    depth = torch.cat([b[0] for b in bands])
    tri = torch.cat([b[1] for b in bands])
    assert int((tri >= 0).sum()) > 200
    assert torch.equal(depth, whole[0]) and torch.equal(tri, whole[1])
    if preset == "far":
        assert torch.equal(depth, window[0]) and torch.equal(tri, window[1])


def test_banded_raster_refuses_what_jax_refuses(port_state):
    """A band count that does not divide the rows, and the unpacked path
    (no ids), raise instead of returning a wrong band."""
    clip = torch.tensor([[-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0],
                         [0.0, 0.6, 0.5, 1.0]])
    idx = torch.tensor([[0, 1, 2]])
    with pytest.raises(ValueError, match="bands"):
        pmesh.rasterize(clip, idx, 32, 30, band=(0, 4))
    with pytest.raises(ValueError, match="packed-id"):
        pmesh.rasterize(clip, idx, 32, 32, want_ids=False, band=(0, 2))
    # the sentinel and the samples of other bands land in the drop slot:
    # the lower band of a triangle in the upper half is empty
    top = torch.tensor([[-0.5, 0.2, 0.5, 1.0], [0.5, 0.2, 0.5, 1.0],
                        [0.0, 0.9, 0.5, 1.0]])
    d, tri = pmesh.rasterize(top, idx, 32, 32, k=32, band=(1, 2))
    assert bool((tri == -1).all()) and bool((d == 1.0).all())
    d, tri = pmesh.rasterize(top, idx, 32, 32, k=32, band=(0, 2))
    assert int((tri == 0).sum()) > 20


# --- the mesh pass under a device mesh ------------------------------------

@pytest.mark.parametrize("layout", ["vol2", "rows2", "rows3", "rows5"])
@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_render_mesh_matches_unsharded(jax_mesh, port_state,
                                               preset, layout):
    """`render_mesh_sharded` against `render_mesh`: on 2 and 3
    rows the raster and the shade window are banded, on 5 the window is
    shaded on the root, on a 1-D volume mesh the pass is replicated."""
    cfg, _st = jax_mesh
    pcfg = port_config(_cfg(cfg, preset))
    cam = port_camera(_jax_camera(0))
    if layout == "vol2":
        mesh = psh.make_mesh([CPU] * 2)
    else:
        mesh = _port_mesh(1, int(layout[4:]))
    want = pmesh.render_mesh(port_state, cam, pcfg)
    got = pmesh.render_mesh_sharded({CPU: port_state}, {CPU: cam}, pcfg,
                                    mesh)[CPU]
    assert int(want.valid.sum()) > 200
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.depth, want.depth)
    for g, w in zip(got.color + got.velocity, want.color + want.velocity):
        np.testing.assert_allclose(n(g), n(w), atol=1e-5)
    assert torch.equal(got.new_prev_wvp, want.new_prev_wvp)
    for g, w in zip(got.screen_center, want.screen_center):
        assert torch.equal(g, w)
    names = [c[0] for c in mesh.log]
    if layout == "vol2":
        assert names == []
    else:
        assert names[0] == "mesh_depth"
        # a window that does not split into the rows is shaded on the
        # root straight into the screen: no piece to gather
        assert ("mesh_shade" in names) == (preset != "far"
                                           or layout != "rows5")
        assert ("mesh_tri_id" in names) == (preset == "far")


# --- the sharded step with the mesh ---------------------------------------

def _sharded_frames(pcfg, ps, nd, rows, shard_light=False):
    cfg = pcfg.with_(shard_light_stacks=shard_light)
    mesh = _port_mesh(nd, rows)
    step = psh.make_sharded_step(cfg, mesh)
    state = psh.shard_state(clone_state(ps), mesh, shard_light=shard_light)
    images = []
    for k in range(len(EYES)):
        img, state = step(state, port_camera(_jax_camera(k)))
        images.append(img)
    return images, state, mesh


@pytest.fixture(scope="module")
def unsharded_frames(jax_mesh, port_state):
    """The port's unsharded mesh frames, per preset: (images, state)."""
    cfg, _st = jax_mesh
    out = {}
    for preset in PRESETS:
        pcfg = port_config(_cfg(cfg, preset))
        state, images = clone_state(port_state), []
        for k in range(len(EYES)):
            o = pframe.render_frame(state, port_camera(_jax_camera(k)),
                                    pcfg)
            state = o.state
            images.append(o.image)
        # the mesh is on screen, opaque
        assert float((o.hdr[..., 3] > 0.999).float().mean()) > 0.05
        out[preset] = (images, state)
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_mesh_step_matches_jax(jax_mesh, port_state, preset):
    """Two frames with TAA on 2 rows x 2 volume shards (the banded
    raster; under the far preset the banded shade window and the
    windowed reprojection, under the near one the full-screen shade and
    reprojection): the counterpart of the JAX package's
    `test_sharded_2d_mesh_with_object`, on the test torus."""
    cfg, st = jax_mesh
    cfg = _cfg(cfg, preset)
    jm_ = jsh.make_mesh(2, rows=2)
    step = jsh.make_sharded_step(cfg, jm_)
    jst = jsh.shard_state(st, jm_)
    images, state, mesh = _sharded_frames(port_config(cfg), port_state, 2, 2)
    for k, img in enumerate(images):
        jimg, jst = step(jst, _jax_camera(k))
        mean, p999, mx = image_stats(img, jimg, 99.9)
        print(f"{preset} 2x2 mesh frame {k}: mean {mean:.2e} p99.9 {p999:.2e} "
              f"max {mx:.2e}")
        assert img.shape == (CFG.height, CFG.width, 3)
        assert mean < 2e-3 and p999 < 3e-2, (k, mean, p999, mx)
    assert state.frame_idx == int(jst.frame_idx) == 2
    whole = psh.unshard_state(state)
    mean, p999, mx = image_stats(whole.taa_history[:3], jst.taa_history[:3],
                                 99.9)
    assert mean < 2e-3 and p999 < 3e-2, (mean, p999, mx)
    np.testing.assert_allclose(n(whole.mesh_prev_wvp),
                               np.asarray(jst.mesh_prev_wvp), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(whole.light_maps), np.asarray(jst.light_maps),
                               atol=1e-4, rtol=1e-5)
    names = [c[0] for c in mesh.log]
    assert "mesh_depth" in names and "cube_depth" in names


@pytest.mark.parametrize("shard_light", [False, True],
                         ids=["replicated", "shard_light"])
@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_mesh_step_matches_unsharded_port(
        jax_mesh, port_state, unsharded_frames, preset, name, shard_light):
    cfg, _st = jax_mesh
    pcfg = port_config(_cfg(cfg, preset))
    nd, rows = MESHES[name]
    images, state, _mesh = _sharded_frames(pcfg, port_state, nd, rows,
                                           shard_light=shard_light)
    want_images, single = unsharded_frames[preset]
    for img, want in zip(images, want_images):
        np.testing.assert_allclose(n(img), n(want), atol=2e-5)
    whole = psh.unshard_state(state)
    np.testing.assert_allclose(n(whole.taa_history), n(single.taa_history),
                               atol=2e-5)
    assert torch.equal(whole.light_maps, single.light_maps)
    assert torch.equal(whole.mesh_prev_wvp, single.mesh_prev_wvp)
    # every local state carries the new previous-frame matrix
    for loc in state.locals:
        assert torch.equal(loc.mesh_prev_wvp, single.mesh_prev_wvp)


def test_shard_state_carries_the_mesh(port_state):
    """The mesh fields are replicated: every local view holds them,
    logical shards of one device share each tensor, and `unshard_state`
    returns them as they were."""
    mesh = _port_mesh(2, 2)
    sharded = psh.shard_state(port_state, mesh)
    plan = psh.state_shardings(mesh, port_state)
    fields = ("mesh_verts", "mesh_indices", "mesh_world", "mesh_prev_wvp",
              "mesh_shadow_map")
    assert all(plan[f] == "rep" for f in fields)
    first = sharded.local(0, 0)
    assert first.mesh_indices.shape[0] > 1000
    for loc in sharded.locals:
        for f in fields:
            assert getattr(loc, f) is getattr(first, f)
    whole = psh.unshard_state(sharded)
    for f in fields:
        assert torch.equal(getattr(whole, f), getattr(port_state, f))


def test_sharded_unbucketed_mesh_step_matches_unsharded_port(jax_mesh,
                                                             port_state):
    """The un-bucketed sweep with the mesh on 2 rows x 2 volume shards:
    one B1 launch per volume shard whose rays the replicated depth map
    bounds, the tile composite in row bands on unsorted maps (B2' band),
    two frames against the port's unsharded frames of the same setting."""
    cfg, _st = jax_mesh
    pcfg = port_config(_cfg(cfg, "far")).with_(lod_bucket_caps=None)
    images, state, mesh = _sharded_frames(pcfg, port_state, 2, 2)
    single = clone_state(port_state)
    for k, img in enumerate(images):
        out = pframe.render_frame(single, port_camera(_jax_camera(k)), pcfg)
        single = out.state
        np.testing.assert_allclose(n(img), n(out.image), atol=2e-5)
    assert float((out.hdr[..., 3] > 0.999).float().mean()) > 0.05
    whole = psh.unshard_state(state)
    np.testing.assert_allclose(n(whole.taa_history), n(single.taa_history),
                               atol=2e-5)
    assert torch.equal(whole.light_maps, single.light_maps)
    assert torch.equal(whole.mesh_prev_wvp, single.mesh_prev_wvp)
    names = [c[0] for c in mesh.log]
    assert "cube_depth" in names and "sweep_order" not in names
