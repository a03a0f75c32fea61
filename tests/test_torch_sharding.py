"""The port's sharded frame step against the JAX package and against the
port's own unsharded frame, on logical CPU meshes (one device named
several times, the counterpart of the JAX tests' virtual CPU devices).

Tolerances, each with its source:
* the row-band TAA resolve (B5') and the `tile_row0` band composite
  against their unsharded plain versions: equal, max error 0.0 (the same
  per-pixel arithmetic on the same values);
* B5' against the JAX `taa_kernel.taa_resolve_sharded` (Pallas, interpret
  mode): atol 2e-5 (tests/test_pallas_taa.py:31-34);
* the band composite against the JAX `composite_oit_tile_sharded`: mean
  < 3e-3, p99.5 < 3e-2 (tests/test_warp.py:172-173);
* the sharded sweep against the JAX `ray_march_view_sweep_lod_sharded`
  (impl="xla"): atol 2e-3, rtol 2e-2 (tests/test_pallas_sweep.py:46,79);
  order, mips and flags exact;
* the whole step against the JAX sharded step: the golden limits, mean
  < 2e-3 and p99.9 < 3e-2; against the port's unsharded frame: atol 2e-5
  (tests/test_sharding.py:41-43; at this configuration every volume is in
  the first LOD bucket with and without the per-shard caps).

The configuration is that of tests/test_sharding.py (96 x 64, 4 volumes,
cube maps 16) in f32, with `light_axis` baked on the JAX side (ROADMAP.md,
section C)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (clone_state, image_stats, jax_state_dict, n,
                          one_torch_thread, port_camera, port_config,
                          port_cull, port_per_object, t, taa_operands)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.ops.pallas import taa_kernel as jtk
from multivolumes_tpu.parallel import sharding as jsh
from multivolumes_tpu.render import cull as jcull
from multivolumes_tpu.render import sweep as jsw
from multivolumes_tpu.render import tilecast as jtile
from multivolumes_tpu.render import warp as jwarp
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch.ops import composite as pcomp_ops
from multivolumes_tpu_torch.ops import taa as ptaa_ops
from multivolumes_tpu_torch.parallel import collectives as coll
from multivolumes_tpu_torch.parallel import sharding as psh
from multivolumes_tpu_torch.render import cull as pcull
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.render import sweep as psw
from multivolumes_tpu_torch.render import taa as ptaa
from multivolumes_tpu_torch.render import tilecast as ptile
from multivolumes_tpu_torch.render import warp as pwarp
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.render.raymarch import CubeMaps
from multivolumes_tpu_torch.scene import state as pstate

assert one_torch_thread  # the module-wide fixture, used by every test

CFG = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                   max_ray_samples=16, max_light_samples=8, num_volumes=4,
                   num_volume_srcs=2, cube_map_size=16, shadow_map_size=32,
                   use_bf16=False, light_axis=2)
CPU = torch.device("cpu")
MESHES = {"4": (4, 1), "2x2": (2, 2)}    # name -> (volume shards, rows)


def _port_mesh(nd, rows):
    return psh.make_mesh([CPU] * (nd * rows), rows=rows)


@pytest.fixture(scope="module")
def jax_scene():
    st = jstate.create_scene(CFG)
    return st, jcam.default_camera(CFG.aspect_ratio)


@pytest.fixture(scope="module")
def port_scene(jax_scene):
    st, cam = jax_scene
    return pstate.state_from_numpy(jax_state_dict(st)), port_camera(cam)


# --- B5': the row-band TAA resolve ---------------------------------------

@pytest.mark.parametrize("rows", [1, 2, 3])
def test_taa_resolve_sharded_equals_whole_image(rows):
    """Bands of ceil(50 / rows) rows, the last one shorter."""
    cur, hist, blur = taa_operands(CPU, 50, 72, seed=rows)
    want = ptaa_ops.taa_resolve_plain(cur, hist, blur)
    mesh = _port_mesh(1, rows)
    got = ptaa_ops.taa_resolve_sharded(mesh, cur, hist, blur)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) == 0.0
    assert [c[:2] for c in mesh.log] == [
        ("halo_rows", 2 * (rows - 1) * 4 * 72), ("taa_rows", 4 * 50 * 72)]
    assert all(nbytes == 4 * elems for _n, elems, nbytes in mesh.log)


def test_taa_resolve_sharded_matches_jax():
    cur, hist, blur = taa_operands(CPU, 50, 72, seed=7)
    want = jtk.taa_resolve_sharded(
        jsh.make_mesh(1, rows=2), jnp.asarray(n(cur)), jnp.asarray(n(hist)),
        jnp.asarray(n(blur)), interpret=True)
    got = ptaa_ops.taa_resolve_sharded(_port_mesh(1, 2), cur, hist, blur)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-5)


def test_temporal_aa_on_a_rows_mesh():
    """`temporal_aa(device_mesh=...)` resolves in bands, equal to the
    whole-image call, and refuses the fused tone map there."""
    cur, hist, blur = taa_operands(CPU, 40, 48, seed=3)
    mesh = _port_mesh(2, 2)
    rgb, nh = ptaa.temporal_aa(tuple(cur), hist, None, device_mesh=mesh)
    rgb0, nh0 = ptaa.temporal_aa(tuple(cur), hist, None)
    assert torch.equal(nh, nh0) and torch.equal(rgb[1], rgb0[1])
    with pytest.raises(ValueError, match="tone map"):
        ptaa.temporal_aa(tuple(cur), hist, None, tonemap_out=True,
                         device_mesh=mesh)


def test_halo_rows_replicates_the_edges():
    x = torch.arange(2 * 7 * 3, dtype=torch.float32).reshape(2, 7, 3)
    mesh = _port_mesh(1, 3)
    bands = [x[:, y0:y1] for y0, y1 in ptaa_ops.row_bands(7, 3)]
    assert [b.shape[1] for b in bands] == [3, 3, 1]
    halos = coll.halo_rows(bands, mesh)
    pad = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    y = 0
    for b, h in zip(bands, halos):
        assert torch.equal(h, pad[:, y:y + b.shape[1] + 2])
        y += b.shape[1]


# --- the band composite ---------------------------------------------------

@pytest.fixture(scope="module")
def band_case(port_scene):
    """The port's tile-prep operands of a 128 x 160 frame (three rows of
    64-row tiles) with a synthetic scene depth (a near disc), so that the
    depth variant has mesh tiles."""
    ps, _cam = port_scene
    cfg = port_config(CFG.with_(width=128, height=160))
    cam = port_camera(jcam.default_camera(cfg.aspect_ratio))
    po = build_per_object(ps.volume_worlds, cam.view_proj)
    cull = pcull.cull_volumes(po, cam.eye, [cfg.width, cfg.height],
                              cfg.max_ray_samples, cfg.cube_map_size,
                              cfg.num_cube_mips)
    yy, xx = torch.meshgrid(torch.arange(160.0), torch.arange(128.0),
                            indexing="ij")
    disc = (yy - 90.0) ** 2 + (xx - 60.0) ** 2 < 40.0 ** 2
    depth = torch.where(disc, 0.9885, 1.0)   # cuts through the volumes
    basis = pwarp.screen_basis(cam.screen_to_world, cam.eye)
    out = {}
    for with_depth in (False, True):
        dm = depth if with_depth else None
        sw = psw.ray_march_view_sweep_lod(
            ps.volumes_sweep, ps.vol_tex_ids, ps.light_sweep, po,
            cull._replace(use_cube_map=cull.visible), cam.eye,
            cfg.cube_map_size, basis, vol_zmax=ps.vol_zmax, depth_map=dm)
        out[with_depth] = (sw, cull._replace(mip_level=sw.mips), dm)
    return cfg, cam, po, out


@pytest.mark.parametrize("with_depth", [False, True],
                         ids=["plain", "depth_sel"])
@pytest.mark.parametrize("rows", [2, 3])
def test_band_composite_equals_full(band_case, rows, with_depth):
    cfg, cam, po, cases = band_case
    sw, cull_c, dm = cases[with_depth]
    (color, depth_sel, scene, tlist, counts, vol_flt, face_flt, _s, th, tw,
     tiles_x, k) = ptile._tile_prep(
        sw.cube_maps, po, cull_c, cam.eye, cam.screen_to_world, cfg.width,
        cfg.height, order=sw.order, swap_sorted=sw.swap, depth_map=dm,
        rows_mult=rows)
    assert (depth_sel is not None) == with_depth
    tiles_y = scene.shape[0] // th
    assert tiles_y % rows == 0 and tiles_y >= 3
    full = pcomp_ops.tile_composite_plain(
        color, scene, tlist, counts, vol_flt, face_flt, th, tw, tiles_x, k,
        cfg.width, cfg.height, depth_sel=depth_sel)
    assert float(full[3].max()) > 0.2
    ty = tiles_y // rows
    for r in range(rows):
        t0, t1 = r * ty * tiles_x, (r + 1) * ty * tiles_x
        band = pcomp_ops.tile_composite(
            color, scene[r * ty * th:(r + 1) * ty * th], tlist[t0:t1],
            counts[t0:t1], vol_flt, face_flt, th, tw, tiles_x, k, cfg.width,
            cfg.height, depth_sel=depth_sel, tile_row0=r * ty)
        want = full[:, r * ty * th:(r + 1) * ty * th]
        assert float((band - want).abs().max()) == 0.0, r
    # the sharded entry point assembles the same image
    mesh = _port_mesh(1, rows)
    rep = lambda x: {CPU: x}                                  # noqa: E731
    got = ptile.composite_oit_tile_sharded(
        mesh, rep(sw.cube_maps), rep(po), rep(cull_c), rep(cam.eye),
        rep(cam.screen_to_world), cfg.width, cfg.height, num_layers=8,
        order=rep(sw.order), swap_sorted=rep(sw.swap),
        depth_map=None if dm is None else rep(dm))
    assert torch.equal(torch.stack(got),
                       full[:, :cfg.height, :cfg.width])


# --- the sharded sweep ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_sweep(jax_scene):
    """The JAX sharded LOD sweep (impl="xla") over 4 virtual devices."""
    st, cam = jax_scene
    po = jbpo(st.volume_worlds, cam.view_proj)
    cull = jcull.cull_volumes(
        po, cam.eye, jnp.array([CFG.width, CFG.height], jnp.float32),
        CFG.max_ray_samples, CFG.cube_map_size, CFG.num_cube_mips)
    lod_cull = cull._replace(use_cube_map=cull.visible)
    s2w = jm.inverse(cam.view_proj)
    basis = jwarp.screen_basis(s2w, cam.eye)
    mesh = jsh.make_mesh(4)
    out = jax.jit(lambda s_: jsw.ray_march_view_sweep_lod_sharded(
        mesh, s_.volumes_oriented, s_.vol_tex_ids, s_.light_maps_oriented,
        po, lod_cull, cam.eye, None, CFG.cube_map_size, dtype=jnp.float32,
        bucket_caps=CFG.lod_bucket_caps, impl="xla", pack=False,
        light_w=CFG.light_grid_size, vol_zmax=s_.vol_zmax,
        sorted_output=True, swap_basis=basis))(st)
    return po, lod_cull, s2w, basis, out


def _port_sharded_sweep(ps, po, lod_cull, eye, basis, nd, caps,
                        light_sharded=False):
    mesh = _port_mesh(nd, 1)
    nl = ps.vol_tex_ids.shape[0] // nd
    rep = lambda x: {CPU: x}                                  # noqa: E731
    light = ([ps.light_sweep[d * nl:(d + 1) * nl] for d in range(nd)]
             if light_sharded else rep(ps.light_sweep))
    return mesh, psw.ray_march_view_sweep_lod_sharded(
        mesh, rep(ps.volumes_sweep),
        [ps.vol_tex_ids[d * nl:(d + 1) * nl] for d in range(nd)], light,
        rep(po), rep(lod_cull), rep(eye), CFG.cube_map_size, rep(basis),
        bucket_caps=caps, vol_zmax=rep(ps.vol_zmax),
        light_sharded=light_sharded)[CPU]


def test_sharded_sweep_matches_jax(jax_scene, port_scene, jax_sweep):
    _st, cam = jax_scene
    ps, _pcam = port_scene
    po, lod_cull, _s2w, basis, (maps, mips, order, swap) = jax_sweep
    mesh, got = _port_sharded_sweep(
        ps, port_per_object(po), port_cull(lod_cull), t(cam.eye), t(basis),
        4, CFG.lod_bucket_caps)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(got.mips.numpy(), np.asarray(mips))
    np.testing.assert_array_equal(got.swap.numpy(), np.asarray(swap))
    assert float(n(maps.color)[:, :, 3].max()) > 0.2
    np.testing.assert_allclose(n(got.cube_maps.color), n(maps.color),
                               atol=2e-3, rtol=2e-2)
    s = CFG.cube_map_size
    assert ("cube_maps", 4 * 6 * 4 * s * s) in [c[:2] for c in mesh.log]


@pytest.mark.parametrize("light_sharded", [False, True],
                         ids=["replicated", "light_sharded"])
def test_sharded_sweep_stitches_its_shards(port_scene, light_sharded):
    """Two shards of two volumes with caps (2, 2, inf): each shard is the
    unsharded sweep of its rows with the caps halved, its order offset by
    its first volume; the global order is a permutation."""
    ps, cam = port_scene
    po = build_per_object(ps.volume_worlds, cam.view_proj)
    cull = pcull.cull_volumes(po, cam.eye, [CFG.width, CFG.height],
                              CFG.max_ray_samples, CFG.cube_map_size,
                              CFG.num_cube_mips)
    lod_cull = cull._replace(use_cube_map=cull.visible)
    basis = pwarp.screen_basis(cam.screen_to_world, cam.eye)
    caps = (2, 2, 1 << 30)
    _mesh, got = _port_sharded_sweep(ps, po, lod_cull, cam.eye, basis, 2,
                                     caps, light_sharded=light_sharded)
    assert sorted(got.order.tolist()) == [0, 1, 2, 3]
    for d in range(2):
        rows = slice(2 * d, 2 * d + 2)
        want = psw.ray_march_view_sweep_lod(
            ps.volumes_sweep, ps.vol_tex_ids[rows], ps.light_sweep[rows],
            po.take(rows), lod_cull.take(rows), cam.eye, CFG.cube_map_size,
            basis, bucket_caps=(1, 1, 1 << 30), vol_zmax=ps.vol_zmax)
        assert torch.equal(got.cube_maps.color[rows], want.cube_maps.color)
        assert torch.equal(got.order[rows], want.order + 2 * d)
        assert torch.equal(got.mips[rows], want.mips)
        assert torch.equal(got.swap[rows], want.swap)


def test_band_composite_matches_jax(jax_scene, jax_sweep):
    """The port's row-sharded composite against the JAX package's, on the
    JAX sharded sweep's cube maps (Pallas in interpret mode, 2 rows)."""
    _st, cam = jax_scene
    po, lod_cull, s2w, _basis, out = jax_sweep
    # off the sweep's four devices: the composite runs on a mesh of two
    maps, mips, order, swap = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x)), out)
    cull_c = lod_cull._replace(mip_level=mips)
    want = jtile.composite_oit_tile_sharded(
        jsh.make_mesh(1, rows=2), maps, po, cull_c, cam.eye, s2w, None,
        CFG.width, CFG.height, num_layers=CFG.oit_layers, interpret=True,
        order=order, swap_sorted=swap)
    rep = lambda x: {CPU: x}                                  # noqa: E731
    got = ptile.composite_oit_tile_sharded(
        _port_mesh(1, 2), rep(CubeMaps(t(maps.color), None)),
        rep(port_per_object(po)), rep(port_cull(cull_c)), rep(t(cam.eye)),
        rep(t(s2w)), CFG.width, CFG.height, num_layers=CFG.oit_layers,
        order=rep(torch.from_numpy(np.asarray(order))),
        swap_sorted=rep(torch.from_numpy(np.asarray(swap))))
    assert float(np.asarray(want[3]).max()) > 0.2
    mean, p995, mx = image_stats(torch.stack(got), jnp.stack(want), 99.5)
    print(f"band composite vs JAX: mean {mean:.2e} p99.5 {p995:.2e} "
          f"max {mx:.2e}")
    assert mean < 3e-3 and p995 < 3e-2, (mean, p995, mx)


# --- the slice as a whole -------------------------------------------------

def _port_frames(ps, cam, nd, rows, frames=2, shard_light=False):
    cfg = port_config(CFG.with_(shard_light_stacks=shard_light))
    mesh = _port_mesh(nd, rows)
    step = psh.make_sharded_step(cfg, mesh)
    state = psh.shard_state(clone_state(ps), mesh, shard_light=shard_light)
    images = []
    for _ in range(frames):
        img, state = step(state, cam)
        images.append(img)
    return images, state, mesh


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_step_matches_jax(jax_scene, port_scene, name):
    """Two frames (the second blends the TAA history) on the meshes (4,)
    and (2 rows x 2)."""
    nd, rows = MESHES[name]
    st, cam = jax_scene
    ps, pcam = port_scene
    jmesh = jsh.make_mesh(nd, rows=rows)
    step = jsh.make_sharded_step(CFG, jmesh)
    jst = jsh.shard_state(st, jmesh)
    images, state, _mesh = _port_frames(ps, pcam, nd, rows)
    for k, img in enumerate(images):
        jimg, jst = step(jst, cam)
        mean, p999, mx = image_stats(img, jimg, 99.9)
        print(f"{name} frame {k}: mean {mean:.2e} p99.9 {p999:.2e} "
              f"max {mx:.2e}")
        assert img.shape == (CFG.height, CFG.width, 3)
        assert mean < 2e-3 and p999 < 3e-2, (k, mean, p999, mx)
    assert state.frame_idx == int(jst.frame_idx) == 2
    whole = psh.unshard_state(state)
    mean, p999, mx = image_stats(whole.taa_history[:3], jst.taa_history[:3],
                                 99.9)
    assert mean < 2e-3 and p999 < 3e-2, (mean, p999, mx)
    np.testing.assert_allclose(n(whole.light_maps), np.asarray(jst.light_maps),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_step_matches_unsharded_port(port_scene, name):
    nd, rows = MESHES[name]
    ps, cam = port_scene
    images, state, _mesh = _port_frames(ps, cam, nd, rows)
    single = clone_state(ps)
    for img in images:
        out = pframe.render_frame(single, cam, port_config(CFG))
        single = out.state
        np.testing.assert_allclose(n(img), n(out.image), atol=2e-5)
    whole = psh.unshard_state(state)
    np.testing.assert_allclose(n(whole.taa_history), n(single.taa_history),
                               atol=2e-5)
    assert torch.equal(whole.light_maps, single.light_maps)
    assert torch.equal(whole.light_sout, single.light_sout)


def test_render_frames_passes_the_mesh_through(port_scene):
    ps, cam = port_scene
    mesh = _port_mesh(2, 2)
    cfg = port_config(CFG)
    imgs, state = pframe.render_frames(
        psh.shard_state(clone_state(ps), mesh), [cam, cam], cfg, mesh=mesh)
    want, _ = pframe.render_frames(clone_state(ps), [cam, cam], cfg)
    assert state.frame_idx == 2 and imgs.shape == want.shape
    np.testing.assert_allclose(n(imgs), n(want), atol=2e-5)


@pytest.mark.parametrize("shard_light", [False, True],
                         ids=["replicated", "shard_light"])
def test_placement_check(shard_light):
    r = psh.placement_check(4, shard_light=shard_light, device="cpu")
    assert r["largest_elems"] == r["cube_gather_elems"] == 4 * 6 * 4 * 8 * 8
    names = [c[0] for c in r["collectives"]]
    assert "cube_maps" in names
    assert not any(x.startswith(("light_maps", "light_sweep", "volumes"))
                   for x in names)
    assert ("light_sout" in names) == shard_light


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_light_stacks_are_bit_identical(port_scene, name):
    """`shard_light_stacks`: a shard holds N / D volumes of each stack and
    the frames equal the replicated-stack frames bit for bit
    (tests/test_sharding_placement.py:57-63)."""
    nd, rows = MESHES[name]
    ps, cam = port_scene
    rep_images, rep_state, _ = _port_frames(ps, cam, nd, rows, frames=3)
    images, state, _ = _port_frames(ps, cam, nd, rows, frames=3,
                                    shard_light=True)
    assert state.local(0, 0).light_sweep.shape[0] == CFG.num_volumes // nd
    for a, b in zip(images, rep_images):
        assert torch.equal(a, b)
    whole, rep_whole = psh.unshard_state(state), psh.unshard_state(rep_state)
    for name_ in ("light_maps", "light_sweep", "light_sout", "taa_history"):
        assert torch.equal(getattr(whole, name_), getattr(rep_whole, name_))


def test_dryrun_on_logical_cpu_shards():
    psh.dryrun(4, device="cpu")
    psh.dryrun(3, device="cpu")


def test_sharded_step_with_an_opaque_mesh_raises(port_scene):
    """The sharded step takes an opaque mesh (here a degenerate one that
    covers no pixel, so the frame is the unsharded one), with the main
    path's composite and with the warp composite, each equal to the
    unsharded frame (tests/test_torch_sharding_mesh.py holds a real
    mesh). The name is kept from when the sharded step refused every
    opaque mesh, and then the warp composite with it."""
    ps, cam = port_scene
    with_mesh = dataclasses.replace(
        clone_state(ps), mesh_indices=torch.zeros((2, 3), dtype=torch.int64))
    mesh = _port_mesh(2, 2)
    cfg = port_config(CFG.with_(show_mesh=True))
    for c in (cfg, cfg.with_(composite_mode="warp")):
        img, state = psh.make_sharded_step(c, mesh)(
            psh.shard_state(clone_state(with_mesh), mesh), cam)
        want = pframe.render_frame(clone_state(with_mesh), cam, c)
        np.testing.assert_allclose(n(img), n(want.image), atol=2e-5)
        assert torch.equal(psh.unshard_state(state).mesh_prev_wvp,
                           want.state.mesh_prev_wvp)


@pytest.mark.parametrize("shard_light", [False, True],
                         ids=["replicated", "shard_light"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_unshard_inverts_shard(port_scene, name, shard_light):
    nd, rows = MESHES[name]
    ps, _cam = port_scene
    mesh = _port_mesh(nd, rows)
    sharded = psh.shard_state(ps, mesh, shard_light=shard_light)
    plan = psh.state_shardings(mesh, ps, shard_light=shard_light)
    assert plan["vol_tex_ids"] == plan["volume_worlds"] == "volumes"
    assert plan["light_sweep"] == ("volumes" if shard_light else "rep")
    assert plan["taa_history"] == ("rows" if rows > 1 else "rep")
    assert plan["volumes_sweep"] == "rep"
    loc = sharded.local(rows - 1, nd - 1)
    assert loc.vol_tex_ids.shape[0] == CFG.num_volumes // nd
    assert loc.taa_history.shape[1] == CFG.height // rows
    # logical shards of one device share a replicated tensor
    assert loc.volumes_sweep is sharded.local(0, 0).volumes_sweep
    whole = psh.unshard_state(sharded)
    for f in dataclasses.fields(ps):
        a, b = getattr(ps, f.name), getattr(whole, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
