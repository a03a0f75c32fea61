"""The port's host layer against the JAX package: `render_frames` and the
engine's `render_block` against K sequential `render_frame` calls (atol
2e-5) and against the JAX `render_frames` (golden-image limits: mean
< 2e-3, p99.9 < 3e-2; cf. tests/test_passes.py:475-537); each engine
setter against the JAX engine's setter on the same inputs, `set_mesh`
and the raster-preset pick included; and the app, with and without a
mesh.

The engines are compared after a light that is not a sweep-axis tie: the
JAX engine's light refresh picks its axis inside the trace, which breaks
the default light's three-way tie differently from the baked pick
(ROADMAP.md, section C)."""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (clone_state, image_stats, jax_state_dict, n,
                          port_camera, port_config, write_test_mesh)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.engine import MultiRayCaster as JaxEngine
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu.scene import io_dds as jio_dds
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch import app
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.scene import state as pstate

# tests/test_passes.py:test_render_frames_scan_matches_sequential's scene
CFG = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                   max_ray_samples=16, max_light_samples=8, num_volumes=4,
                   num_volume_srcs=2, cube_map_size=16, shadow_map_size=32,
                   light_axis=2)
PCFG = port_config(CFG)
K = 3
LIGHT = ((10.0, 80.0, -20.0), (1.0, 0.5, 0.25), 5.0)   # y-dominant


@pytest.fixture(scope="module")
def block_case():
    """The JAX start state and its `render_frames` over K orbit frames."""
    st = jstate.create_scene(CFG)
    cams = [jcam.orbit_camera((f + 1) / 60.0, CFG.aspect_ratio)
            for f in range(K)]
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, 0), *cams)
    imgs, _ = jax.jit(lambda s, c: jframe.render_frames(
        s, c, CFG, use_taa=True))(st, stacked)
    return jax_state_dict(st), cams, np.asarray(imgs)


def test_render_frames_matches_sequential_and_jax(block_case):
    st_d, jcams, jimgs = block_case
    cams = [port_camera(c) for c in jcams]
    start = pstate.state_from_numpy(st_d)
    seq, s = [], clone_state(start)
    for cam in cams:
        out = pframe.render_frame(s, cam, PCFG)
        seq.append(out.image)
        s = out.state
    imgs, s_end = pframe.render_frames(clone_state(start), cams, PCFG)
    assert imgs.shape == (K, 3, CFG.height, CFG.width)
    for f in range(K):
        torch.testing.assert_close(imgs[f].permute(1, 2, 0), seq[f],
                                   atol=2e-5, rtol=0)
    assert s_end.frame_idx == K
    torch.testing.assert_close(s_end.taa_history, s.taa_history, atol=2e-5,
                               rtol=0)
    mean, p999, mx = image_stats(imgs[-1], jimgs[-1], 99.9)
    assert mean < 2e-3 and p999 < 3e-2, (mean, p999, mx)

    # the engine's block API: the same frames from the same state
    eng = MultiRayCaster(PCFG, device="cpu")
    eng.state = clone_state(start)
    block = eng.render_block(cams)
    torch.testing.assert_close(block, imgs, atol=2e-5, rtol=0)
    assert eng.state.frame_idx == K


@pytest.fixture(scope="module")
def engines():
    """A JAX and a port engine on one f32 scene, both moved off the
    default light's axis tie."""
    cfg = CFG.with_(light_axis=None, use_bf16=False)
    je, pe = JaxEngine(cfg), MultiRayCaster(port_config(cfg), device="cpu")
    je.set_light(*LIGHT)
    pe.set_light(*LIGHT)
    return je, pe


def _check_light(je, pe):
    js = je.state
    assert pe.config.light_axis == je.config.light_axis
    np.testing.assert_allclose(n(pe.state.light_maps), n(js.light_maps),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(n(pe.state.light_sout), n(js.light_sout),
                               atol=1e-5)
    want = pstate.to_light_sweep(pe.state.light_maps,
                                 pe.state.light_sweep.dtype)
    assert torch.equal(pe.state.light_sweep, want)


def test_set_light_moves_the_baked_axis(engines):
    je, pe = engines
    assert pe.config.light_axis == 1
    je.set_light((90.0, 30.0, 10.0), (0.9, 0.8, 0.7), 2.0)
    pe.set_light((90.0, 30.0, 10.0), (0.9, 0.8, 0.7), 2.0)
    assert pe.config.light_axis == je.config.light_axis == 0
    for name in ("light_pos", "light_color"):
        np.testing.assert_array_equal(n(getattr(pe.state, name)),
                                      n(getattr(je.state, name)))
    _check_light(je, pe)


@pytest.mark.parametrize("setter", ["ambient", "sh", "radiance",
                                    "radiance_file"])
def test_lighting_setters_match_jax(engines, setter, tmp_path):
    je, pe = engines
    rng = np.random.RandomState(7)
    if setter == "ambient":
        args = ((0.2, 0.3, 0.4), 1.5)
    elif setter == "sh":
        args = (rng.rand(9, 3).astype(np.float32) * 0.3,)
    elif setter == "radiance":
        args = (rng.rand(6, 8, 8, 3).astype(np.float32) * 2.0,)
    else:
        path = str(tmp_path / "sky.dds")
        jio_dds.write_dds_rgba16f_cube(
            path, rng.rand(6, 8, 8, 4).astype(np.float32) * 2.0)
        args = (path,)
    getattr(je, f"set_{setter}")(*args)
    getattr(pe, f"set_{setter}")(*args)
    for name in ("ambient", "radiance"):
        np.testing.assert_array_equal(n(getattr(pe.state, name)),
                                      n(getattr(je.state, name)))
    np.testing.assert_allclose(n(pe.state.sh_coeffs), n(je.state.sh_coeffs),
                               atol=1e-5, rtol=1e-5)
    _check_light(je, pe)


@pytest.mark.parametrize("setter", ["data", "file", "init"])
def test_volume_setters_match_jax(engines, setter, tmp_path):
    je, pe = engines
    g = CFG.grid_size
    zz, yy, xx = np.meshgrid(*([np.linspace(-1, 1, g)] * 3), indexing="ij")
    density = np.exp(-3.0 * (xx * xx + yy * yy + zz * zz)).astype(np.float32)
    if setter == "data":
        je.load_volume_data(0, density)
        pe.load_volume_data(0, density)
    elif setter == "file":
        path = str(tmp_path / "vol.dds")
        jio_dds.write_dds_r32f_volume(path, np.sqrt(density))
        je.load_volume_file(1, path)
        pe.load_volume_file(1, path)
    else:
        je.init_volume_data(1)
        pe.init_volume_data(1)
    js, ps = je.state, pe.state
    for name in ("volumes", "vol_zmax"):
        np.testing.assert_array_equal(n(getattr(ps, name)),
                                      n(getattr(js, name)), name)
    assert torch.equal(ps.volumes_sweep, ps.volumes.to(ps.volumes_sweep.dtype))
    for name in ("rho_light", "ao_static", "grad_dir"):
        np.testing.assert_allclose(n(getattr(ps, name)), n(getattr(js, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    _check_light(je, pe)


def test_world_and_sample_setters_match_jax(engines):
    je, pe = engines
    for eng in (je, pe):
        eng.set_volumes_world(12.0, (1.0, 2.0, 3.0))
        eng.set_volume_world(2, 8.0, (-5.0, 4.0, 6.0))
        eng.set_max_samples(20, 6)
    np.testing.assert_allclose(n(pe.state.volume_worlds),
                               n(je.state.volume_worlds), atol=1e-6)
    assert (pe.config.max_ray_samples, pe.config.max_light_samples) == (
        je.config.max_ray_samples, je.config.max_light_samples) == (20, 6)
    rotated = np.asarray(jm.rotation_y(0.3) @ jm.scaling(2.0))[None]
    for eng in (je, pe):
        with pytest.raises(ValueError, match="unrotated"):
            eng._check_worlds(rotated)


def test_mesh_setters_match_jax(tmp_path):
    """set_mesh (scene size, far ladder, shadow map), the raster-preset
    pick along an orbit and a close-up, and set_light's shadow-map and
    light refresh, against the JAX engine."""
    path = write_test_mesh(tmp_path / "torus.obj", 2000)
    cfg = CFG.with_(light_axis=None, use_bf16=False)
    je, pe = JaxEngine(cfg), MultiRayCaster(port_config(cfg), device="cpu")
    for eng in (je, pe):
        eng.set_mesh(path)
    assert pe.config.show_mesh and je.config.show_mesh
    assert pe.config.raster_far_tiers == je.config.raster_far_tiers
    assert pe.config.raster_far_small == je.config.raster_far_small
    assert pe.config.raster_far_tiers is not None
    assert float(pe.state.scene_size) == float(je.state.scene_size)
    np.testing.assert_array_equal(n(pe.state.mesh_world),
                                  n(je.state.mesh_world))
    np.testing.assert_array_equal(pe.state.mesh_indices.numpy(),
                                  np.asarray(je.state.mesh_indices))
    # the JAX engine loads through its C++ fast path: normals to 1e-6
    np.testing.assert_allclose(n(pe.state.mesh_verts),
                               n(je.state.mesh_verts), atol=1e-6)
    # orbit eyes (far), a close-up (near), back out (far)
    eyes = [(np.sin(a) * 60.0, 6.0, np.cos(a) * 60.0)
            for a in np.linspace(0.0, 3.0, 6)]
    eyes += [(0.0, -5.0, -1.0), (0.0, 6.0, -60.0)]
    picks = [(pe.select_raster_preset(e), je.select_raster_preset(e))
             for e in eyes]
    assert all(a == b for a, b in picks), picks
    assert {a for a, _ in picks} == {"near", "far"}
    for eng in (je, pe):
        eng.set_light(*LIGHT)
    sj, sp = n(je.state.mesh_shadow_map), n(pe.state.mesh_shadow_map)
    cov = (sj < 1) | (sp < 1)
    assert cov.sum() > 50
    assert float(((sj < 1) == (sp < 1))[cov].mean()) >= 0.999
    both = (sj < 1) & (sp < 1)
    assert np.abs(sj[both] - sp[both]).max() <= 2.0 ** -15
    _check_light(je, pe)


def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, idat, size = 8, b"", None
    while i < len(data):
        ln = struct.unpack(">I", data[i:i + 4])[0]
        tag = data[i + 4:i + 8]
        if tag == b"IHDR":
            size = struct.unpack(">II", data[i + 8:i + 16])
        elif tag == b"IDAT":
            idat += data[i + 8:i + 8 + ln]
        i += 12 + ln
    w, h = size
    raw = zlib.decompress(idat)
    rows = [np.frombuffer(raw[r * (w * 3 + 1) + 1:(r + 1) * (w * 3 + 1)],
                          np.uint8).reshape(w, 3) for r in range(h)]
    return np.stack(rows)


def test_app_writes_png(tmp_path, capsys):
    out = tmp_path / "frame.png"
    small = ["--width", "96", "--height", "64", "--gridSize", "16",
             "--lightGridSize", "8", "--maxRaySamples", "16",
             "--maxLightSamples", "8", "--numVolumes", "4"]
    app.main(["--warp", *small, "--frames", "2", "--animate",
              "--out", str(out)])
    img = _read_png(out)
    assert img.shape == (64, 96, 3) and img.std() > 1.0
    assert "frame 1:" in capsys.readouterr().out
    # with the opaque mesh: loaded, shown, opaque in the image
    mesh_out = tmp_path / "mesh.png"
    app.main(["--warp", *small, "--mesh",
              write_test_mesh(tmp_path / "torus.obj", 2000), "--frames",
              "2", "--animate", "--out", str(mesh_out)])
    img_m = _read_png(mesh_out)
    assert img_m.shape == (64, 96, 3)
    assert np.abs(img_m.astype(np.float32) - img).max() > 50  # the mesh
    if not torch.cuda.is_available():
        # no silent CPU run: without --warp the app needs the card
        with pytest.raises(SystemExit) as exc:
            app.main(small)
        assert exc.value.code not in (0, None)
