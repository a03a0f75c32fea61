"""Parity of the PyTorch port's core modules with the JAX package: the
configuration, math3d, camera, spherical harmonics, the Halton jitter,
the OBJ loader, procedural volumes, per-object matrices and culling,
sampling helpers. f32, atol 1e-5 (1e-6 where the computation is the same
numpy code); the configuration, the jitter and the loader exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, port_per_object, t

from multivolumes_tpu import config as jconfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.core import halton as jhalton
from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.core import sh as jsh
from multivolumes_tpu.ops import trilinear as jtri
from multivolumes_tpu.render import composite as jcomp
from multivolumes_tpu.render import cull as jcull
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu.scene import io_obj as jio_obj
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu.scene import volume as jvol
from multivolumes_tpu_torch import config as pconfig
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.core import halton as phalton
from multivolumes_tpu_torch.core import math3d as pm
from multivolumes_tpu_torch.core import sh as psh
from multivolumes_tpu_torch.ops import trilinear as ptri
from multivolumes_tpu_torch.render import composite as pcomp
from multivolumes_tpu_torch.render import cull as pcull
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene import io_obj as pio_obj
from multivolumes_tpu_torch.scene import state as pstate
from multivolumes_tpu_torch.scene import volume as pvol

ATOL = 1e-5


def close(a, b, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(n(a), n(b), atol=atol, rtol=rtol)


def test_math3d_matches_jax():
    rng = np.random.RandomState(0)
    eye, focus = rng.randn(3) * 10, rng.randn(3)
    close(pm.look_at_lh(torch.tensor(eye), focus, [0.0, 1.0, 0.0]),
          jm.look_at_lh(eye, focus, [0.0, 1.0, 0.0]))
    close(pm.perspective_fov_lh(0.8, 1.6, 1.0, 1000.0),
          jm.perspective_fov_lh(0.8, 1.6, 1.0, 1000.0))
    close(pm.orthographic_lh(20.0, 10.0, 0.5, 50.0),
          jm.orthographic_lh(20.0, 10.0, 0.5, 50.0))
    close(pm.scaling(2.5) @ pm.translation([1.0, -2.0, 3.0]),
          jm.scaling(2.5) @ jm.translation(jnp.array([1.0, -2.0, 3.0])))
    close(pm.rotation_y(0.7), jm.rotation_y(0.7))
    p = rng.randn(5, 3).astype(np.float32)
    m = rng.randn(5, 4, 4).astype(np.float32)
    close(pm.transform_point(t(p), t(m)), jm.transform_point(p, m), 1e-5)
    close(pm.transform_vector(t(p), t(m)), jm.transform_vector(p, m))
    close(pm.normalize(t(p)), jm.normalize(p), 1e-6)


@pytest.mark.parametrize("which", ["default", "orbit"])
def test_camera_matches_jax(which):
    aspect = 1.6
    if which == "default":
        a = pcam.default_camera(aspect, device="cpu")
        b = jcam.default_camera(aspect)
    else:
        a = pcam.orbit_camera(1.3, aspect, device="cpu")
        b = jcam.orbit_camera(1.3, aspect)
    close(a.eye, b.eye)
    close(a.view, b.view)
    close(a.proj, b.proj)
    close(a.view_proj, b.view_proj)
    np.testing.assert_allclose(n(a.screen_to_world), n(b.screen_to_world),
                               rtol=1e-4, atol=1e-5)


def test_sh_projection_and_irradiance_match_jax():
    rad = pstate.default_radiance(16)
    np.testing.assert_array_equal(rad, jstate.default_radiance(16))
    np.testing.assert_array_equal(psh.cube_face_dirs(8),
                                  jsh.cube_face_dirs(8))
    np.testing.assert_array_equal(psh.cube_texel_solid_angles(8),
                                  jsh.cube_texel_solid_angles(8))
    coeffs = psh.project_cube_map(t(rad))
    close(coeffs, jsh.project_cube_map(jnp.asarray(rad)), 1e-5)
    nrm = np.random.RandomState(1).randn(64, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    close(psh.eval_irradiance(coeffs, t(nrm)),
          jsh.eval_irradiance(jnp.asarray(n(coeffs)), nrm))


def test_config_is_the_jax_config():
    """The port's own RenderConfig and SharedConsts have the JAX ones'
    field names, defaults and constant values, so the copy cannot
    drift."""
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(pconfig.RenderConfig)}
    assert pf == jf
    consts = [k for k in vars(jconfig.SharedConsts) if k.isupper()]
    assert consts == [k for k in vars(pconfig.SharedConsts) if k.isupper()]
    for k in consts:
        assert getattr(pconfig.SharedConsts, k) == \
            getattr(jconfig.SharedConsts, k), k
    cfg = jconfig.RenderConfig(width=96, height=64, raster_far_tiers=(
        (52, 8), (138, 7)))
    pc = pconfig.RenderConfig(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(pc) == dataclasses.asdict(cfg)
    assert (pc.viewport, pc.aspect_ratio) == (cfg.viewport, cfg.aspect_ratio)
    assert pc.with_(width=32) == pconfig.RenderConfig(
        **dataclasses.asdict(cfg.with_(width=32)))


def test_entry_points_default_to_the_card():
    """The functional entry points make their tensors on the card unless
    asked for the CPU; without a card that is PyTorch's own error, never
    a silent CPU run."""
    cfg = pconfig.RenderConfig(width=32, height=32, grid_size=8,
                               light_grid_size=8, num_volumes=1)
    calls = (lambda: pcam.default_camera(1.6),
             lambda: pcam.orbit_camera(0.5, 1.6),
             lambda: pcam.make_camera([0.0, 1.0, -5.0], [0.0, 0.0, 0.0], 1.6),
             lambda: pstate.create_scene(cfg))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            x = out.eye if hasattr(out, "eye") else out.volumes
            assert x.is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_halton_and_sh_soa_match_jax():
    for i in (0, 1, 7, 63, 64, 130):
        np.testing.assert_array_equal(
            phalton.halton_jitter(i, 1280.0, 800.0),
            np.asarray(jhalton.halton_jitter(i, 1280.0, 800.0)))
    assert phalton.halton23(5) == jhalton.halton23(5)
    rng = np.random.RandomState(2)
    coeffs = rng.randn(9, 3).astype(np.float32)
    d = rng.randn(3, 8, 8).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    for pf, jf in ((psh.eval_irradiance_soa, jsh.eval_irradiance_soa),
                   (psh.eval_radiance_soa, jsh.eval_radiance_soa)):
        for a, b in zip(pf(t(coeffs), *(t(x) for x in d)),
                        jf(jnp.asarray(coeffs), *d)):
            close(a, b)


def test_obj_loader_is_the_jax_loader(tmp_path):
    """The port's copy of the numpy OBJ loader: the test mesh, and a file
    with quads, negative indices and file normals (split vertices)."""
    from torch_parity import write_test_mesh

    paths = [write_test_mesh(tmp_path / "torus.obj", 300)]
    quad = tmp_path / "quad.obj"
    quad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                    "vn 0 0 1\nvn 0 1 0\n"
                    "f 1//1 2//1 3//1 4//1\nf -5//2 -4//2 -1//2\n")
    paths.append(str(quad))
    for path in paths:
        for for_dx in (True, False):
            a = pio_obj.load_obj(path, for_dx=for_dx)
            b = jio_obj.load_obj(path, for_dx=for_dx)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert a.scene_size == b.scene_size


def test_procedural_volumes_bit_equal():
    np.testing.assert_array_equal(pvol.init_grid_data(12),
                                  np.asarray(jvol.init_grid_data(12)))
    np.testing.assert_array_equal(
        pvol.init_grid_data(12, corner_free=True),
        np.asarray(jvol.init_grid_data(12, corner_free=True)))
    for seed in (1, 4):
        np.testing.assert_array_equal(
            pvol.init_grid_variant(12, seed),
            np.asarray(jvol.init_grid_variant(12, seed)))
    np.testing.assert_array_equal(
        pvol.make_volume_sources(3, 12).numpy(),
        np.asarray(jvol.make_volume_sources(3, 12)))
    np.testing.assert_array_equal(
        pstate.volume_grid_worlds(7, 10.0, (1.0, 2.0, 3.0)),
        jstate.volume_grid_worlds(7, 10.0, (1.0, 2.0, 3.0)))


@pytest.mark.parametrize("t_orbit", [0.0, 2.1])
def test_per_object_and_cull_match_jax(t_orbit):
    worlds = jstate.volume_grid_worlds(9, 10.0, (0.0, 0.0, 0.0))
    jc = jcam.orbit_camera(t_orbit, 1.6)
    jpo = jbpo(jnp.asarray(worlds), jc.view_proj)
    ppo = build_per_object(t(worlds), t(jc.view_proj))
    for name, a, b in zip(ppo._fields, ppo, jpo):
        # the inverse of a projective matrix (entries ~10) carries f32 LU
        # rounding of a few 1e-5 relative, differently in each library
        rtol = 1e-4 if name == "world_view_proj_i" else 1e-5
        np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=1e-5)
    jres = jcull.cull_volumes(jpo, jc.eye, jnp.array([320.0, 200.0]), 64, 32,
                              5)
    pres = pcull.cull_volumes(port_per_object(jpo), t(jc.eye), [320, 200],
                              64, 32, 5)
    for name, a, b in zip(pres._fields, pres, jres):
        if name == "max_edge_px":
            np.testing.assert_allclose(n(a), n(b), rtol=1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_trilinear_and_screen_helpers_match_jax():
    rng = np.random.RandomState(2)
    stack = rng.rand(2, 5, 6, 7, 4).astype(np.float32)
    idx = rng.randint(0, 2, (40,)).astype(np.int32)
    u, v, w = (rng.rand(40).astype(np.float32) * 1.4 - 0.2 for _ in range(3))
    got = ptri.indexed_trilinear_soa(t(stack), torch.from_numpy(idx),
                                     t(u), t(v), t(w))
    want = jtri.indexed_trilinear_soa(jnp.asarray(stack), idx, u, v, w)
    for a, b in zip(got, want):
        close(a, b, 1e-6)

    d = rng.randn(3, 50).astype(np.float32)
    face_p, up, vp = pcomp.dir_to_face_uv_soa(*(t(x) for x in d))
    face_j, uj, vj = jcomp.dir_to_face_uv_soa(*d)
    np.testing.assert_array_equal(face_p.numpy(), np.asarray(face_j))
    close(up, uj, 1e-6)
    close(vp, vj, 1e-6)
    z = rng.rand(20).astype(np.float32)
    close(pcomp.unproject_z(t(z)), jcomp.unproject_z(z), 1e-6, 1e-6)

    jc = jcam.default_camera(1.5)
    (pxg, pyg), pdir = pcomp.screen_rays(24, 16, t(jc.screen_to_world),
                                         t(jc.eye))
    (jxg, jyg), jdir = jax.jit(jcomp.screen_rays, static_argnums=(0, 1))(
        24, 16, jc.screen_to_world, jc.eye)
    close(pxg, jxg, 1e-6)
    close(pyg, jyg, 1e-6)
    for a, b in zip(pdir, jdir):
        close(a, b, 1e-5)
