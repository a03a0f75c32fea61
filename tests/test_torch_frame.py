"""The port's whole slice against the JAX package: `create_scene`, and
`render_frame(use_taa=True)` over two orbit frames from the same state
(image and advanced state, TAA history included), in f32 and in the
default bf16; the engine; and the port's import boundary. Image
tolerance: mean < 2e-3, p99.9 < 3e-2 (tests/test_goldens.py:37-41).

The JAX reference renders with `light_axis` baked the way its engine
bakes it (argmax |light dir|, ties to z): the default light (75, 75, -75)
is a three-way tie, which a traced pick without the baked axis breaks by
the rounding of a 4x4 inverse (see ROADMAP.md, section C)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (image_stats, jax_state_dict, n, port_camera,
                          port_config)
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu.render import lightsweep as jls
from multivolumes_tpu.render.perframe import build_per_object as jbpo
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.scene import state as pstate

BASE = RenderConfig(width=160, height=96, grid_size=16, light_grid_size=8,
                    max_ray_samples=24, max_light_samples=8, num_volumes=10,
                    num_volume_srcs=2, cube_map_size=32, shadow_map_size=32,
                    light_axis=2)
CONFIGS = {"f32": BASE.with_(use_bf16=False), "bf16": BASE}
TIMES = (0.3, 0.55)


@pytest.fixture(scope="module")
def jax_scene_f32():
    return jstate.create_scene(CONFIGS["f32"])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def frames(request, jax_scene_f32):
    """JAX scene + two JAX frames (shared by the tests of one config)."""
    cfg = CONFIGS[request.param]
    st0 = (jax_scene_f32 if request.param == "f32"
           else jstate.create_scene(cfg))
    step = jax.jit(lambda s, c: jframe.render_frame(s, c, cfg,
                                                    use_taa=True))
    outs, st = [], st0
    for tm in TIMES:
        out = step(st, jcam.orbit_camera(tm, cfg.aspect_ratio))
        outs.append((np.asarray(out.image), jax_state_dict(out.state)))
        st = out.state
    return cfg, st0, outs


def test_render_frame_matches_jax(frames):
    cfg, st0, outs = frames
    ps = pstate.state_from_numpy(jax_state_dict(st0))
    for tm, (img_j, st_j) in zip(TIMES, outs):
        out = pframe.render_frame(
            ps, port_camera(jcam.orbit_camera(tm, cfg.aspect_ratio)),
            port_config(cfg))
        ps = out.state
        mean, p999, mx = image_stats(out.image, img_j, 99.9)
        assert mean < 2e-3 and p999 < 3e-2, (tm, mean, p999, mx)
        assert ps.frame_idx == int(st_j["frame_idx"])
        np.testing.assert_allclose(n(ps.light_maps), st_j["light_maps"],
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(n(ps.light_sout), st_j["light_sout"],
                                   atol=1e-5)
        # the resolved HDR colour at the image's limits; the history count
        # (channel 3) depends only on the frame count
        mean, p999, mx = image_stats(ps.taa_history[:3],
                                     st_j["taa_history"][:3], 99.9)
        assert mean < 2e-3 and p999 < 3e-2, (tm, mean, p999, mx)
        np.testing.assert_allclose(n(ps.taa_history[3]),
                                   st_j["taa_history"][3], atol=1e-6)
    assert float(out.hdr[..., 3].max()) > 0.2  # volumes on screen


def test_create_scene_matches_jax(jax_scene_f32):
    cfg, st0 = CONFIGS["f32"], jax_scene_f32
    ps = pstate.create_scene(port_config(cfg), device="cpu")
    d = jax_state_dict(st0)
    for name in ("volumes", "volume_worlds", "radiance", "light_pos",
                 "light_color", "ambient", "vol_zmax"):
        np.testing.assert_array_equal(n(getattr(ps, name)), d[name], name)
    np.testing.assert_array_equal(ps.vol_tex_ids.numpy(), d["vol_tex_ids"])
    for name in ("sh_coeffs", "rho_light", "ao_static", "grad_dir"):
        np.testing.assert_allclose(n(getattr(ps, name)), d[name], atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    # the initial full light refresh, at the engine's baked axis
    po0 = jbpo(st0.volume_worlds, jnp.eye(4, dtype=jnp.float32))
    maps, sout = jax.jit(lambda s: jls.ray_march_light_sweep_update(
        s.rho_light, s.ao_static, s.grad_dir, s.vol_tex_ids, po0, None, None,
        s.light_pos, s.light_color, s.ambient, s.sh_coeffs,
        cfg.max_light_samples, static_axis=2))(st0)
    np.testing.assert_allclose(n(ps.light_maps), n(maps), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(n(ps.light_sout), n(sout), atol=1e-5)
    want_sweep = pstate.to_light_sweep(ps.light_maps,
                                       pstate.sweep_dtype(cfg))
    assert torch.equal(ps.light_sweep, want_sweep)


def test_engine_renders_with_baked_axis():
    cfg = CONFIGS["f32"].with_(light_axis=None, num_volumes=4)
    eng = MultiRayCaster(port_config(cfg), device="cpu")
    assert eng.config.light_axis == 2
    img = eng.render()
    assert img.shape == (cfg.height, cfg.width, 3)
    assert bool(torch.isfinite(img).all())
    assert eng.state.frame_idx == 1


@pytest.mark.parametrize("change", [
    dict(config=dict(lod_bucket_caps=None),
         passes=("sweep", "unbucketed", "tile")),
    dict(config=dict(composite_mode="warp"), passes=("sweep", "lod", "warp")),
    dict(config=dict(march_mode="reference"),
         passes=("sweep", "reference", "gather")),
    dict(config=dict(composite_mode="gather"),
         passes=("sweep", "lod", "gather")),
    dict(config=dict(point_light=True), passes=("reference", "lod", "tile")),
    dict(config=dict(adaptive_raymarch=False),
         passes=("sweep", "unbucketed", "tile"))])
def test_unported_settings_raise(change):
    """The reference modes, point lights, the warp and gather composites
    and the un-bucketed sweep run in the unsharded frame and in the
    sharded step alike (tests/test_torch_sharding_modes.py renders them),
    each with the passes `frame_passes` picks for both; what still raises
    is an unknown setting. The name is kept from when the sharded step
    refused these settings."""
    cfg = port_config(CONFIGS["f32"].with_(**change["config"]))
    pframe.check_supported(cfg)
    assert pframe.frame_passes(cfg) == change["passes"]
    for unknown in (dict(march_mode="fast"), dict(light_mode="fast"),
                    dict(composite_mode="scatter")):
        with pytest.raises(ValueError, match="unknown setting"):
            pframe.check_supported(cfg.with_(**unknown))


def test_port_imports_no_jax():
    """Every module of the port imports neither JAX nor any module of the
    JAX package (whose `__init__` would run on the first one)."""
    code = ("import importlib, pkgutil, sys\n"
            "import multivolumes_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "for need in ('render.mesh', 'scene.io_obj', 'app', 'config',\n"
            "             'engine', 'render.frame', 'utils.png', 'bench'):\n"
            "    assert pkg.__name__ + '.' + need in names, need\n"
            "bad = [m for m in sys.modules if m == 'jax'\n"
            "       or m.startswith('jax.') or m == 'multivolumes_tpu'\n"
            "       or m.startswith('multivolumes_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
