"""The port's other frame settings and their host layer: two frames of
the warp composite, the gather composite and the un-bucketed sweep (with
the warp and with the tile composite) against the JAX frames at the
golden limits (mean < 2e-3, p99.9 < 3e-2, tests/test_goldens.py:37-41);
point lights and the mixed setting (sweep march, reference light) on the
port; the sharded step's refusal of these settings; the engine in the
reference light mode with rotated volumes; the stats; and the app's
`--march reference`, `--stats`, `[o]` and `[w]`."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (image_stats, jax_state_dict, n,  # noqa: F401
                          one_torch_thread, port_camera, port_config,
                          port_cull)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.render import frame as jframe
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu_torch import app
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.render import lightmarch as plm
from multivolumes_tpu_torch.scene import state as pstate

CFG = RenderConfig(width=128, height=96, grid_size=16, light_grid_size=8,
                   max_ray_samples=24, max_light_samples=8, num_volumes=8,
                   num_volume_srcs=2, cube_map_size=32, shadow_map_size=32,
                   use_bf16=False, light_axis=2)
FRAMES = {
    "warp": CFG.with_(composite_mode="warp"),
    "gather": CFG.with_(composite_mode="gather"),
    "unbucketed_warp": CFG.with_(composite_mode="warp", lod_bucket_caps=None,
                                 sweep_planes=24),
    "unbucketed_tile": CFG.with_(adaptive_raymarch=False),
}
SMALL = ["--width", "96", "--height", "64", "--gridSize", "16",
         "--lightGridSize", "8", "--maxRaySamples", "16",
         "--maxLightSamples", "8", "--numVolumes", "4"]


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_modes_match_jax(name):
    """Two frames of each setting from the same JAX state."""
    cfg = FRAMES[name]
    st = jstate.create_scene(cfg)
    step = jax.jit(lambda s, c: jframe.render_frame(s, c, cfg, use_taa=True))
    ps = pstate.state_from_numpy(jax_state_dict(st))
    for tm in (0.3, 0.55):
        out_j = step(st, jcam.orbit_camera(tm, cfg.aspect_ratio))
        st = out_j.state
        out = pframe.render_frame(
            ps, port_camera(jcam.orbit_camera(tm, cfg.aspect_ratio)),
            port_config(cfg))
        ps = out.state
        mean, p999, mx = image_stats(out.image, out_j.image, 99.9)
        assert mean < 2e-3 and p999 < 3e-2, (name, tm, mean, p999, mx)
    assert float(out.hdr[..., 3].max()) > 0.2


@pytest.mark.parametrize("change", [dict(point_light=True),
                                    dict(light_mode="reference")])
def test_reference_light_in_the_sweep_frame(change):
    """A point light, or the reference light mode under the sweep march
    and the tile composite: the frame refreshes one volume's map with the
    gather light march (equal to a direct call) and the sweep's stack
    row with it."""
    cfg = port_config(CFG).with_(**change)
    ps = pstate.create_scene(cfg, device="cpu")
    cam = pcam.orbit_camera(0.3, cfg.aspect_ratio, device="cpu")
    for _ in range(2):
        before = ps.light_maps.clone()
        po = pframe.build_per_object(ps.volume_worlds, cam.view_proj)
        cull = pframe.cull_lib.cull_volumes(
            po, cam.eye, [cfg.width, cfg.height], cfg.max_ray_samples,
            cfg.cube_map_size, cfg.num_cube_mips)
        want = plm.ray_march_light(
            ps.volumes, ps.vol_tex_ids, before.clone(), po, cull,
            ps.frame_idx, None, None, ps.light_pos, ps.light_color,
            ps.ambient, ps.sh_coeffs, cfg.max_light_samples,
            point_light=cfg.point_light)
        out = pframe.render_frame(ps, cam, cfg)
        ps = out.state
        assert torch.equal(ps.light_maps, want)
        vid = int(plm.select_update_volume(cull.visible, ps.frame_idx - 1))
        assert float((ps.light_maps[vid] - before[vid]).abs().max()) > 1e-2
        assert torch.equal(ps.light_sweep, pstate.to_light_sweep(
            ps.light_maps, ps.light_sweep.dtype))
        assert bool(torch.isfinite(out.image).all())


def test_engine_reference_light_takes_rotated_worlds():
    cfg = port_config(CFG).with_(light_axis=None, num_volumes=4)
    eng = MultiRayCaster(cfg, device="cpu")
    with pytest.raises(ValueError, match="light_mode='reference'"):
        eng.set_volume_world(1, 6.0, (2.0, 0.0, 3.0), rotation_y=0.4)
    ref = MultiRayCaster(cfg.with_(light_mode="reference",
                                   march_mode="reference",
                                   composite_mode="gather"), device="cpu")
    assert ref.config.light_axis is None
    ref.set_volume_world(1, 6.0, (2.0, 0.0, 3.0), rotation_y=0.4)
    w = ref.state.volume_worlds[1]
    assert abs(float(w[0, 2])) > 0.1          # rotated
    ref.set_light((30.0, 60.0, -10.0), (1.0, 0.8, 0.6), 6.0)
    assert torch.equal(ref.state.light_maps, torch.ones_like(
        ref.state.light_maps))                # refreshed by the frames
    img = ref.render()
    assert bool(torch.isfinite(img).all()) and img.std() > 0.01


def test_frame_stats_match_jax():
    from multivolumes_tpu.core import camera as jcam_
    from multivolumes_tpu.render import cull as jcull
    from multivolumes_tpu.render.perframe import build_per_object as jbpo
    from multivolumes_tpu.utils import stats as jstats
    from multivolumes_tpu_torch.utils import stats as pstats
    import jax.numpy as jnp

    st = jstate.create_scene(CFG)
    for tm in (0.0, 0.9):
        cam = jcam_.orbit_camera(tm, CFG.aspect_ratio)
        po = jbpo(st.volume_worlds, cam.view_proj)
        cull = jcull.cull_volumes(po, cam.eye, jnp.array([128.0, 96.0]),
                                  CFG.max_ray_samples, CFG.cube_map_size,
                                  CFG.num_cube_mips)
        want = jstats.frame_stats(cull)
        got = pstats.frame_stats(port_cull(cull))
        for f in want._fields:
            np.testing.assert_allclose(n(getattr(got, f)),
                                       n(getattr(want, f)), rtol=1e-6,
                                       err_msg=f)
        assert pstats.format_stats(got) == jstats.format_stats(want)


def test_sharded_step_refuses_other_settings():
    """The sharded step accepts every setting of the unsharded frame and
    refuses, as the frame does, only unknown ones. The name is kept from
    when it refused the settings below."""
    for change in (dict(march_mode="reference"), dict(point_light=True),
                   dict(composite_mode="warp"), dict(lod_bucket_caps=None),
                   dict(adaptive_raymarch=False)):
        cfg = port_config(CFG.with_(**change))
        pframe.check_supported(cfg)
    with pytest.raises(ValueError, match="unknown"):
        pframe.check_supported(port_config(CFG.with_(march_mode="fast")))


def test_app_reference_march_and_stats(tmp_path, capsys):
    out = tmp_path / "ref.png"
    app.main(["--warp", *SMALL, "--march", "reference", "--stats",
              "--frames", "2", "--animate", "--out", str(out)])
    text = capsys.readouterr().out
    assert "frame 1:" in text and "volumes " in text and "mips [" in text
    assert out.stat().st_size > 0


def test_app_hotkeys_o_and_w(capsys):
    cfg = port_config(CFG).with_(num_volumes=4, light_axis=None)
    eng = MultiRayCaster(cfg, device="cpu")
    ui = {"paused": False, "animate": False, "taa": True, "fps": True,
          "screenshot": False}
    seen = []
    for cmd in ("o", "o", "o", "w", "w"):
        assert app.apply_command(cmd, eng, ui)
        seen.append((eng.config.composite_mode, eng.config.march_mode))
        img = eng.render(pcam.default_camera(cfg.aspect_ratio,
                                             device="cpu"))
        assert bool(torch.isfinite(img).all())
    assert seen == [("tile", "sweep"), ("warp", "sweep"),
                    ("gather", "sweep"), ("gather", "reference"),
                    ("gather", "sweep")]
    text = capsys.readouterr().out
    assert "composite=warp" in text and "march=reference" in text
