"""The last library pieces of the port against the JAX package:
`utils/checkpoint.py` (`save_scene` / `load_scene`, also of a checkpoint
the JAX package wrote), `core/camera.py:band_camera` and the DDS writers
of `scene/io_dds.py`.

Tolerances, each with its source:
* save -> load: bit for bit, dtypes and `frame_idx` included (the bf16
  stacks pass through f32 exactly);
* a JAX checkpoint loaded by the port renders the frame of the state
  carried across by `state_from_numpy(jax_state_dict(...))`, bit for bit
  (the same tensors);
* the DDS writers: the files equal the JAX writers' files byte for byte,
  and both packages' readers read them back equal;
* `band_camera` against the JAX function: 1e-6; four bands of a
  reference frame stitched against the full frame: mean < 1e-5, max <
  1e-2 (tests/test_fidelity.py:114-115)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (jax_state_dict, n, one_torch_thread, port_camera,
                          port_config)

from multivolumes_tpu.config import RenderConfig
from multivolumes_tpu.core import camera as jcam
from multivolumes_tpu.scene import io_dds as jdds
from multivolumes_tpu.scene import state as jstate
from multivolumes_tpu.utils import checkpoint as jck
from multivolumes_tpu_torch.core import camera as pcam
from multivolumes_tpu_torch.render import frame as pframe
from multivolumes_tpu_torch.scene import io_dds as pdds
from multivolumes_tpu_torch.scene import state as pstate
from multivolumes_tpu_torch.utils import checkpoint as pck

assert one_torch_thread  # the module-wide fixture, used by every test

CFG = RenderConfig(width=64, height=48, grid_size=16, light_grid_size=8,
                   max_ray_samples=16, max_light_samples=8, num_volumes=4,
                   num_volume_srcs=2, cube_map_size=16, shadow_map_size=32,
                   light_axis=2)


def _assert_states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert type(x) is type(y) and x == y, f.name


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
def test_save_load_is_bit_for_bit(tmp_path, use_bf16):
    cfg = CFG.with_(use_bf16=use_bf16)
    state = pstate.create_scene(cfg, device="cpu")
    cam = pcam.default_camera(cfg.aspect_ratio, device="cpu")
    for _ in range(2):   # a light cohort, a TAA history, frame_idx 2
        state = pframe.render_frame(state, cam, cfg).state
    assert (state.light_sweep.dtype == torch.bfloat16) == use_bf16
    path = str(tmp_path / "scene.npz")
    pck.save_scene(path, state)
    loaded = pck.load_scene(path, device="cpu")
    assert loaded.frame_idx == 2
    _assert_states_equal(loaded, state)
    # the resumed run renders what the uninterrupted run renders
    want = pframe.render_frame(state, cam, cfg)
    got = pframe.render_frame(loaded, cam, cfg)
    assert torch.equal(got.image, want.image)


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, use_bf16):
    cfg = CFG.with_(use_bf16=use_bf16)
    st = dataclasses.replace(jstate.create_scene(cfg),
                             frame_idx=jnp.asarray(3, jnp.int32))
    path = str(tmp_path / "jax_scene.npz")
    jck.save_scene(path, st)
    loaded = pck.load_scene(path, device="cpu")
    carried = pstate.state_from_numpy(
        jax_state_dict(st),
        dtype=torch.bfloat16 if use_bf16 else torch.float32)
    assert loaded.frame_idx == 3
    assert loaded.volumes_sweep.dtype == (torch.bfloat16 if use_bf16
                                          else torch.float32)
    _assert_states_equal(loaded, carried)
    cam = port_camera(jcam.orbit_camera(0.4, cfg.aspect_ratio))
    pcfg = port_config(cfg)
    got = pframe.render_frame(loaded, cam, pcfg)
    want = pframe.render_frame(carried, cam, pcfg)
    assert torch.equal(got.image, want.image)
    assert got.state.frame_idx == 4


def _dds_case(kind, mips):
    rng = np.random.RandomState(5 + mips)
    if kind == "volume":
        return (rng.rand(16, 12, 8).astype(np.float32),
                "write_dds_r32f_volume")
    return (rng.rand(6, 8, 8, 4).astype(np.float32) * 4.0 - 1.0,
            "write_dds_rgba16f_cube")


@pytest.mark.parametrize("mips", [1, 3])
@pytest.mark.parametrize("kind", ["volume", "cube"])
def test_dds_writers_are_byte_identical(tmp_path, kind, mips):
    data, writer = _dds_case(kind, mips)
    ours, theirs = str(tmp_path / "port.dds"), str(tmp_path / "jax.dds")
    getattr(pdds, writer)(ours, data, mip_count=mips)
    getattr(jdds, writer)(theirs, data, mip_count=mips)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    got, want = pdds.load_dds(ours), jdds.load_dds(ours)
    assert got.mip_count == want.mip_count == mips
    assert got.is_cube == (kind == "cube") and got.is_volume == (
        kind == "volume")
    for a, b in zip(got.mips, want.mips):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    top = got.data[..., 0] if kind == "volume" else got.data
    np.testing.assert_array_equal(top, data.astype(top.dtype))


def test_band_camera_matches_jax():
    jc = jcam.orbit_camera(0.35, CFG.aspect_ratio)
    pc = port_camera(jc)
    for bands in (2, 4):
        for k in range(bands):
            got = pcam.band_camera(pc, k, bands)
            want = jcam.band_camera(jc, k, bands)
            np.testing.assert_allclose(n(got.proj), n(want.proj), atol=1e-6)
            np.testing.assert_allclose(n(got.view_proj), n(want.view_proj),
                                       atol=1e-6)
            assert torch.equal(got.eye, pc.eye) and torch.equal(got.view,
                                                                pc.view)


def test_banded_reference_frame_matches_full():
    """Four bands of a reference-semantics frame (reference march and
    light, gather composite), each rendered at a quarter of the height
    with `band_camera`, stitched, against the full frame from the same
    state (tests/test_fidelity.py:83-115, on the port)."""
    cfg = CFG.with_(march_mode="reference", light_mode="reference",
                    composite_mode="gather", packed_composite=False,
                    use_bf16=False)
    cam = pcam.orbit_camera(0.35, cfg.aspect_ratio, device="cpu")
    state = pstate.create_scene(cfg, device="cpu")
    state = pframe.render_frame(state, cam, cfg, use_taa=False).state
    full = pframe.render_frame(state, cam, cfg, use_taa=False).image
    bands = 4
    cfg_b = cfg.with_(height=cfg.height // bands)
    banded = torch.cat([pframe.render_frame(
        state, pcam.band_camera(cam, k, bands), cfg_b,
        use_taa=False).image for k in range(bands)], 0)
    assert banded.shape == full.shape
    assert float(full.amax()) > 0.1
    diff = (banded - full).abs()
    assert float(diff.mean()) < 1e-5, float(diff.mean())
    assert float(diff.max()) < 1e-2, float(diff.max())
