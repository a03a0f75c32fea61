"""Shared helpers for the parity tests of the PyTorch port
(`tests/test_torch_*.py`): inputs cross between the two packages as
numpy arrays."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


def t(x, dtype=torch.float32) -> torch.Tensor:
    """JAX array / numpy -> CPU tensor (a writable copy)."""
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def n(x) -> np.ndarray:
    """Tensor or JAX array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def jax_state_dict(state) -> dict:
    """A JAX SceneState as {field: numpy array}."""
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


def port_camera(jcam):
    """The port's Camera holding a JAX camera's matrices."""
    from multivolumes_tpu_torch.core.camera import Camera

    return Camera(eye=t(jcam.eye), view=t(jcam.view), proj=t(jcam.proj))


def port_per_object(jpo):
    from multivolumes_tpu_torch.render.perframe import PerObject

    return PerObject(*(t(x) for x in jpo))


def port_cull(jcull):
    from multivolumes_tpu_torch.render.cull import CullResult

    def conv(x):
        a = np.asarray(x)
        return torch.from_numpy(a.copy())

    return CullResult(*(conv(x) for x in jcull))


def image_stats(a, b, pct: float):
    """|a - b| -> (mean, percentile pct, max)."""
    d = np.abs(n(a) - n(b))
    return float(d.mean()), float(np.percentile(d, pct)), float(d.max())


def clone_state(state):
    """A port SceneState with every tensor copied (frames update the light
    stacks in place)."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def taa_operands(device, h, w, seed=0):
    """Seeded B5 operands (cur, hist, blur) that reach the history blend:
    half the alpha at 1, a random history with some full counts, and a
    non-zero blur on half the pixels, so both clamp gammas and the count
    run."""
    rng = np.random.RandomState(seed)
    cur = rng.rand(4, h, w).astype(np.float32) * 2.0
    cur[3] = np.where(rng.rand(h, w) < 0.5, 1.0, 0.5)
    hist = rng.rand(4, h, w).astype(np.float32)
    hist[3] = np.where(rng.rand(h, w) < 0.3, 1.0, hist[3])
    blur = np.where(rng.rand(h, w) < 0.5, 0.0, rng.rand(h, w) * 1.5)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (cur, hist, blur))


def cuda_device() -> torch.device:
    """The card, or skip: CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only there; "
                    "chip_smoke.py runs them on the card)")
    return torch.device("cuda")


def jax_lod_case():
    """A 12-volume f32 JAX scene, an orbit camera, and the JAX LOD sweep's
    sorted output with Catmull-Smith flags (Pallas in interpret mode):
    (cfg, state, camera, per_object, lod_cull, screen basis, (maps, mips,
    order, swap))."""
    import jax
    import jax.numpy as jnp

    from multivolumes_tpu.config import RenderConfig
    from multivolumes_tpu.core import camera as jcam
    from multivolumes_tpu.core import math3d as jm
    from multivolumes_tpu.render import cull as jcull
    from multivolumes_tpu.render import sweep as jsw
    from multivolumes_tpu.render import warp as jwarp
    from multivolumes_tpu.render.perframe import build_per_object as jbpo
    from multivolumes_tpu.scene import state as jstate

    cfg = RenderConfig(width=128, height=96, grid_size=16, light_grid_size=8,
                       max_ray_samples=24, max_light_samples=8,
                       num_volumes=12, num_volume_srcs=2, cube_map_size=32,
                       shadow_map_size=32, use_bf16=False)
    st = jstate.create_scene(cfg)
    cam = jcam.orbit_camera(0.3, cfg.aspect_ratio)
    po = jbpo(st.volume_worlds, cam.view_proj)
    cull = jcull.cull_volumes(po, cam.eye, jnp.array([128.0, 96.0]),
                              cfg.max_ray_samples, 32, cfg.num_cube_mips)
    lod_cull = cull._replace(use_cube_map=cull.visible)
    basis = jwarp.screen_basis(jm.inverse(cam.view_proj), cam.eye)
    out = jax.jit(lambda s_: jsw.ray_march_view_sweep_lod(
        s_.volumes_oriented, s_.vol_tex_ids, s_.light_maps_oriented, po,
        lod_cull, cam.eye, None, 32, dtype=jnp.float32, pack=False,
        light_w=cfg.light_grid_size, vol_zmax=s_.vol_zmax,
        sorted_output=True, swap_basis=basis))(st)
    return cfg, st, cam, po, lod_cull, basis, out
