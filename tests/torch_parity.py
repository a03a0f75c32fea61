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


def port_config(jcfg):
    """The port's RenderConfig with every field of a JAX RenderConfig."""
    from multivolumes_tpu_torch.config import RenderConfig

    return RenderConfig(**dataclasses.asdict(jcfg))


def write_test_mesh(path, n_tris: int, major: float = 3.0,
                    minor: float = 1.2, y0: float = 2.0) -> str:
    """Write a closed torus of about `n_tris` triangles as an OBJ and
    return the path.

    Test data standing in for the reference demo's `Assets/bunny.obj`,
    which is not in the repository: a closed surface of bunny size
    (69,451 triangles at 70k) in OBJ units. The ring lies flat (axis y),
    centred at height y0, so at the demo's mesh placement (0, -9, 0,
    1.8) it reaches into the lowest volumes. Faces wind counter-clockwise
    seen from outside (the OBJ convention), so after `load_obj(for_dx=
    True)` front faces have positive screen area, as the bunny's do."""
    nv = max(3, int(round(np.sqrt(n_tris / 4.0))))
    nu = max(3, int(round(n_tris / (2.0 * nv))))
    th = np.arange(nu) * (2.0 * np.pi / nu)
    ph = np.arange(nv) * (2.0 * np.pi / nv)
    t, p = np.meshgrid(th, ph, indexing="ij")              # (nu, nv)
    ring = major + minor * np.cos(p)
    verts = np.stack([ring * np.cos(t), y0 + minor * np.sin(p),
                      ring * np.sin(t)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    # orient outward: the first face's normal against the tube's outward
    # direction at its first vertex
    v0, v1, v2 = verts[faces[0]]
    nrm = np.cross(v1 - v0, v2 - v0)
    centre = np.array([major * np.cos(th[0]), y0, major * np.sin(th[0])])
    if np.dot(nrm, v0 - centre) < 0:
        faces = faces[:, [0, 2, 1]]
    with open(path, "w") as f:
        f.write(f"# torus, {len(faces)} triangles\n")
        f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n"
                        for x, y, z in verts))
        f.write("".join(f"f {x + 1} {y + 1} {z + 1}\n"
                        for x, y, z in faces))
    return str(path)


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


def pallas_raster_bin_eval(tile_of_chunk, x0, y0, coef, n_tiles: int):
    """The binned-raster eval kernel of `tools/raster_bin_microbench.py`
    in interpret mode. The tool builds its `pallas_call` inside `main()`,
    so this restates the kernel body and the call (lines 138-177) on
    numpy operands -> (n_tiles * 8, 128) int32. Tiles that no chunk maps
    to are never written and hold no defined value."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    n_c = tile_of_chunk.shape[0]
    first = np.ones((n_c,), np.int32)
    first[1:] = tile_of_chunk[1:] != tile_of_chunk[:-1]

    def kern(tile_ref, first_ref, x0_ref, y0_ref, coef_ref, out_ref):
        i = pl.program_id(0)
        xg = jax.lax.broadcasted_iota(jnp.int32, (8, 128, 128), 1) \
            .astype(jnp.float32) + x0_ref[i] + 0.5
        yg = jax.lax.broadcasted_iota(jnp.int32, (8, 128, 128), 0) \
            .astype(jnp.float32) + y0_ref[i] + 0.5
        c = coef_ref[...]                       # (16, 128)
        c1 = xg * c[0][None, None] + yg * c[1][None, None] + c[2][None, None]
        c2 = xg * c[3][None, None] + yg * c[4][None, None] + c[5][None, None]
        z = xg * c[6][None, None] + yg * c[7][None, None] + c[8][None, None]
        b0 = 1.0 - c1 - c2
        ok = (jnp.minimum(jnp.minimum(c1, c2), b0) >= 0.0) \
            & (z >= 0.0) & (z <= 1.0)
        zq = jnp.clip(z * 32767.0, 0, 32767).astype(jnp.int32)
        tid = c[9][None, None].astype(jnp.int32)
        packed = jnp.where(ok, (zq << 17) | tid, jnp.int32(0x7FFFFFFF))
        m = jnp.min(packed, axis=-1)            # (8, 128)

        @pl.when(first_ref[i] == 1)
        def _init():
            out_ref[...] = m

        @pl.when(first_ref[i] == 0)
        def _acc():
            out_ref[...] = jnp.minimum(out_ref[...], m)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4,
        grid=(n_c,),
        in_specs=[pl.BlockSpec((16, 128), lambda i, *s: (0, i))],
        out_specs=pl.BlockSpec((8, 128), lambda i, t, f, x, y: (t[i], 0)),
    )
    evalk = pl.pallas_call(
        kern,
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_tiles * 8, 128), jnp.int32),
        interpret=True,
    )
    return np.asarray(evalk(jnp.asarray(tile_of_chunk), jnp.asarray(first),
                            jnp.asarray(x0), jnp.asarray(y0),
                            jnp.asarray(coef)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests. The reference marches
    are loops of small tensor ops; under a parallel run every worker's
    OpenMP threads would spin against the others' (on an 8-core CPU, six
    workers of eight threads each ran the fidelity test 45 times slower
    than six workers of one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_sharded_gaps(settings, meshes=((4, 1), (2, 2)), frames: int = 2):
    """How far the JAX sharded step (`parallel.sharding.make_sharded_step`)
    is from the JAX unsharded frame, per setting and mesh, at the
    configuration of tests/test_torch_sharding_modes.py: {(setting,
    (volume shards, rows)): [(mean, p99.9, max) per frame]}, or the
    exception a step raised. Needs the 8 virtual CPU devices that
    tests/conftest.py sets up (`XLA_FLAGS=--xla_force_host_platform_
    device_count=8`)."""
    import jax

    from multivolumes_tpu.config import RenderConfig
    from multivolumes_tpu.core import camera as jcam
    from multivolumes_tpu.parallel import sharding as jsh
    from multivolumes_tpu.render import frame as jframe
    from multivolumes_tpu.scene import state as jstate

    base = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                        max_ray_samples=16, max_light_samples=8,
                        num_volumes=4, num_volume_srcs=2, cube_map_size=16,
                        shadow_map_size=32, use_bf16=False, light_axis=2)
    out = {}
    for name, change in settings.items():
        cfg = base.with_(**change)
        st = jstate.create_scene(cfg)
        cam = jcam.default_camera(cfg.aspect_ratio)
        step1 = jax.jit(lambda s, c, cfg=cfg: jframe.render_frame(s, c, cfg))
        want, s1 = [], st
        for _ in range(frames):
            o = step1(s1, cam)
            want.append(np.asarray(o.image))
            s1 = o.state
        for nd, rows in meshes:
            try:
                mesh = jsh.make_mesh(nd, rows=rows)
                step = jsh.make_sharded_step(cfg, mesh)
                js, gaps = jsh.shard_state(st, mesh), []
                for k in range(frames):
                    img, js = step(js, cam)
                    d = np.abs(np.asarray(img) - want[k])
                    gaps.append((float(d.mean()),
                                 float(np.percentile(d, 99.9)),
                                 float(d.max())))
                out[name, (nd, rows)] = gaps
            except Exception as e:                  # noqa: BLE001
                out[name, (nd, rows)] = e
    return out


if __name__ == "__main__":
    # the JAX sharded step in each setting of the port's sharded-step tests
    import os
    import sys

    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.dirname(here)]
    from test_torch_sharding_modes import SETTINGS

    for key, gaps in jax_sharded_gaps(SETTINGS).items():
        print(key, gaps, flush=True)
