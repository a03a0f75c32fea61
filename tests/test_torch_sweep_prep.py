"""B7, the LOD-bucket prologue of the sweep (`ops/sweep_prep.py`), against
its plain version.

On the CPU: the dispatch rule, a CPU frame that launches nothing, and the
plain prologue against the composition the bucket loop ran before it
moved into `render/sweep.py:bucket_prologue_plain`, bit for bit. On the
card (marked `cuda`, skipped without one): the kernel against the plain
version at every coarse factor, with and without a depth map, in both
cube-depth contracts, with an eye inside a volume and volumes behind it;
B1 on the two sets of ray operands; the frame's launches. This file
imports neither JAX nor the JAX package, so on the machine with the card

    python -m pytest --noconftest -m cuda tests/test_torch_sweep_prep.py -q
"""

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, write_test_mesh
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig, SharedConsts
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.ops import sweep as sweep_ops
from multivolumes_tpu_torch.ops import sweep_prep
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import sweep as sweep_lib
from multivolumes_tpu_torch.render.composite import unproject_z
from multivolumes_tpu_torch.render.perframe import build_per_object

S = 128                      # the cube maps' side
SIZES = (128, 64, 32, 16)    # coarse factors 4, 4, 2, 1
# scene depth maps: none, the demo's, odd-sized (no pooling), and one
# whose first 2x2 pool leaves an odd size (401 x 641: one pool at every
# S_b); on the CPU the same cases, small
DEPTHS = {"none": None, "1280x800": (800, 1280), "odd": (801, 1279),
          "half-odd": (802, 1282)}
CPU_DEPTHS = {"none": None, "even": (80, 128), "odd": (81, 127),
              "half-odd": (82, 130)}


def _scene(dev, n=12, seed=0):
    """(per_object, eye_local, eye_faces) of n volumes of half-size 4: the
    first holds the eye, the rest lie around it, some behind the camera,
    which looks along +z."""
    rng = np.random.RandomState(seed)
    eye = torch.tensor([0.5, 1.0, -0.7])
    pos = np.zeros((n, 3))
    pos[1:] = rng.uniform(-40.0, 40.0, (n - 1, 3))
    pos[1:, 1] *= 0.3
    worlds = torch.zeros((n, 4, 4))
    scale = 4.0 * rng.uniform(0.6, 1.4, n)
    scale[0] = 4.0
    for i in range(n):
        worlds[i] = torch.diag(torch.tensor([scale[i]] * 3 + [1.0]))
        worlds[i, 3, :3] = torch.tensor(pos[i], dtype=torch.float32)
    cam = cam_lib.make_camera(eye, [0.0, 0.0, 30.0], 1280 / 800,
                              device="cpu")
    per_object = build_per_object(worlds, cam.view_proj)
    eye_local = math3d.transform_point3(eye, per_object.world_i)
    assert bool((eye_local[0].abs() <= 1.0).all())          # inside
    view_z = math3d.transform_point(torch.tensor(pos, dtype=torch.float32),
                                    cam.view)[:, 2]
    assert int((view_z < 0).sum()) >= 2                      # behind
    eye_faces = sweep_lib.eye_to_face_frames(eye_local)
    return tuple(x.to(dev) for x in per_object), eye_local.to(dev), \
        eye_faces.to(dev)


def _depth(shape, dev, seed=1):
    """A scene clip depth whose values all differ (so equal sampled depths
    are equal taps): steps of 1e-7, over 1.6 f32 ulps, from 0.889 (view
    distances of about 9 to 100), with a far (1.0) band where nothing
    occludes."""
    if shape is None:
        return None
    rng = np.random.RandomState(seed)
    d = (0.889 + 1e-7 * rng.permutation(shape[0] * shape[1])).reshape(
        shape).astype(np.float32)
    d[: shape[0] // 5] = 1.0
    return torch.from_numpy(d).to(dev)


def _bucket(n, size_b, seed):
    """ids (count,) of a bucket at size_b, their n_eff (at or below
    size_b, powers of two), the Catmull-Smith flags of its rows."""
    rng = np.random.RandomState(seed)
    count = 5
    # the volume with the eye first, then others, all distinct
    ids = torch.tensor([0] + list(1 + rng.permutation(n - 1)[:count - 1]))
    n_eff = torch.tensor([size_b, size_b, size_b // 2, size_b,
                          max(size_b // 4, 8)], dtype=torch.float32)
    swap = torch.tensor(rng.rand(count, 6) < 0.5)
    return ids, n_eff, swap


def _run(scene, ids, n_eff, size_b, depth, contract, impl, b0=3):
    """One bucket's prologue -> (SweepParams, cube_depth); `contract`
    "tile" (swap flags, sorted rows b0..) or "warp" (no flags, rows ids)."""
    per_object, eye_local, eye_faces = scene
    dev = eye_faces.device
    n = eye_faces.shape[0]
    swap = None
    if contract[0] == "tile":
        swap = contract[1].to(dev)
    rows = slice(b0, b0 + ids.shape[0]) if swap is not None else ids.to(dev)
    cube = None
    if depth is not None:
        cube = torch.full((n, 6, S, S), SharedConsts.Z_FAR if swap is not None
                          else 1.0, dtype=torch.float32, device=dev)
    params = sweep_prep.sweep_prologue(
        sweep_lib.PerObject(*per_object), eye_local, eye_faces, ids.to(dev),
        n_eff.to(dev), size_b, depth_map=depth, swap=swap, cube_depth=cube,
        rows=rows, impl=impl)
    return params, cube


def _old_composition(scene, ids, n_eff, size_b, depth, swap, rows, cube):
    """The bucket loop's prologue as it was written inline (before B7)."""
    per_object, eye_local, eye_faces = scene
    po = sweep_lib.PerObject(*per_object)
    s_max_b = None
    if depth is not None:
        s_max_b, depth_b = sweep_lib.bucket_occlusion(
            po, eye_local, sweep_lib._pool2_max(depth), ids, size_b, n_eff)
        if swap is not None:
            sw = swap[:, :, None, None]
            depth_b = unproject_z(depth_b.float())
            depth_b = torch.where(sw, depth_b.transpose(-1, -2), depth_b)
        cube[rows, :, :size_b, :size_b] = depth_b
    count = ids.shape[0]
    ar = torch.arange(size_b, dtype=torch.float32)
    u = (ar[None] + 0.5) / n_eff[:, None] * 2.0 - 1.0
    u6 = u.repeat_interleave(6, dim=0)
    params = sweep_lib.face_ray_params(
        eye_faces[ids].reshape(count * 6, 3), u6, -u6,
        None if s_max_b is None else s_max_b.reshape(count * 6, size_b,
                                                     size_b))
    in_corner = ((ar[None, None, :] < n_eff[:, None, None])
                 & (ar[None, :, None] < n_eff[:, None, None]))
    shape = (count, 6, size_b, size_b)
    return sweep_lib.SweepParams(
        *(x.reshape(shape) for x in (params.s_in, params.s_end,
                                     params.ray_len)),
        params.active.reshape(shape) & in_corner[:, None])


def test_prologue_dispatch_rule_on_cpu():
    scene = _scene("cpu")
    ids, n_eff, swap = _bucket(12, 32, 0)
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        _run(scene, ids, n_eff, 32, None, ("warp",), "kernel")
    with pytest.raises(ValueError, match="impl"):
        _run(scene, ids, n_eff, 32, None, ("warp",), "fast")
    a, _ = _run(scene, ids, n_eff, 32, _depth((80, 128), "cpu"),
                ("tile", swap), None)
    b, _ = _run(scene, ids, n_eff, 32, _depth((80, 128), "cpu"),
                ("tile", swap), "plain")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ops.LAUNCHES["sweep_prologue"] == 0


@pytest.mark.parametrize("size_b", SIZES)
@pytest.mark.parametrize("contract", ["tile", "warp"])
@pytest.mark.parametrize("depth", list(CPU_DEPTHS))
def test_plain_prologue_is_the_old_composition(size_b, contract, depth):
    """The plain prologue equals the composition the bucket loop ran
    inline, bit for bit: the ray operands and the cube depth."""
    scene = _scene("cpu")
    ids, n_eff, swap = _bucket(12, size_b, size_b)
    dm = _depth(CPU_DEPTHS[depth], "cpu")
    got, cube = _run(scene, ids, n_eff, size_b, dm,
                     (contract, swap), None)
    sw = swap if contract == "tile" else None
    rows = slice(3, 3 + ids.shape[0]) if sw is not None else ids
    want_cube = None if cube is None else torch.full_like(
        cube, SharedConsts.Z_FAR if sw is not None else 1.0)
    want = _old_composition(scene, ids, n_eff, size_b, dm, sw, rows,
                            want_cube)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if dm is not None:
        assert torch.equal(cube, want_cube)
        # the depth bound took effect: some ray ends at the scene
        free = sweep_lib.bucket_ray_params(scene[2], ids, size_b, n_eff)
        assert bool((got.s_end < free.s_end).any())


def test_cpu_frame_launches_no_prologue(tmp_path):
    cfg = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                       max_ray_samples=16, max_light_samples=8,
                       num_volumes=10, num_volume_srcs=2, cube_map_size=32,
                       shadow_map_size=64)
    eng = MultiRayCaster(cfg, device="cpu")
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 500))
    cam = cam_lib.orbit_camera(0.3, cfg.aspect_ratio, device="cpu")
    calls = []
    orig = sweep_prep.sweep_prologue

    def spy(*a, **k):
        calls.append(k.get("depth_map") is not None)
        return orig(*a, **k)

    sweep_prep.sweep_prologue = spy
    try:
        ops.reset_launches()
        frame_lib.render_frame(eng.state, cam, eng.config)
    finally:
        sweep_prep.sweep_prologue = orig
    assert calls and all(calls)           # every bucket, with the depth map
    assert ops.LAUNCHES["sweep_prologue"] == 0
    assert all(v == 0 for v in ops.LAUNCHES.values())


# --- on the card ------------------------------------------------------------

def _compare(name, got, want, rel=1e-6):
    """Equal, or within `rel` relative; prints the count and size of the
    elements that differ."""
    differ = got != want
    n = int(differ.sum())
    size = 0.0
    if n:
        size = float(((got - want).abs() / want.abs().clamp(min=1e-30))
                     [differ].max())
    print(f"{name}: {n} of {got.numel()} differ, max rel {size:.3e}")
    assert size <= rel, (name, n, size)


def _b1_stacks(dev, seed=0, n_src=2, d=12, dl=8):
    rng = np.random.RandomState(seed)
    vols = torch.tensor(rng.rand(n_src, d, d, d, 4), dtype=torch.float32)
    light = torch.tensor(rng.rand(12, dl, dl, dl, 4), dtype=torch.float32)
    light[..., 3] = 0
    return vols.to(dev), light.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", list(DEPTHS))
def test_b7_kernel_matches_plain_on_card(depth):
    """Every coarse factor, both contracts: equal active masks and sampled
    depths (the depth map's values all differ, so equal depths are equal
    taps), the rest equal or within 1e-6 relative, and B1 on the two sets
    of ray operands within B1's card-test limit."""
    dev = cuda_device()
    scene = _scene(dev)
    dm = _depth(DEPTHS[depth], dev)
    if dm is not None:
        pooled = sweep_lib._pool2_max(dm)
        near = pooled[pooled < 1.0]
        assert near.unique().numel() == near.numel()
    vols, light = _b1_stacks(dev)
    for size_b in SIZES:
        ids, n_eff, swap = _bucket(12, size_b, size_b)
        for contract in (("tile", swap), ("warp",)):
            tag = f"{depth} S_b={size_b} {contract[0]}"
            ops.reset_launches()
            got, cube_k = _run(scene, ids, n_eff, size_b, dm, contract,
                               "kernel")
            assert ops.LAUNCHES["sweep_prologue"] == 1
            want, cube_p = _run(scene, ids, n_eff, size_b, dm, contract,
                                "plain")
            torch.cuda.synchronize()
            assert torch.equal(got.active, want.active), tag
            for field in ("s_in", "s_end", "ray_len"):
                _compare(f"{tag} {field}", getattr(got, field),
                         getattr(want, field))
            if dm is not None:
                if contract[0] == "warp":
                    assert torch.equal(cube_k, cube_p), tag   # the taps
                _compare(f"{tag} cube depth", cube_k, cube_p)
            count = ids.shape[0]
            tex = torch.tensor([1, 0, 1, 0, 1], device=dev)[:count]
            eye_f = scene[2][ids.to(dev)]
            smp = torch.full((count,), 24, dtype=torch.int32, device=dev)
            run = torch.ones((count, 6), dtype=torch.bool, device=dev)
            march = [sweep_ops.sweep_march(
                vols, light, tex, eye_f, p, smp, run, size_b, size_b,
                n_eff_b=n_eff.to(dev), light_ids=ids.to(dev),
                impl="kernel") for p in (got, want)]
            torch.testing.assert_close(march[0], march[1], atol=2e-3,
                                       rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("contract", ["tile", "warp", "gather"])
def test_b7_in_the_lod_sweep_on_card(contract, tmp_path):
    """The LOD sweep of a frame with the mesh, its prologue by B7 and by
    the plain version (B1 the kernel on both sides): one B7 launch a
    bucket, the cube depth equal within 1e-6 relative, the maps within
    B1's card-test limit; and the frame launches B7 with every other
    kernel of the mesh frame."""
    dev = cuda_device()
    cfg = RenderConfig(width=320, height=200, grid_size=16, light_grid_size=8,
                       max_ray_samples=24, max_light_samples=8,
                       num_volumes=40, num_volume_srcs=2, cube_map_size=64,
                       shadow_map_size=64)
    eng = MultiRayCaster(cfg, device=dev)
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 2000))
    cam = cam_lib.make_camera([10.0, -4.0, -35.0], [0.0, -2.0, 5.0],
                              cfg.aspect_ratio, device=dev)
    captured = {}
    orig = sweep_lib.ray_march_view_sweep_lod

    def spy(*a, **k):
        captured.setdefault("args", (a, k))
        return orig(*a, **k)

    sweep_lib.ray_march_view_sweep_lod = spy
    try:
        ops.reset_launches()
        frame_lib.render_frame(eng.state, cam, eng.config, impl="kernel")
    finally:
        sweep_lib.ray_march_view_sweep_lod = orig
    for name in ("sweep", "sweep_prologue", "composite_depth",
                 "light_self_scan_sm", "light_advect_mul", "taa"):
        assert ops.LAUNCHES[name] > 0, ops.LAUNCHES
    a, k = captured["args"]
    assert k["depth_map"] is not None
    k = dict(k, impl="kernel")
    if contract != "tile":
        a = a[:7] + (None,) + a[8:]
        k.update(sorted_output=False, pack=contract == "gather")
    plain = sweep_prep.sweep_prologue

    def plain_prologue(*pa, **pk):
        return plain(*pa, **dict(pk, impl="plain"))

    ops.reset_launches()
    got = orig(*a, **k)
    n_buckets = ops.LAUNCHES["sweep_prologue"]
    assert n_buckets == ops.LAUNCHES["sweep"] == 3, ops.LAUNCHES
    sweep_prep.sweep_prologue = plain_prologue
    try:
        want = orig(*a, **k)
    finally:
        sweep_prep.sweep_prologue = plain
    assert ops.LAUNCHES["sweep_prologue"] == n_buckets
    torch.cuda.synchronize()
    assert torch.equal(got.order, want.order)
    assert torch.equal(got.mips, want.mips)
    _compare(f"{contract} cube depth", got.cube_maps.depth,
             want.cube_maps.depth)
    torch.testing.assert_close(got.cube_maps.color.float(),
                               want.cube_maps.color.float(), atol=2e-3,
                               rtol=2e-2)
