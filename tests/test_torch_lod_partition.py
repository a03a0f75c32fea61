"""B12, the LOD sweep's per-frame partition, and B13, each bucket's store
(`ops/lod_partition.py`), against their plain versions.

On the CPU: the dispatch rule, a CPU frame that launches neither, the
plain partition and store against the composition the sweep ran inline
before they were split out, B12's rank rule against the stable argsort,
and the partition against the JAX package (order, mips, flags). On the
card (marked `cuda`, skipped without one): B12 against
`partition_plain` over orbit eyes at radius 60 and 20 with 64 and 16
volumes, B13 against `bucket_store_plain` at every bucket size in bf16
and f32, the LOD sweep in its three contracts, and a frame's launches,
all bit for bit. This file imports neither JAX nor the JAX package at
its top, so on the machine with the card

    python -m pytest --noconftest -m cuda tests/test_torch_lod_partition.py -q
"""

import math

import numpy as np
import pytest
import torch
from torch_parity import cuda_device, write_test_mesh
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.core import math3d
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.ops import lod_partition as lod_ops
from multivolumes_tpu_torch.render import cull as cull_lib
from multivolumes_tpu_torch.render import frame as frame_lib
from multivolumes_tpu_torch.render import sweep as sweep_lib
from multivolumes_tpu_torch.render import warp as warp_lib
from multivolumes_tpu_torch.render.composite import pack_cube_f16
from multivolumes_tpu_torch.render.cull import CullResult
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.scene.state import volume_grid_worlds

S = 128
CAPS = (8, 24, 1 << 30)


def _orbit_case(n, radius, t, dev, ties=False):
    """The demo's grid of n volumes seen from the orbit eye at `radius`,
    time t, at 1280x800 -> (cull, per_object, eye, vol_tex_ids, swap
    basis) as the frame hands them to the LOD sweep. `ties` gives a third
    of the volumes the projected mip and edge of another, so their sort
    keys tie."""
    cfg = RenderConfig(num_volumes=n)
    cx, cy, cz, size = cfg.vol_pos_scale
    worlds = torch.from_numpy(volume_grid_worlds(n, size, (cx, cy, cz)))
    a = t * 0.5
    eye = [math.sin(a) * radius, 6.0, math.cos(a) * radius]
    cam = cam_lib.make_camera(eye, [0.0, 0.0, 0.0], 1280 / 800, device=dev)
    po = build_per_object(worlds.to(dev), cam.view_proj)
    cull = cull_lib.cull_volumes(po, cam.eye, [1280, 800], 256, S,
                                 cfg.num_cube_mips)
    cull = cull._replace(use_cube_map=cull.visible)
    if ties:
        src = torch.arange(n, device=dev) // 3 * 3
        cull = cull._replace(mip_level=cull.mip_level[src].contiguous(),
                             max_edge_px=cull.max_edge_px[src].contiguous())
    tex = torch.arange(n, device=dev) % 10
    basis = warp_lib.screen_basis(cam.screen_to_world, cam.eye)
    return cull, po, cam.eye, tex, basis


def _random_case(n, seed, dev="cpu"):
    """Cull rows drawn at random: few distinct mips (-1 .. 4) and edges
    (NaN, below 0, equal, above 65535), so many keys tie; some volumes
    invisible, some off the cube-map route, some faces masked."""
    rng = np.random.RandomState(seed)
    cull = CullResult(
        torch.tensor(rng.rand(n) < 0.75),
        torch.tensor(rng.randint(-1, 5, n), dtype=torch.int32),
        torch.tensor(rng.randint(1, 300, n), dtype=torch.int32),
        torch.tensor(rng.rand(n, 6) < 0.7),
        torch.tensor(rng.rand(n) < 0.8),
        torch.tensor(rng.choice([np.nan, -3.0, 10.0, 11.5, 1e6, 300.25], n),
                     dtype=torch.float32))
    cull = CullResult(*(x.to(dev) for x in cull))
    _, po, eye, _tex, basis = _orbit_case(n, 60.0, 0.4 * seed, dev)
    tex = torch.tensor(rng.randint(0, 10, n), device=dev)
    return cull, po, eye, tex, basis


def _old_partition(cull, po, eye, tex, buckets, basis):
    """The partition as `ray_march_view_sweep_lod` ran it inline before
    the split, with each bucket's B1 operands gathered as
    `bucket_march_args` gathered them -> (order, mips, n_effs, eye_local,
    eye_faces, swap, [(tex, eye faces, smp, run, light ids) a bucket])."""
    eye_local = math3d.transform_point3(eye, po.world_i)
    eye_faces = sweep_lib.eye_to_face_frames(eye_local)
    n = tex.shape[0]
    order, buckets_again = sweep_lib.lod_partition(cull, n, S, CAPS)
    assert buckets_again == buckets
    max_mip = max((S // 8).bit_length() - 1, 0)
    mips = torch.zeros((n,), dtype=torch.int32, device=eye.device)
    n_effs, march = [], []
    for (b0, count, _size_b, mip_b) in buckets:
        ids = order[b0:b0 + count]
        eff_mip = sweep_lib.bucket_mips(cull, ids, mip_b, max_mip)
        mips[ids] = eff_mip
        n_effs.append((S >> eff_mip).float())
        run = cull.face_mask[ids] & cull.visible[ids][:, None]
        march.append((tex[ids], eye_faces[ids], cull.smp_count[ids], run,
                      ids))
    swap = None
    if basis is not None:
        pos = po.take(order)
        swap = warp_lib.catmull_swap_flags(
            basis, pos.world_i, pos.world_view_proj,
            math3d.transform_point3(eye, pos.world_i), torch.cat(n_effs))
    return order, mips, n_effs, eye_local, eye_faces, swap, march


def _same(a, b):
    """Equal values and dtype; NaN where the other has NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def _store_case(size_b, dtype, seed, dev="cpu", count=5, n=9):
    """B1's output of a bucket with NaN, inf and -0.0 in it, a run mask
    with dead faces, mixed flags, and a colour stack of `dtype`."""
    rng = np.random.RandomState(seed)
    scatter = torch.tensor(rng.randn(count, 6, 4, size_b, size_b) * 3.0,
                           dtype=torch.float32)
    scatter[0, 0, 0, 0, 1] = float("nan")
    scatter[1, 2, 3, 1, 0] = float("inf")
    scatter[2, 1, 0, 2, 3] = -0.0
    run = torch.tensor(rng.rand(count, 6) < 0.6)
    run[0, 0] = run[1, 2] = True
    swap = torch.tensor(rng.rand(count, 6) < 0.5)
    swap[0, 0] = True
    color = torch.full((n, 6, 4, S, S), -7.0, dtype=dtype)
    return (scatter.to(dev), run.to(dev), swap.to(dev), color.to(dev))


def _rows(kind, count, dev):
    return (slice(2, 2 + count) if kind == "slice"
            else torch.tensor([7, 0, 3, 8, 1][:count], device=dev))


def _old_store(scatter, run, swap, color, rows, pack=False):
    """The bucket loop's epilogue as it was written inline."""
    size_b = scatter.shape[-1]
    scatter[:, :, :3] *= 1.0 / (2.0 * math.pi)
    scatter = scatter * run[:, :, None, None, None]
    out_b = pack_cube_f16(scatter) if pack else scatter.to(color.dtype)
    if swap is not None:
        out_b = torch.where(swap[:, :, None, None, None],
                            out_b.transpose(-1, -2), out_b)
    color[rows, :, :, :size_b, :size_b] = out_b


# --- on the CPU -------------------------------------------------------------

def test_dispatch_rule_on_cpu():
    cull, po, eye, tex, basis = _random_case(12, 0)
    buckets = sweep_lib.lod_buckets(12, S, CAPS)
    ops.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        lod_ops.partition(cull, po, eye, tex, S, buckets, basis,
                          impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        lod_ops.partition(cull, po, eye, tex, S, buckets, basis, impl="fast")
    scatter, run, swap, color = _store_case(32, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="CUDA"):
        lod_ops.bucket_store(scatter, run, swap, color, slice(2, 7),
                             impl="kernel")
    a = lod_ops.partition(cull, po, eye, tex, S, buckets, basis)
    b = lod_ops.partition(cull, po, eye, tex, S, buckets, basis,
                          impl="plain")
    assert all(_same(x, y) for x, y in zip(a, b))
    assert ops.LAUNCHES["lod_partition"] == ops.LAUNCHES["lod_store"] == 0


@pytest.mark.parametrize("contract", ["tile", "warp"])
@pytest.mark.parametrize("case", ["random-12", "random-40", "orbit-64-r60",
                                  "orbit-16-r20", "orbit-64-r20-ties"])
def test_plain_partition_is_the_old_composition(case, contract):
    """`partition_plain` equals the partition the sweep ran inline, bit for
    bit: order, mips, n_eff, the eye frames, the flags, and each bucket's
    slice of the ranked rows equals that bucket's old gathers."""
    kind, n = case.split("-")[:2]
    n = int(n)
    if kind == "random":
        args = _random_case(n, n)
    else:
        radius = float(case.split("-")[2][1:])
        args = _orbit_case(n, radius, 0.7, "cpu", ties=case.endswith("ties"))
    cull, po, eye, tex, basis = args
    basis = basis if contract == "tile" else None
    buckets = sweep_lib.lod_buckets(n, S, CAPS)
    got = sweep_lib.partition_plain(cull, po, eye, tex, S, buckets, basis)
    order, mips, n_effs, eye_local, eye_faces, swap, march = _old_partition(
        cull, po, eye, tex, buckets, basis)
    assert _same(got.order, order) and _same(got.mips, mips)
    assert _same(got.n_eff, torch.cat(n_effs))
    assert _same(got.eye_local, eye_local)
    assert _same(got.eye_faces, eye_faces)
    assert (got.swap is None) == (basis is None)
    if basis is not None:
        assert _same(got.swap, swap)
    for (b0, count, _sb, _mb), (tex_b, faces_b, smp_b, run_b, ids_b) in zip(
            buckets, march):
        rows = slice(b0, b0 + count)
        assert torch.equal(got.tex[rows], tex_b)          # values; int32
        assert _same(got.faces[rows], faces_b)
        assert _same(got.smp[rows], smp_b)
        assert _same(got.run[rows], run_b)
        assert torch.equal(got.ids[rows], ids_b)
        assert got.tex.dtype == got.ids.dtype == torch.int32


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("rows", ["slice", "ids"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size_b", [32, 16, 8])
def test_plain_store_is_the_old_epilogue(size_b, dtype, rows, pack):
    """`bucket_store_plain` equals the epilogue the bucket loop ran inline,
    bit for bit, with and without flags, packed (the gather composite's
    maps) or in the sweep dtype."""
    for swap_on in (True, False):
        scatter, run, swap, color = _store_case(size_b, dtype, size_b)
        if pack:
            color = torch.full((9, 6, 2, S, S), -7.0)
            swap_on = False
        swap = swap if swap_on else None
        want = color.clone()
        r = _rows(rows, 5, "cpu")
        sweep_lib.bucket_store_plain(scatter.clone(), run, swap, color, r,
                                     pack=pack)
        _old_store(scatter.clone(), run, swap, want, r, pack=pack)
        assert _same(color, want)


@pytest.mark.parametrize("seed", range(6))
def test_rank_rule_is_the_stable_argsort(seed):
    """B12's rank rule (each volume's row: the keys below it, and equal
    keys of lower index) inverts `argsort(stable=True)`; the keys tie
    often."""
    rng = np.random.RandomState(seed)
    n = [1, 2, 16, 64, 65, 300][seed]
    key = torch.tensor(rng.randint(0, 4, n) * (1 << 17)
                       + rng.randint(0, 3, n), dtype=torch.int32)
    key[rng.rand(n) < 0.2] = 1 << 30
    order = torch.argsort(key, stable=True)
    i = torch.arange(n)
    ranks = ((key[None, :] < key[:, None])
             | ((key[None, :] == key[:, None]) & (i[None, :] < i[:, None]))
             ).sum(1)
    assert torch.equal(order[ranks], i)


def test_tie_and_flag_cases_catch_a_wrong_partition():
    """The cases above catch what a faulty B12 or B13 would do: an
    unstable tie order moves rows, flags left out or not applied move
    texels, and a store without the run mask moves dead faces."""
    cull, po, eye, tex, basis = _orbit_case(64, 60.0, 0.7, "cpu", ties=True)
    buckets = sweep_lib.lod_buckets(64, S, CAPS)
    got = sweep_lib.partition_plain(cull, po, eye, tex, S, buckets, basis)
    edge = torch.clamp(cull.max_edge_px, 0.0, 65535.0).int()
    key = torch.where(cull.visible, cull.mip_level * (1 << 17)
                      + (65536 - edge), 1 << 30)
    idx = torch.arange(64)
    unstable = torch.argsort(key.long() * 64 + (63 - idx))  # ties reversed
    assert not torch.equal(unstable, got.order)
    assert bool(got.swap.any()) and not bool(got.swap.all())
    scatter, run, swap, color = _store_case(32, torch.bfloat16, 1)
    base = color.clone()
    sweep_lib.bucket_store_plain(scatter.clone(), run, swap, base,
                                 slice(2, 7))
    for wrong_swap, wrong_run in ((None, run), (swap, torch.ones_like(run))):
        other = color.clone()
        sweep_lib.bucket_store_plain(scatter.clone(), wrong_run, wrong_swap,
                                     other, slice(2, 7))
        assert not _same(other, base)


def test_partition_matches_jax():
    """The plain partition against the JAX package: the order of
    `lod_partition`, the mips of its LOD sweep's bucket loop and the flags
    of its `warp.catmull_swap_flags` on the ranked rows, on the orbit at
    radius 20 with tied keys."""
    import jax.numpy as jnp

    from multivolumes_tpu.core import math3d as jm
    from multivolumes_tpu.render import sweep as jsw
    from multivolumes_tpu.render import warp as jwarp
    from multivolumes_tpu.render.cull import CullResult as JCull

    n = 64
    cull, po, eye, tex, basis = _orbit_case(n, 20.0, 1.3, "cpu", ties=True)
    buckets = sweep_lib.lod_buckets(n, S, CAPS)
    got = sweep_lib.partition_plain(cull, po, eye, tex, S, buckets, basis)

    jc = JCull(**{f: jnp.asarray(getattr(cull, f).numpy())
                  for f in cull._fields})
    order, jbuckets = jsw.lod_partition(jc, n, S, CAPS)
    assert jbuckets == buckets
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(order))
    wi, wvp = jnp.asarray(po.world_i.numpy()), jnp.asarray(
        po.world_view_proj.numpy())
    eye_local = jm.transform_point3(jnp.asarray(eye.numpy()), wi)
    max_mip = max((S // 8).bit_length() - 1, 0)
    mips = np.zeros(n, np.int32)
    for (b0, count, _size_b, mip_b) in buckets:
        ids = order[b0:b0 + count]
        actual = jnp.clip(jc.mip_level[ids], 0, max_mip)
        eff = jnp.clip(jnp.maximum(actual + (~jc.use_cube_map[ids]).astype(
            jnp.int32), mip_b), mip_b, max_mip)
        mips[np.asarray(ids)] = np.asarray(eff)
        flags = jwarp.catmull_swap_flags(
            jnp.asarray(basis.numpy()), wi[ids], wvp[ids], eye_local[ids],
            (S >> eff).astype(jnp.float32))
        np.testing.assert_array_equal(got.swap[b0:b0 + count].numpy(),
                                      np.asarray(flags))
    np.testing.assert_array_equal(got.mips.numpy(), mips)
    assert len(set(mips.tolist())) > 1 and bool(got.swap.any())


def test_cpu_frame_launches_neither(tmp_path):
    cfg = RenderConfig(width=96, height=64, grid_size=16, light_grid_size=8,
                       max_ray_samples=16, max_light_samples=8,
                       num_volumes=10, num_volume_srcs=2, cube_map_size=32,
                       shadow_map_size=64)
    eng = MultiRayCaster(cfg, device="cpu")
    eng.set_mesh(write_test_mesh(tmp_path / "torus.obj", 500))
    cam = cam_lib.orbit_camera(0.3, cfg.aspect_ratio, device="cpu")
    calls = []
    orig = lod_ops.partition

    def spy(*a, **k):
        calls.append(k.get("impl"))
        return orig(*a, **k)

    lod_ops.partition = spy
    try:
        ops.reset_launches()
        frame_lib.render_frame(eng.state, cam, eng.config)
    finally:
        lod_ops.partition = orig
    assert len(calls) == 1
    assert all(v == 0 for v in ops.LAUNCHES.values())


# --- on the card ------------------------------------------------------------

def _diff(name, got, want):
    """Fields that differ from plain, with how many elements each."""
    bad = []
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:
            if (g is None) != (w is None):
                bad.append((f, "None"))
            continue
        if not _same(g, w):
            bad.append((f, int((g != w).sum())))
    if bad:
        print(f"{name}: {bad}")
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 16])
def test_b12_matches_plain_on_card(n):
    """B12 against `partition_plain` at 48 orbit eyes at radius 60 and 48
    at 20, with the swap basis (the tile composite) and without (the warp
    and gather composites), every third eye with tied sort keys: every
    output equal. The eyes include invisible volumes and, at radius 20,
    volumes cut by the near plane, which the cull drops."""
    dev = cuda_device()
    bad, cut, hidden, tied = [], 0, 0, 0
    for radius in (60.0, 20.0):
        for k in range(48):
            t = 4.0 * math.pi * k / 48
            cull, po, eye, tex, basis = _orbit_case(n, radius, t, dev,
                                                    ties=k % 3 == 0)
            buckets = sweep_lib.lod_buckets(n, S, CAPS)
            for b in (basis, None):
                ops.reset_launches()
                got = lod_ops.partition(cull, po, eye, tex, S, buckets, b,
                                        impl="kernel")
                assert ops.LAUNCHES["lod_partition"] == 1
                want = lod_ops.partition(cull, po, eye, tex, S, buckets, b,
                                         impl="plain")
                torch.cuda.synchronize()
                d = _diff(f"N={n} r={radius} t={t:.3f} basis={b is not None}",
                          got, want)
                bad += d
            hidden += int((~cull.visible).sum())
            edge = torch.clamp(cull.max_edge_px, 0.0, 65535.0).int()
            key = torch.where(cull.visible, cull.mip_level * (1 << 17)
                              + (65536 - edge), 1 << 30)
            tied += int(key.numel() - key.unique().numel())
            view_z = math3d.transform_point(
                po.world[:, 3, :3], cam_lib.make_camera(
                    eye, [0.0, 0.0, 0.0], 1.6, device=dev).view)[:, 2]
            near = view_z.abs() < po.world[:, 0, 0] * 1.8
            cut += int((near & ~cull.visible).sum())
    print(f"N={n}: {hidden} invisible, {tied} tied keys, {cut} cut by the "
          f"near plane over 96 eyes")
    assert hidden and tied and (cut or n == 16)
    assert not bad, bad[:10]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("size_b", [128, 64, 32])
def test_b13_matches_plain_on_card(size_b, dtype):
    """B13 against `bucket_store_plain`, with and without flags, rows as a
    slice and as indices: every bit of the colour stack equal (NaN where
    plain has NaN); without the transpose or the run mask the store
    differs."""
    dev = cuda_device()
    for rows in ("slice", "ids"):
        for swap_on in (True, False):
            scatter, run, swap, color = _store_case(size_b, dtype, size_b,
                                                    dev)
            swap = swap if swap_on else None
            want = color.clone()
            r = _rows(rows, 5, dev)
            ops.reset_launches()
            lod_ops.bucket_store(scatter.clone(), run, swap, color, r,
                                 impl="kernel")
            assert ops.LAUNCHES["lod_store"] == 1
            lod_ops.bucket_store(scatter.clone(), run, swap, want, r,
                                 impl="plain")
            torch.cuda.synchronize()
            assert _same(color, want), (rows, swap_on)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            nan = color.isnan()
            assert torch.equal(color.view(bits)[~nan], want.view(bits)[~nan])
            if swap_on:
                for wrong_swap, wrong_run in ((None, run),
                                              (swap, torch.ones_like(run))):
                    other = torch.full_like(color, -7.0)
                    lod_ops.bucket_store(scatter.clone(), wrong_run,
                                         wrong_swap, other, r, impl="kernel")
                    assert not _same(other, want)


@pytest.mark.cuda
@pytest.mark.parametrize("contract", ["tile", "warp", "gather"])
def test_lod_sweep_on_card(contract, tmp_path):
    """The LOD sweep of a frame with the mesh through B12 / B13 and through
    their plain versions (B7 and B1 the kernels on both sides): maps, cube
    depth, mips, order and flags equal; one `lod_partition` launch, one
    `lod_store` a bucket (none for the gather composite's packed maps);
    and a frame launches B12 once and B13 once a bucket."""
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
    assert ops.LAUNCHES["lod_partition"] == 1
    assert ops.LAUNCHES["lod_store"] == ops.LAUNCHES["sweep"] == 3
    a, k = captured["args"]
    k = dict(k, impl="kernel")
    if contract != "tile":
        a = a[:7] + (None,) + a[8:]
        k.update(sorted_output=False, pack=contract == "gather")
    ops.reset_launches()
    got = orig(*a, **k)
    assert ops.LAUNCHES["lod_partition"] == 1
    assert ops.LAUNCHES["lod_store"] == (0 if contract == "gather" else 3)
    plain = (lod_ops.partition, lod_ops.bucket_store)
    lod_ops.partition = lambda *pa, **pk: plain[0](*pa, **dict(pk,
                                                              impl="plain"))
    lod_ops.bucket_store = lambda *pa, **pk: plain[1](*pa, **dict(
        pk, impl="plain"))
    try:
        want = orig(*a, **k)
    finally:
        lod_ops.partition, lod_ops.bucket_store = plain
    torch.cuda.synchronize()
    assert torch.equal(got.order, want.order)
    assert torch.equal(got.mips, want.mips)
    assert (got.swap is None) == (contract != "tile")
    if got.swap is not None:
        assert torch.equal(got.swap, want.swap)
    assert torch.equal(got.cube_maps.depth, want.cube_maps.depth)
    assert _same(got.cube_maps.color, want.cube_maps.color)
