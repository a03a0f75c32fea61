"""The port's TAA resolve (plain version of B5 and the reprojection of
`render/taa.py`) against the JAX package: its semantics twin
`taa._temporal_aa_jnp` and its Pallas kernel `taa_kernel.taa_resolve`
(interpret mode on the CPU), both outputs, at atol 2e-5, the tolerance
between the JAX kernel and its twin (tests/test_pallas_taa.py:31-34).
Plus the pass invariants of tests/test_passes.py:14-49."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import n, t, taa_operands

from multivolumes_tpu.ops.pallas import taa_kernel
from multivolumes_tpu.render import taa as jtaa
from multivolumes_tpu_torch.ops import taa as taa_ops
from multivolumes_tpu_torch.render import taa as ptaa

ATOL = 2e-5


def _inputs(h, w, seed=0, with_velocity=False):
    """tests/test_pallas_taa.py:_mk_inputs: half the alpha at 1, a random
    history, and optionally a small random velocity."""
    rng = np.random.RandomState(seed)
    cur = [rng.rand(h, w).astype(np.float32) * 2.0 for _ in range(3)]
    cur.append(np.where(rng.rand(h, w) < 0.5, 1.0, 0.5).astype(np.float32))
    hist = rng.rand(4, h, w).astype(np.float32)
    vel = None
    if with_velocity:
        vel = [((rng.rand(h, w) - 0.5) * 0.01).astype(np.float32)
               for _ in range(2)]
    return cur, hist, vel


def _jax(x):
    return None if x is None else tuple(jnp.asarray(a) for a in x)


@pytest.mark.parametrize("h,w,with_velocity", [
    (72, 200, False), (72, 200, True), (64, 128, False), (64, 128, True)])
def test_temporal_aa_matches_jax(h, w, with_velocity):
    cur, hist, vel = _inputs(h, w, with_velocity=with_velocity)
    rgb_p, nh_p, img_p = ptaa.temporal_aa(
        [t(x) for x in cur], t(hist), None if vel is None else
        [t(x) for x in vel], tonemap_out=True)
    (r0, g0, b0), nh_twin = jtaa.temporal_aa(
        _jax(cur), jnp.asarray(hist), _jax(vel), use_pallas=False)
    (_r1, _g1, _b1), nh_pallas, img_pallas = jtaa.temporal_aa(
        _jax(cur), jnp.asarray(hist), _jax(vel), use_pallas=True,
        tonemap_out=True)
    for want in (nh_twin, nh_pallas):
        np.testing.assert_allclose(n(nh_p), n(want), atol=ATOL)
    for got, want in zip(rgb_p, (r0, g0, b0)):
        np.testing.assert_allclose(n(got), n(want), atol=ATOL)
    np.testing.assert_allclose(n(img_p), n(img_pallas), atol=ATOL)
    # without tonemap_out the same resolve, and no image
    rgb2, nh2 = ptaa.temporal_aa([t(x) for x in cur], t(hist),
                                 None if vel is None else
                                 [t(x) for x in vel])
    assert torch.equal(nh2, nh_p)


@pytest.mark.parametrize("h,w", [(72, 200), (52, 100)])
def test_resolve_matches_pallas_kernel(h, w):
    """The plain B5 on explicit operands with a non-zero blur, against
    the interpreted Pallas kernel (both outputs)."""
    ops_in = taa_operands("cpu", h, w, seed=1)
    out_p, img_p = taa_ops.taa_resolve(*ops_in, tonemap=True)
    out_j, img_j = taa_kernel.taa_resolve(
        *(jnp.asarray(n(x)) for x in ops_in), interpret=True, tonemap=True)
    np.testing.assert_allclose(n(out_p), n(out_j), atol=ATOL)
    np.testing.assert_allclose(n(img_p), n(img_j), atol=ATOL)
    assert torch.equal(taa_ops.taa_resolve(*ops_in), out_p)


def test_velocity_max_and_nan_guard():
    rng = np.random.RandomState(4)
    vx, vy = (rng.randn(9, 13).astype(np.float32) for _ in range(2))
    got = ptaa.velocity_max(t(vx), t(vy))
    want = jtaa.velocity_max(jnp.asarray(vx), jnp.asarray(vy))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w_))
    # a NaN history falls back to the filtered current colour
    cur, hist, _ = _inputs(16, 24, seed=5)
    hist[:3, 3:5, 4:9] = np.nan   # colour only: the guard takes over
    nh = n(taa_ops.taa_resolve(t(np.stack(cur)), t(hist),
                               torch.zeros(16, 24)))
    assert np.isfinite(nh[:3]).all()
    want = n(jtaa.temporal_aa(_jax(cur), jnp.asarray(hist), None,
                              use_pallas=False)[1])
    np.testing.assert_allclose(nh[:3], want[:3], atol=ATOL)


def test_ycocg_tonemap_matches_jax_and_roundtrips():
    rng = np.random.RandomState(1)
    rgb = [rng.rand(8, 8).astype(np.float32) * 5 for _ in range(3)]
    for fp, fj in ((ptaa.rgb_to_ycocg, jtaa.rgb_to_ycocg),
                   (ptaa.ycocg_to_rgb, jtaa.ycocg_to_rgb),
                   (ptaa.tm, jtaa.tm)):
        for got, want in zip(fp(*map(t, rgb)), fj(*map(jnp.asarray, rgb))):
            np.testing.assert_allclose(n(got), n(want), rtol=1e-6, atol=0)
    back = ptaa.itm(*ptaa.tm(*map(t, rgb)))
    for got, want in zip(back, rgb):
        np.testing.assert_allclose(n(got), want, rtol=1e-4, atol=1e-5)


def test_taa_static_scene_converges():
    h, w = 32, 48
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = torch.tensor((0.2 + 0.5 * xx + 0.25 * yy).astype(np.float32))
    cur = (img, img * 0.5, img * 0.2, torch.ones(h, w))
    vel = (torch.zeros(h, w), torch.zeros(h, w))
    history = torch.zeros(4, h, w)
    for _ in range(12):
        (r, _g, _b), history = ptaa.temporal_aa(cur, history, vel)
    np.testing.assert_allclose(n(r), n(img), atol=5e-2)
    assert float(history[3].min()) > 0.5


def test_taa_rejects_stale_history():
    h, w = 16, 16
    ones = torch.ones(h, w)
    cur = (ones, ones, ones, ones)
    vel = (torch.zeros(h, w), torch.zeros(h, w))
    history = torch.stack([torch.zeros(h, w)] * 3 + [ones])
    (r, _g, _b), _ = ptaa.temporal_aa(cur, history, vel)
    assert float(r.mean()) > 0.5


def test_windowed_reprojection_waits_for_the_mesh():
    """The windowed reprojection came with the mesh pass: a window around
    the mesh centre against the JAX Pallas path (more cases in
    tests/test_torch_mesh.py), and a window as large as the screen falls
    back to the full-screen reprojection, as in the JAX package."""
    cur, hist, vel = _inputs(16, 24, with_velocity=True)
    args = ([t(x) for x in cur], t(hist), [t(x) for x in vel])
    _rgb, nh_p = ptaa.temporal_aa(
        *args, reproj_center=(torch.tensor(9.5), torch.tensor(7.0)),
        reproj_window=8)
    (_r, _g, _b), nh_j = jtaa.temporal_aa(
        _jax(cur), jnp.asarray(hist), _jax(vel), use_pallas=True,
        reproj_center=(jnp.float32(9.5), jnp.float32(7.0)), reproj_window=8)
    np.testing.assert_allclose(n(nh_p), n(nh_j), atol=ATOL)
    _rgb, full = ptaa.temporal_aa(*args)
    _rgb, wide = ptaa.temporal_aa(
        *args, reproj_center=(torch.tensor(9.5), torch.tensor(7.0)),
        reproj_window=16)
    torch.testing.assert_close(wide, full, atol=0, rtol=0)
