"""Parity of the port's screen-tile composite with the JAX package: the
tile prep (homographies, per-tile lists) and the plain version of kernel
B2 against the Pallas kernel in interpret mode on the same operands;
plus the sweep -> composite contract: the prep takes the sweep's
Catmull-Smith flags as given.
Tolerance: mean < 3e-3, p99.5 < 3e-2 (tests/test_warp.py:172-173)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (image_stats, jax_lod_case, n, port_cull,
                          port_per_object, t)
from torch_parity import one_torch_thread  # noqa: F401 (module-wide)

from multivolumes_tpu.core import math3d as jm
from multivolumes_tpu.ops.pallas.composite_kernel import tile_composite_pallas
from multivolumes_tpu.render import tilecast as jtile
from multivolumes_tpu_torch.ops import composite as pcomp_ops
from multivolumes_tpu_torch.render import tilecast as ptile
from multivolumes_tpu_torch.render.raymarch import CubeMaps


@pytest.fixture(scope="module")
def prep_case():
    cfg, st, cam, po, lod_cull, basis, (maps, mips, order, swap) = \
        jax_lod_case()
    cull_c = lod_cull._replace(mip_level=mips)
    s2w = jm.inverse(cam.view_proj)
    jprep = jtile._tile_prep(maps, po, cull_c, cam.eye, s2w, None,
                             cfg.width, cfg.height, num_layers=8,
                             order=order, swap_sorted=swap)
    port_args = (CubeMaps(t(maps.color), None), port_per_object(po),
                 port_cull(cull_c), t(cam.eye), t(s2w), cfg.width,
                 cfg.height)
    port_kw = dict(num_layers=8, order=torch.from_numpy(np.asarray(order)),
                   swap_sorted=torch.from_numpy(np.asarray(swap)))

    def jax_prep(swap_sorted):
        return jtile._tile_prep(maps, po, cull_c, cam.eye, s2w, None,
                                cfg.width, cfg.height, num_layers=8,
                                order=order, swap_sorted=swap_sorted)
    return cfg, jprep, port_args, port_kw, jax_prep


def test_tile_prep_matches_jax(prep_case):
    cfg, jprep, port_args, port_kw, _jax_prep = prep_case
    (jcolor, _jdep, jscene, jtl, jcnt, jvol, jface, js, jth, jtw, jtx,
     jk) = jprep
    (color, depth_sel, scene, tlist, counts, vol_flt, face_flt, s, th, tw,
     tiles_x, k_layers) = ptile._tile_prep(*port_args, **port_kw)
    assert depth_sel is None  # no scene depth
    assert (s, th, tw, tiles_x, k_layers) == (js, jth, jtw, jtx, jk)
    np.testing.assert_array_equal(tlist.numpy(), np.asarray(jtl))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
    assert int(counts.max()) > 1  # tiles that list several volumes
    np.testing.assert_array_equal(n(color), n(jcolor)[..., :s])
    np.testing.assert_array_equal(n(scene), n(jscene))
    np.testing.assert_allclose(n(vol_flt), n(jvol), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(face_flt), n(jface), rtol=1e-4, atol=1e-4)


def _pallas_and_plain(cfg, jprep):
    (jcolor, _jdep, jscene, jtl, jcnt, jvol, jface, s, th, tw, tiles_x,
     k) = jprep
    want = tile_composite_pallas(jcolor, jscene, jtl, jcnt, jvol, jface,
                                 s=s, th=th, tw=tw, tiles_x=tiles_x,
                                 k_layers=k, width=cfg.width,
                                 height=cfg.height, interpret=True)
    got = pcomp_ops.tile_composite(
        t(jcolor)[..., :s], t(jscene), torch.from_numpy(np.asarray(jtl)),
        torch.from_numpy(np.asarray(jcnt)), t(jvol), t(jface), th, tw,
        tiles_x, k, cfg.width, cfg.height)
    return got, want


def test_b2_plain_matches_pallas_interpret(prep_case):
    cfg, jprep, _a, _k, _j = prep_case
    got, want = _pallas_and_plain(cfg, jprep)
    h, w = cfg.height, cfg.width
    assert float(n(want)[3, :h, :w].max()) > 0.2  # volumes on screen
    mean, p995, mx = image_stats(got[:, :h, :w], jnp.asarray(want)[:, :h, :w],
                                 99.5)
    print(f"B2 plain vs Pallas: mean {mean:.2e} p99.5 {p995:.2e} "
          f"max {mx:.2e}")
    assert mean < 3e-3 and p995 < 3e-2, (mean, p995, mx)


def test_composite_requires_order_with_swap_flags(prep_case):
    _cfg, _jprep, port_args, port_kw, _jax_prep = prep_case
    with pytest.raises(ValueError, match="order"):
        ptile._tile_prep(*port_args, num_layers=8,
                         swap_sorted=port_kw["swap_sorted"])


def test_tile_prep_takes_the_sweep_flags_verbatim(prep_case):
    """The prep packs its face rows by the flags it is given, as the JAX
    prep does, with no pick of its own beside them: with some of the
    sweep's flags flipped, its operands are the JAX prep's for the same
    flipped flags, and a flipped face's u and v rows trade places."""
    _cfg, _jprep, port_args, port_kw, jax_prep = prep_case
    swap = port_kw["swap_sorted"]
    flip = torch.zeros_like(swap)
    flip[::2, 0] = flip[1::3, 3] = flip[:, 5] = True
    flipped = swap ^ flip
    (jcolor, _jdep, _jscene, _jtl, _jcnt, jvol, jface, *_rest) = jax_prep(
        jnp.asarray(flipped.numpy()))
    base = ptile._tile_prep(*port_args, **port_kw)
    color, depth_sel, *_mid, vol_flt, face_flt = ptile._tile_prep(
        *port_args, num_layers=8, order=port_kw["order"],
        swap_sorted=flipped)[:7]
    assert depth_sel is None
    np.testing.assert_array_equal(n(color), n(jcolor)[..., :color.shape[-1]])
    np.testing.assert_allclose(n(vol_flt), n(jvol), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n(face_flt), n(jface), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(face_flt[flip][:, :3], base[6][flip][:, 3:6],
                               rtol=0, atol=0)
    torch.testing.assert_close(face_flt[flip][:, 3:6], base[6][flip][:, :3],
                               rtol=0, atol=0)
    torch.testing.assert_close(face_flt[~flip], base[6][~flip], rtol=0,
                               atol=0)


@pytest.mark.parametrize("where", ["none", "top-left", "bottom-right",
                                   "right-column", "bottom-row", "all"])
def test_mesh_tile_votes_match_mesh_tiles(where):
    """The composite kernel's once-per-tile mesh vote, read as its 16-byte
    loads walk a tile, flags the tiles `mesh_tiles` flags; mesh pixels on
    the first or last row or column of a tile, background 1 and pad 0."""
    th, tw, tiles_x, tile_rows = 16, 32, 3, 2
    scene = torch.ones((tile_rows * th, tiles_x * tw))
    scene[:, -5:] = 0.0                      # the pad
    if where == "top-left":
        scene[th, tw] = 0.5                  # tile (1, 1), first pixel
    elif where == "bottom-right":
        scene[th - 1, 2 * tw - 1] = 0.25     # tile (0, 1), last pixel
    elif where == "right-column":
        scene[5, tw - 1] = 0.9               # tile (0, 0), last column
    elif where == "bottom-row":
        scene[2 * th - 1, 2 * tw + 3] = 1e-3  # tile (1, 2), last row
    elif where == "all":
        scene[:] = 0.75
    votes = pcomp_ops.mesh_tile_votes(scene, th, tw, tiles_x)
    want = pcomp_ops.mesh_tiles(scene, th, tw).flatten()
    assert torch.equal(votes, want)
    assert int(want.sum()) == {"none": 0, "all": 6}.get(where, 1)
