"""The binned-raster eval kernel (B6) of the port against the JAX
package's tool: the plain version against a numpy restatement of
`tools/raster_bin_microbench.py:138-164` and against the tool's own
Pallas kernel in interpret mode (`torch_parity.pallas_raster_bin_eval`),
and the port's microbench entry point on the CPU.

Tolerance: the words are integers, so every comparison is exact. The
Pallas output block of a tile that no chunk maps to is never written, so
that comparison covers the visited tiles; the port's output holds
0x7FFFFFFF there.

The operands are 8 chunks on 4 tiles, one of them unvisited and two
shared by several chunks, with small random triangles placed inside each
chunk's tile, so that candidates cover pixels, and depths on both sides
of 0.5 (the packed word's shift wraps into the sign bit from there)."""

import numpy as np
import pytest
import torch
from torch_parity import pallas_raster_bin_eval

from multivolumes_tpu_torch.ops import raster_bin
from multivolumes_tpu_torch.tools import raster_bin_microbench

N_TILES = 4
TILE_OF_CHUNK = np.array([0, 0, 0, 1, 3, 3, 3, 3], np.int32)
EMPTY = 0x7FFFFFFF


def _operands(seed=0):
    rng = np.random.RandomState(seed)
    n_c = TILE_OF_CHUNK.shape[0]
    x0 = (rng.randint(0, 3, n_c) * 128).astype(np.float32)
    y0 = (rng.randint(0, 48, n_c) * 8).astype(np.float32)
    # a chunk's tile origin belongs to its tile
    for i in range(1, n_c):
        if TILE_OF_CHUNK[i] == TILE_OF_CHUNK[i - 1]:
            x0[i], y0[i] = x0[i - 1], y0[i - 1]
    m = n_c * 128
    # triangles of a few pixels around a centre inside the chunk's tile
    cx = np.repeat(x0, 128) + rng.rand(m) * 128.0
    cy = np.repeat(y0, 128) + rng.rand(m) * 8.0
    v = np.stack([cx, cy], -1)[:, None, :] + rng.randn(m, 3, 2) * 5.0
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    det = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    det = np.where(np.abs(det) < 1e-3, 1e-3, det)
    # barycentrics of v1 and v2 as affine functions of the pixel centre
    c1x, c1y = e2[:, 1] / det, -e2[:, 0] / det
    c2x, c2y = -e1[:, 1] / det, e1[:, 0] / det
    c1k = -(c1x * v[:, 0, 0] + c1y * v[:, 0, 1])
    c2k = -(c2x * v[:, 0, 0] + c2y * v[:, 0, 1])
    zx, zy = rng.randn(m) * 1e-3, rng.randn(m) * 1e-3
    zk = rng.rand(m) - (zx * cx + zy * cy)      # depth in [0, 1) at centre
    coef = np.zeros((16, m), np.float32)
    coef[:9] = np.stack([c1x, c1y, c1k, c2x, c2y, c2k, zx, zy, zk])
    coef[9] = rng.randint(0, 1 << 17, m)
    coef[10:] = rng.randn(6, m)                 # rows the kernel ignores
    return TILE_OF_CHUNK, x0, y0, coef


def _numpy_eval(tile_of_chunk, x0, y0, coef, n_tiles):
    """`tools/raster_bin_microbench.py:138-164` chunk by chunk in numpy
    float32, accumulating revisited tiles with a minimum."""
    out = np.full((n_tiles, 8, 128), EMPTY, np.int32)
    one, half = np.float32(1.0), np.float32(0.5)
    for i, tile in enumerate(tile_of_chunk):
        xg = (np.arange(128, dtype=np.float32) + x0[i] + half)[None, :, None]
        yg = (np.arange(8, dtype=np.float32) + y0[i] + half)[:, None, None]
        c = coef[:, i * 128:(i + 1) * 128]
        c1 = xg * c[0] + yg * c[1] + c[2]
        c2 = xg * c[3] + yg * c[4] + c[5]
        z = xg * c[6] + yg * c[7] + c[8]
        b0 = one - c1 - c2
        ok = (np.minimum(np.minimum(c1, c2), b0) >= 0) & (z >= 0) & (z <= 1)
        zq = np.clip(z * np.float32(32767.0), 0, 32767).astype(np.int32)
        packed = np.where(ok, (zq << 17) | c[9].astype(np.int32),
                          np.int32(EMPTY))
        out[tile] = np.minimum(out[tile], packed.min(-1))
    return out.reshape(n_tiles * 8, 128)


def _plain(ops_np, **kw):
    tile, x0, y0, coef = (torch.from_numpy(a) for a in ops_np)
    return raster_bin.raster_bin_eval(tile, x0, y0, coef, N_TILES,
                                      **kw).numpy()


def test_plain_matches_the_numpy_restatement():
    ops_np = _operands()
    want = _numpy_eval(*ops_np, N_TILES)
    got = _plain(ops_np)
    assert got.dtype == np.int32 and got.shape == (N_TILES * 8, 128)
    np.testing.assert_array_equal(got, want)
    covered = got != EMPTY
    assert covered.sum() > 500                    # candidates cover pixels
    assert (got[covered] < 0).any()               # z >= 0.5: the sign bit
    assert (got[covered] >= 0).any()
    assert (got[2 * 8:3 * 8] == EMPTY).all()      # the unvisited tile
    # a batch that does not divide the chunks gives the same words
    tile, x0, y0, coef = (torch.from_numpy(a) for a in ops_np)
    np.testing.assert_array_equal(
        raster_bin.raster_bin_eval_plain(tile, x0, y0, coef, N_TILES,
                                         chunk_batch=3).numpy(), want)


def test_plain_matches_the_pallas_kernel_interpreted():
    ops_np = _operands(seed=1)
    want = pallas_raster_bin_eval(*ops_np, N_TILES)
    got = _plain(ops_np)
    visited = np.repeat(np.isin(np.arange(N_TILES), TILE_OF_CHUNK), 8)
    assert visited.sum() == 3 * 8
    np.testing.assert_array_equal(got[visited], want[visited])
    assert ((got[visited] != EMPTY).sum()) > 500
    assert (got[visited] < 0).any()


def test_kernel_quantise_identity():
    """B6 packs the depth as `bits(__fadd_rz(z * 32767, 2^23)) << 17`
    (csrc/raster_bin.cu) where the plain version takes
    `trunc(clip(z * 32767, 0, 32767)) << 17`. For every f32 z in [0, 1]
    (the only depths a covering pair offers) within two ulps of each
    multiple of 1/32767, and a seeded sample of 10^6 more, the words agree
    mod 2^32. The sum rounded toward zero is exact in f64 here (zs has
    24 significant bits and lies below 2^15), so floor() gives the RZ
    result."""
    f32 = np.float32
    grid = (np.arange(32768, dtype=np.float64) / 32767).astype(f32)
    parts = [grid, np.array([-0.0, 0.0, 1.0], f32),
             np.random.default_rng(0).random(1_000_000, dtype=np.float32)]
    for toward in (f32(2), f32(-1)):          # two ulps up and down
        z = grid
        for _ in range(2):
            z = np.nextafter(z, toward)
            parts.append(z)
    z = np.concatenate(parts)
    z = z[(z >= 0) & (z <= 1)]
    assert z.size > 1_150_000
    zs = z * f32(32767.0)                                  # f32, rounded
    assert ((zs >= 0) & (zs <= 32767)).all()               # clamps: identity
    rz = np.floor(zs.astype(np.float64) + 2.0 ** 23).astype(f32)
    got = (rz.view(np.uint32).astype(np.uint64) << 17) & 0xFFFFFFFF
    want = (np.trunc(np.clip(zs, 0, 32767)).astype(np.uint64) << 17) \
        & 0xFFFFFFFF
    np.testing.assert_array_equal(got, want)
    assert (want >= 1 << 31).any()                         # the sign bit


def test_kernel_cover_test_identity():
    """B6 tests c0 = (1 - c1) - c2 >= 0 as (1 - c1) >= c2, under c1 >= 0
    and c2 >= 0 (csrc/raster_bin.cu): the same verdict in f32 on seeded
    values around the edge, ties, subnormals, zeros of both signs,
    infinities and NaN."""
    f32 = np.float32
    rng = np.random.default_rng(1)
    c1 = rng.random(200_000, dtype=np.float32) * f32(1.5)
    edge = f32(1) - c1                       # c2 within 3 ulps of the edge
    c2 = edge + rng.integers(-3, 4, c1.size).astype(f32) * np.spacing(edge)
    special = np.array([0.0, -0.0, 1e-45, 1e-38, 1.0, 1.0 - 2.0 ** -24,
                        3e38, np.inf, -np.inf, np.nan], f32)
    a, b = np.meshgrid(special, special)
    c1 = np.concatenate([c1, a.ravel(), rng.standard_normal(10_000, f32)])
    c2 = np.concatenate([c2, b.ravel(), rng.standard_normal(10_000, f32)])
    with np.errstate(invalid="ignore", over="ignore"):
        t = f32(1) - c1
        c0 = t - c2
        plain = np.minimum(np.minimum(c1, c2), c0) >= 0
        kernel = (c1 >= 0) & (c2 >= 0) & (t >= c2)
    np.testing.assert_array_equal(kernel, plain)
    assert plain.sum() > 1000 and (~plain).sum() > 1000


def test_shapes_are_checked():
    tile, x0, y0, coef = (torch.from_numpy(a) for a in _operands())
    for bad in ((tile, x0[:-1], y0, coef), (tile, x0, y0, coef[:, :-1]),
                (tile, x0, y0, coef[:9])):
        with pytest.raises(ValueError, match="bad shapes"):
            raster_bin.raster_bin_eval(*bad, N_TILES)


def test_microbench_runs_on_the_cpu(capsys):
    times = raster_bin_microbench.main(
        ["--entries", "2000", "--chunks", "8", "--tiles", "3", "--samples",
         "5000", "--iters", "2"], device="cpu")
    assert sorted(times) == ["argsort", "eval", "gather", "scatter_min"]
    assert all(v > 0.0 for v in times.values())
    text = capsys.readouterr().out
    assert "binned total (sort+gather+eval)" in text
    assert ("WINS" in text) != ("LOSES" in text)
