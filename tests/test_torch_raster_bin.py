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
