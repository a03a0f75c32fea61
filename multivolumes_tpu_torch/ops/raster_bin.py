"""The binned-raster eval kernel (B6): wrapper and plain version.

Hand kernel: `csrc/raster_bin.cu`. It replaces the Pallas kernel of
`tools/raster_bin_microbench.py` (the `pallas_call` at line 172, kernel
body at lines 138-164), the third primitive of a per-tile binning
rasterizer for the mesh base pass. It is a measurement tool's kernel
(`multivolumes_tpu_torch/tools/raster_bin_microbench.py`); the engine's
raster stays the tiered scatter-min of `render/mesh.py`.

What it computes. Triangle candidates arrive binned into chunks of 128,
each chunk bound to one output tile of 8 x 128 pixels. For chunk i the
columns `coef[:, i * 128:(i + 1) * 128]` hold, per candidate, three
affine functions of the pixel centre in rows 0-8 (the barycentrics c1,
c2 and the depth z, each as x-, y- and constant coefficient) and the
triangle id in row 9. The chunk's pixels are at (x0[i] + x + 0.5,
y0[i] + y + 0.5) for x < 128, y < 8. A candidate covers a pixel when
min(c1, c2, 1 - c1 - c2) >= 0 and 0 <= z <= 1; it then offers the word
(clip(z * 32767, 0, 32767) << 17) | tid, else 0x7FFFFFFF. The signed
32-bit minimum is taken over the chunk's candidates and over all chunks
that map to the same tile `tile_of_chunk[i]`. Output (n_tiles * 8, 128)
int32; a tile no chunk maps to stays 0x7FFFFFFF.

The 15-bit depth shifted by 17 reaches the sign bit for z >= 0.5: the
Pallas kernel's int32 shift wraps, so those words are negative and win
the signed minimum over nearer candidates. Both versions here copy that
(the engine's rasters of both packages pack into unsigned or 64-bit
words and do not have it).
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch import ops

EMPTY = 0x7FFFFFFF
CAND = 128            # candidates per chunk
TILE_H, TILE_W = 8, 128


def raster_bin_eval_plain(tile_of_chunk, x0, y0, coef, n_tiles: int,
                          chunk_batch: int = 16):
    """Plain version of B6 (see the module docstring): the (chunks, 8,
    128, 128) broadcast in batches of the chunk axis, `amin` over the
    candidates, then a scatter-min over the tiles. Every affine is
    evaluated left to right, xg * cx + yg * cy + ck, each operation
    rounded on its own."""
    n_c = tile_of_chunk.shape[0]
    dev = coef.device
    out = torch.full((n_tiles, TILE_H, TILE_W), EMPTY, dtype=torch.int32,
                     device=dev)
    px = torch.arange(TILE_W, dtype=torch.float32, device=dev)
    py = torch.arange(TILE_H, dtype=torch.float32, device=dev)
    coef = coef.float()
    for c0 in range(0, n_c, chunk_batch):
        c1 = min(c0 + chunk_batch, n_c)
        # (10, B, 1, 1, 128): per chunk, the candidates on the last axis
        c = coef[:10, c0 * CAND:c1 * CAND].reshape(10, c1 - c0, 1, 1, CAND)
        xg = (px[None, :] + x0[c0:c1, None].float() + 0.5)[:, None, :, None]
        yg = (py[None, :] + y0[c0:c1, None].float() + 0.5)[:, :, None, None]
        b1 = xg * c[0] + yg * c[1] + c[2]
        b2 = xg * c[3] + yg * c[4] + c[5]
        z = xg * c[6] + yg * c[7] + c[8]
        b0 = 1.0 - b1 - b2
        ok = ((torch.minimum(torch.minimum(b1, b2), b0) >= 0.0)
              & (z >= 0.0) & (z <= 1.0))
        zq = torch.clamp(z * 32767.0, 0.0, 32767.0).long()
        # the int32 shift wraps into the sign bit (see the module docstring)
        word = ((zq << 17) | c[9].long()).to(torch.int32)
        m = torch.where(ok, word, EMPTY).amin(dim=-1)          # (B, 8, 128)
        idx = tile_of_chunk[c0:c1].long()[:, None, None].expand_as(m)
        out.scatter_reduce_(0, idx, m, "amin")
    return out.reshape(n_tiles * TILE_H, TILE_W)


def raster_bin_eval(tile_of_chunk, x0, y0, coef, n_tiles: int,
                    impl: str | None = None):
    """B6 wrapper. tile_of_chunk (chunks,) int32 in [0, n_tiles); x0, y0
    (chunks,) f32 tile origins in pixels; coef (16, chunks * 128) f32
    (rows 0-9 are read) -> (n_tiles * 8, 128) int32. On the card a chunk
    whose tile is out of range is skipped, so that it cannot write
    outside the output."""
    n_c = tile_of_chunk.shape[0]
    if coef.shape[0] < 10 or coef.shape[1] != n_c * CAND \
            or x0.shape != (n_c,) or y0.shape != (n_c,):
        raise ValueError(f"bad shapes {tuple(coef.shape)} {tuple(x0.shape)} "
                         f"{tuple(y0.shape)} for {n_c} chunks")
    if not ops.use_kernel(impl, coef):
        return raster_bin_eval_plain(tile_of_chunk, x0, y0, coef, n_tiles)
    from multivolumes_tpu_torch.ops import build

    tile_of_chunk = tile_of_chunk.int().contiguous()
    x0, y0, coef = (t.float().contiguous() for t in (x0, y0, coef))
    for name, t in (("tile_of_chunk", tile_of_chunk), ("x0", x0), ("y0", y0),
                    ("coef", coef)):
        ops.check_cuda(t, name)
    out = torch.full((n_tiles * TILE_H, TILE_W), EMPTY, dtype=torch.int32,
                     device=coef.device)
    build.launch("mv_raster_bin_eval", tile_of_chunk.data_ptr(),
                 x0.data_ptr(), y0.data_ptr(), coef.data_ptr(),
                 out.data_ptr(), n_c, n_tiles, coef.shape[1],
                 device=coef.device)
    ops.count_launch("raster_bin_eval")
    return out
