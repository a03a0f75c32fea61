"""The mesh layer's z-buffer raster (B9): kernel wrapper.

Hand kernel: `csrc/raster.cu`, which replaces no TPU kernel (the JAX
package leaves its scatter raster to XLA). Plain version:
`render/mesh.py:rasterize_plain`. The dispatch rule of `ops` is applied
by `render/mesh.py:rasterize`, which hands this wrapper the segment table
of its levers (`render/mesh.py:emit_segments`) or calls the plain
version; this wrapper only launches.

One call is two calls of the C library with PyTorch's stable argsort of
the by-edge key between them (where the levers rank the triangles):
`mv_raster_setup` (the per-triangle table, the key, the CTAs' bboxes, the
z-buffer filled) and `mv_raster_draw` (every emit segment in one launch,
the id pass where ids pass 2^17, and the dense pass fused with the
decode). It returns (depth (h, W) f32, tri_id (h, W) int64, -1 where
empty), equal to the plain version's bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multivolumes_tpu_torch import ops

TBITS = 17            # triangle-id bits of the packed z-buffer word
MAX_SEGMENTS = 32     # emit segments one launch takes (`csrc/raster.cu`)
_THREADS = 256        # the setup kernel's CTA: one bbox partial each


@functools.lru_cache(maxsize=64)
def _host_segments(segments: tuple):
    """The segment table as the C side reads it: (n, 5) int64 in host
    memory, (lo, count, kk, by_rank, start) a row (cached with the
    levers, so no call builds it again)."""
    flat = [int(v) for seg in segments for v in seg]
    return (ctypes.c_longlong * max(len(flat), 1))(*flat)


def raster(verts_clip, indices, segments: tuple, *, ordered: bool,
           width: int, height: int, want_ids: bool, cull: int,
           dense_top: int, dense_window: int | None, band: tuple | None):
    """B9 -> (depth, tri_id); CUDA tensors only. verts_clip (V, 4) f32
    clip positions, indices (T, 3) int64; `segments` and `ordered` from
    `emit_segments` on these levers; the others as `rasterize`'s."""
    from multivolumes_tpu_torch.ops import build

    verts_clip = verts_clip.contiguous()
    ops.check_cuda(verts_clip, "verts_clip", torch.float32)
    ops.check_cuda(indices, "indices", torch.int64)
    T = indices.shape[0]
    if (verts_clip.dim() != 2 or verts_clip.shape[1] != 4 or T < 1
            or indices.shape[1:] != (3,) or T >= 1 << 31
            or verts_clip.data_ptr() % 16):
        raise ValueError(f"raster: clip {tuple(verts_clip.shape)} (16-byte "
                         f"aligned rows), indices {tuple(indices.shape)}")
    if len(segments) > MAX_SEGMENTS:
        raise ValueError(f"raster: {len(segments)} emit segments, at most "
                         f"{MAX_SEGMENTS}")
    pack_ids = want_ids and T < (1 << TBITS)
    mode = 0 if pack_ids else (2 if want_ids else 1)
    out_h, row0 = height, 0
    if band is not None:
        row_idx, n_bands = band
        if not pack_ids:
            raise ValueError("the banded raster needs the packed-id path "
                             f"(want_ids and T < 2^{TBITS}, T = {T})")
        if height % n_bands:
            raise ValueError(f"{height} rows do not split into {n_bands} "
                             "bands")
        out_h = height // n_bands
        row0 = row_idx * out_h
    dense_n = min(dense_top, T) if dense_top and ordered and mode != 2 \
        else 0
    win = int(dense_window) if (
        dense_n and band is None and dense_window is not None
        and 0 < dense_window <= min(width, height)) else 0

    dev = verts_clip.device
    f32 = torch.float32
    n_px = out_h * width
    n_part = -(-T // _THREADS)
    table = torch.empty((T, 16), dtype=f32, device=dev)
    key = torch.empty((T,), dtype=f32, device=dev) if ordered else None
    part = torch.empty((n_part, 4), dtype=f32, device=dev)
    buf = torch.empty((n_px,), dtype=torch.int32, device=dev)
    ids = (torch.empty((n_px,), dtype=torch.int32, device=dev)
           if mode == 2 else None)
    corner = torch.empty((2,), dtype=torch.int32, device=dev)
    depth = torch.empty((out_h, width), dtype=f32, device=dev)
    tri_id = torch.empty((out_h, width), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.launch("mv_raster_setup", verts_clip.data_ptr(),
                 indices.data_ptr(), table.data_ptr(), ptr(key),
                 part.data_ptr(), buf.data_ptr(), ptr(ids), T, n_px, cull,
                 width, height, device=dev)
    # the by-edge order: the plain version's stable argsort of -edge
    order = torch.argsort(key, stable=True) if ordered else None
    seg = _host_segments(segments)
    build.launch("mv_raster_draw", table.data_ptr(), ptr(order),
                 buf.data_ptr(), ptr(ids), part.data_ptr(), n_part,
                 corner.data_ptr(), ctypes.addressof(seg), len(segments),
                 depth.data_ptr(), tri_id.data_ptr(), dense_n, width, height,
                 row0, out_h, win, mode, device=dev)
    ops.count_launch("raster")
    return depth, tri_id
