"""The LOD sweep's per-frame glue around B7 / B1: B12, the partition, and
B13, each bucket's store (kernel wrappers).

Hand kernels: `csrc/lod_partition.cu`, which replace no TPU kernel (the
JAX package leaves this glue to XLA, which fuses it). Plain versions:
`render/sweep.py:partition_plain` and `bucket_store_plain`, which
`ray_march_view_sweep_lod` runs for CPU tensors and `impl="plain"`.

A LOD sweep on the card is one B12 launch (`lod_partition`: the eye in
each volume's frame and its face frames, the stable LOD rank, the
effective mips, B1's per-volume operands in rank order and, with a swap
basis, the Catmull-Smith flags of the ranked rows), then for each bucket
B7, B1 and one B13 launch (`lod_store`: B1's f32 output scaled, masked,
rounded to the sweep dtype, pre-swapped and stored into the cube maps).
The gather composite's packed maps keep the plain epilogue
(`bucket_store_plain(pack=True)`): the packing is f16 pairs of the f32
march, not the sweep dtype.
"""

from __future__ import annotations

import ctypes

import torch

from multivolumes_tpu_torch import ops

MAX_BUCKETS = 8      # csrc/lod_partition.cu: kMaxBuckets
MAX_VOLUMES = 8192   # csrc/lod_partition.cu: kMaxN


def _operand(t: torch.Tensor, name: str, dtype, shape) -> torch.Tensor:
    t = t.contiguous()
    ops.check_cuda(t, name, dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def _matrices(m: torch.Tensor, name: str, n: int) -> torch.Tensor:
    if not m.is_cuda or m.dtype != torch.float32 or m.shape != (n, 4, 4):
        raise ValueError(f"{name}: expected ({n}, 4, 4) f32 on CUDA")
    return m


def partition(cull, per_object, eye, vol_tex_ids, cube_map_size: int,
              buckets, swap_basis=None, impl: str | None = None):
    """B12 wrapper -> `render.sweep.Partition`.

    cull: the LOD cull (N rows); per_object: the frame's PerObject; eye
    (3,); vol_tex_ids (N,) int64; buckets: `render.sweep.lod_buckets`'s
    host layout; swap_basis: (3, 3) `warp.screen_basis` for the tile
    composite's flags, or None."""
    from multivolumes_tpu_torch.render.sweep import (Partition,
                                                     partition_plain)

    if not ops.use_kernel(impl, eye):
        return partition_plain(cull, per_object, eye, vol_tex_ids,
                               cube_map_size, buckets, swap_basis)
    from multivolumes_tpu_torch.ops import build

    n = vol_tex_ids.shape[0]
    if not 1 <= n <= MAX_VOLUMES or not 1 <= len(buckets) <= MAX_BUCKETS:
        raise ValueError(f"lod_partition takes 1..{MAX_VOLUMES} volumes in "
                         f"1..{MAX_BUCKETS} buckets, got {n} in "
                         f"{len(buckets)}")
    if buckets[0][0] != 0 or sum(b[1] for b in buckets) != n:
        raise ValueError(f"buckets {buckets} do not cover {n} rows")
    dev = eye.device
    visible = _operand(cull.visible, "visible", torch.bool, (n,))
    mip_level = _operand(cull.mip_level, "mip_level", torch.int32, (n,))
    edge = _operand(cull.max_edge_px, "max_edge_px", torch.float32, (n,))
    use_cube = _operand(cull.use_cube_map, "use_cube_map", torch.bool, (n,))
    face_mask = _operand(cull.face_mask, "face_mask", torch.bool, (n, 6))
    smp_count = _operand(cull.smp_count, "smp_count", torch.int32, (n,))
    tex_ids = _operand(vol_tex_ids, "vol_tex_ids", torch.int64, (n,))
    eye = _operand(eye, "eye", torch.float32, (3,))
    wi = _matrices(per_object.world_i, "world_i", n)
    wvp = _matrices(per_object.world_view_proj, "world_view_proj", n)
    basis_ptr = None
    if swap_basis is not None:
        swap_basis = _operand(swap_basis, "swap_basis", torch.float32, (3, 3))
        basis_ptr = swap_basis.data_ptr()
    table = (ctypes.c_int * (2 * MAX_BUCKETS))(
        *[b[0] for b in buckets], *[0] * (MAX_BUCKETS - len(buckets)),
        *[b[3] for b in buckets], *[0] * (MAX_BUCKETS - len(buckets)))
    s = cube_map_size
    max_mip = max((s // 8).bit_length() - 1, 0)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = Partition(
        order=empty((n,), torch.int64), mips=empty((n,), torch.int32),
        n_eff=empty((n,), torch.float32),
        eye_local=empty((n, 3), torch.float32),
        eye_faces=empty((n, 6, 3), torch.float32),
        ids=empty((n,), torch.int32), tex=empty((n,), torch.int32),
        faces=empty((n, 6, 3), torch.float32),
        smp=empty((n,), torch.int32), run=empty((n, 6), torch.bool),
        swap=None if swap_basis is None else empty((n, 6), torch.bool))
    build.launch(
        "mv_lod_partition", visible.data_ptr(), mip_level.data_ptr(),
        edge.data_ptr(), use_cube.data_ptr(), face_mask.data_ptr(),
        smp_count.data_ptr(), tex_ids.data_ptr(), wi.data_ptr(),
        wvp.data_ptr(), eye.data_ptr(), basis_ptr, table,
        *(x.data_ptr() for x in out[:10]),
        None if out.swap is None else out.swap.data_ptr(),
        n, len(buckets), s, max_mip, *wi.stride(), *wvp.stride(),
        device=dev)
    ops.count_launch("lod_partition")
    return out


def bucket_store(scatter, run, swap, color, rows, impl: str | None = None):
    """B13 wrapper: one bucket's B1 output `scatter` (count, 6, 4, S_b,
    S_b) f32 -> color[rows, :, :, :S_b, :S_b] in color's dtype (bf16 or
    f32), in place: RGB scaled by 1 / (2 pi), every channel times the
    face's `run` (count, 6) bool, rounded, transposed where `swap`
    (count, 6) bool is set (None: no flags). rows: a slice of sorted rows,
    or a (count,) int64 row index tensor."""
    if not ops.use_kernel(impl, scatter):
        from multivolumes_tpu_torch.render.sweep import bucket_store_plain

        bucket_store_plain(scatter, run, swap, color, rows)
        return
    from multivolumes_tpu_torch.ops import build

    count, sb = scatter.shape[0], scatter.shape[-1]
    s = color.shape[-1]
    scatter = _operand(scatter, "scatter", torch.float32,
                       (count, 6, 4, sb, sb))
    run = _operand(run, "run", torch.bool, (count, 6))
    ops.check_cuda(color, "color", (torch.bfloat16, torch.float32))
    if color.shape[1:] != (6, 4, s, s) or sb > s:
        raise ValueError(f"color shape {tuple(color.shape)} for S_b {sb}")
    swap_ptr = row_ptr = None
    row0 = 0
    if swap is not None:
        swap = _operand(swap, "swap", torch.bool, (count, 6))
        swap_ptr = swap.data_ptr()
    if isinstance(rows, slice):
        row0 = rows.start
        if rows.stop - rows.start != count or rows.step not in (None, 1) \
                or rows.stop > color.shape[0]:
            raise ValueError(f"rows {rows} for {count} volumes")
    else:
        rows = _operand(rows, "rows", torch.int64, (count,))
        row_ptr = rows.data_ptr()
    build.launch(
        "mv_lod_store", scatter.data_ptr(), run.data_ptr(), swap_ptr,
        row_ptr, color.data_ptr(), count, sb, s, row0,
        int(color.dtype == torch.bfloat16), device=color.device)
    ops.count_launch("lod_store")
