"""LOD-bucket prologue of the plane sweep (B7): kernel wrapper.

Hand kernel: `csrc/sweep_prep.cu`, which replaces no TPU kernel (the JAX
package leaves this per-bucket geometry to XLA, which fuses it). Plain
version: `render/sweep.py:bucket_prologue_plain`, the composition of
`bucket_occlusion` (the depth bound), `unproject_z` and the Catmull-Smith
swap (the cube depth) and `bucket_ray_params` (B1's ray operands).

For one bucket of `ids` at `size_b` x `size_b` rays a face it returns
B1's (s_in, s_end, ray_len, active) at (count, 6, size_b, size_b) and,
with a depth map, writes the bucket's cube depth into
`cube_depth[rows, :, :size_b, :size_b]`.
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch import ops
from multivolumes_tpu_torch.config import SharedConsts


def depth_blocks(shape, size_b: int) -> int:
    """Side of the block of the full depth map that one depth tap of a
    bucket at `size_b` reads: one 2x2 max-pool below 64, two at 64 and
    above, each passing an odd-sized map through (`_pool2_max`)."""
    h, w = shape
    block = 1
    for _ in range(2 if size_b >= 64 else 1):
        if (h // block) % 2 or (w // block) % 2:
            break
        block *= 2
    return block


def sweep_prologue(per_object, eye_local, eye_faces, ids, n_eff_v,
                   size_b: int, depth_map=None, swap=None, cube_depth=None,
                   rows=None, impl: str | None = None):
    """B7 wrapper -> SweepParams (count, 6, size_b, size_b).

    per_object: the frame's PerObject (all N rows); eye_local (N, 3) and
    eye_faces (N, 6, 3) the eye in each volume's frame and face frames;
    ids (count,) the bucket's volumes, n_eff_v (count,) their n_eff. With
    depth_map (H, W) (the scene clip depth), the rays stop at the scene
    and the cube depth goes to `cube_depth` (N, 6, S, S) at `rows` (a
    slice of sorted rows, or a row index tensor): unprojected and
    transposed by `swap` (count, 6) where given (the tile composite), the
    clip depth as it is where not."""
    if not ops.use_kernel(impl, eye_faces):
        from multivolumes_tpu_torch.render.sweep import bucket_prologue_plain

        return bucket_prologue_plain(per_object, eye_local, eye_faces, ids,
                                     size_b, n_eff_v, depth_map=depth_map,
                                     swap=swap, cube_depth=cube_depth,
                                     rows=rows)
    from multivolumes_tpu_torch.ops import build
    from multivolumes_tpu_torch.render.sweep import SweepParams

    dev = eye_faces.device
    count = ids.shape[0]
    ids = ids.long().contiguous()
    n_eff = n_eff_v.float().contiguous()
    eye_faces = eye_faces.float().contiguous()
    wvp, wvp_i = per_object.world_view_proj, per_object.world_view_proj_i
    for x, name in ((ids, "ids"), (n_eff, "n_eff"), (eye_faces, "eye_faces")):
        ops.check_cuda(x, name)
    for m, name in ((wvp, "world_view_proj"), (wvp_i, "world_view_proj_i")):
        if not m.is_cuda or m.dtype != torch.float32 or m.shape[1:] != (4, 4):
            raise ValueError(f"{name}: expected (N, 4, 4) f32 on CUDA")
    if n_eff.shape != (count,) or eye_faces.shape[1:] != (6, 3):
        raise ValueError("n_eff_v must have one entry a volume, eye_faces "
                         "(N, 6, 3)")
    params = torch.empty((3, count, 6, size_b, size_b), dtype=torch.float32,
                         device=dev)
    active = torch.empty((count, 6, size_b, size_b), dtype=torch.bool,
                         device=dev)
    depth_ptr = swap_ptr = row_ptr = cube_ptr = None
    h = w = s = row0 = 0
    block = 1
    if depth_map is not None:
        ops.check_cuda(depth_map, "depth_map", torch.float32)
        ops.check_cuda(cube_depth, "cube_depth", torch.float32)
        h, w = depth_map.shape
        s = cube_depth.shape[-1]
        if cube_depth.shape[1:] != (6, s, s) or size_b > s:
            raise ValueError(f"cube_depth shape {tuple(cube_depth.shape)}")
        block = depth_blocks((h, w), size_b)
        depth_ptr, cube_ptr = depth_map.data_ptr(), cube_depth.data_ptr()
        if swap is not None:
            swap = swap.contiguous()
            ops.check_cuda(swap, "swap", torch.bool)
            if swap.shape != (count, 6):
                raise ValueError(f"swap shape {tuple(swap.shape)}")
            swap_ptr = swap.data_ptr()
        if isinstance(rows, slice):
            row0 = rows.start
            if rows.stop - rows.start != count or rows.step not in (None, 1):
                raise ValueError(f"rows {rows} for {count} volumes")
        else:
            rows = rows.long().contiguous()
            ops.check_cuda(rows, "rows")
            row_ptr = rows.data_ptr()
    zn, zf = SharedConsts.Z_NEAR, SharedConsts.Z_FAR
    build.launch(
        "mv_sweep_prologue", ids.data_ptr(), n_eff.data_ptr(),
        eye_faces.data_ptr(), wvp.data_ptr(), wvp_i.data_ptr(), depth_ptr,
        swap_ptr, row_ptr, cube_ptr, params.data_ptr(), active.data_ptr(),
        count, size_b, s, row0, w, block, h // block, w // block,
        *wvp.stride(), *wvp_i.stride(), zn * zf,
        zn - zf, zf, device=dev)
    ops.count_launch("sweep_prologue")
    return SweepParams(params[0], params[1], params[2], active)
