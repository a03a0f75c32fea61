"""Deferred shade of the opaque mesh (B8): kernel wrapper.

Hand kernel: `csrc/mesh_shade.cu`, which replaces no TPU kernel (the JAX
package leaves the shade to XLA, which fuses it). Plain version:
`render/mesh.py:shade_plain`, `_shader`'s closure on the rectangle. The
dispatch rule of `ops` is applied by `render/mesh.py:deferred_shade`,
which unpacks the scene and frame operands into this wrapper's tensors
or calls the plain version; this wrapper only launches.

For a rectangle of the screen, one `Span` an axis, it returns the shaded
fields (5, h, w) f32 (r, g, b, vx, vy) and valid (h, w) bool; with
`paste`, the full screen's (5, H, W) and (H, W), 0 and False outside the
rectangle. One call is one launch of the entry point, which runs two
kernels: the per-triangle planes and the per-pixel shade.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multivolumes_tpu_torch import ops


class Span(NamedTuple):
    """Pixels [start, start + size) of one screen axis: start is `base`,
    plus, with a `centre` (a 0-d f32 device tensor), the first index of
    the shade window centred there (`render/mesh.py:window_index`, the
    window's side wide), found on the device."""
    base: int
    size: int
    centre: torch.Tensor | None = None


def mesh_shade(tri_id, rows: Span, cols: Span, clip, verts, indices,
               world, s_vp, wvp, prev_wvp, eye, light_pos, light_color,
               ambient, sh_coeffs, shadow, *, height: int, width: int,
               window: int, has_light_probe: bool, tri_row0: int = 0,
               paste: bool = False):
    """B8 -> (fields (5, h, w), valid (h, w)); CUDA tensors only.

    tri_id (th, W) the raster's winning ids of screen rows [tri_row0,
    tri_row0 + th), -1 where empty; rows and cols the rectangle of the
    (height, width) screen, a centred span `window` wide; clip (V, 4) the
    jittered clip positions, verts (V, >= 6) position and normal, indices
    (T, 3); world, s_vp (shadow view-proj), wvp and prev_wvp (4, 4); eye
    (3,), light_pos (>= 3,), light_color and ambient (4,), sh_coeffs
    (9, 3), shadow the (sm, sm) shadow map; `has_light_probe` picks the
    SH ambient; `paste` the full-screen output."""
    from multivolumes_tpu_torch.ops import build

    f32, i64 = torch.float32, torch.int64
    for t, name, dtype in (
            (tri_id, "tri_id", i64), (indices, "indices", i64),
            (verts, "verts", f32), (clip, "clip", f32),
            (world, "world", f32), (s_vp, "s_vp", f32), (wvp, "wvp", f32),
            (prev_wvp, "prev_wvp", f32), (eye, "eye", f32),
            (light_pos, "light_pos", f32), (light_color, "light_color", f32),
            (ambient, "ambient", f32), (sh_coeffs, "sh_coeffs", f32),
            (shadow, "shadow", f32)):
        ops.check_cuda(t, name, dtype)
    n_tris, n_verts = indices.shape[0], verts.shape[0]
    if (tri_id.dim() != 2 or tri_id.shape[1] != width or n_tris < 1
            or indices.shape[1:] != (3,) or verts.shape[1] < 6
            or clip.shape != (n_verts, 4) or shadow.dim() != 2
            or min(shadow.shape) < 2 or sh_coeffs.shape != (9, 3)
            or eye.numel() != 3 or light_pos.numel() < 3
            or light_color.numel() != 4 or ambient.numel() != 4):
        raise ValueError(
            f"mesh_shade: tri_id {tuple(tri_id.shape)} for width {width}, "
            f"{n_tris} triangles, verts {tuple(verts.shape)}, clip "
            f"{tuple(clip.shape)}, shadow map {tuple(shadow.shape)}, "
            f"eye, light position, colour and ambient of {eye.numel()}, "
            f"{light_pos.numel()}, {light_color.numel()} and "
            f"{ambient.numel()}")
    for m, name in ((world, "world"), (s_vp, "s_vp"), (wvp, "wvp"),
                    (prev_wvp, "prev_wvp")):
        if m.shape != (4, 4):
            raise ValueError(f"{name}: expected (4, 4), got {tuple(m.shape)}")
    # the rows the rectangle may reach must be rows of tri_id
    lo, hi = ((rows.base, rows.base + rows.size) if rows.centre is None
              else (0, height))
    if not tri_row0 <= lo <= hi <= tri_row0 + tri_id.shape[0]:
        raise ValueError(f"tri_id holds rows [{tri_row0}, "
                         f"{tri_row0 + tri_id.shape[0]}), the rectangle "
                         f"needs [{lo}, {hi})")
    centres = []
    for span, extent, name in ((rows, height, "rows"), (cols, width, "cols")):
        room = extent if span.centre is None else window
        if span.size < 1 or span.base < 0 or span.base + span.size > room:
            raise ValueError(f"{name} {span[:2]} outside [0, {room})")
        if span.centre is not None:
            ops.check_cuda(span.centre, f"{name} centre", f32)
            if span.centre.dim() != 0 or not 0 < window <= extent:
                raise ValueError(f"{name}: a 0-d centre and a window of "
                                 f"at most {extent} px, got {window}")
        centres.append(None if span.centre is None
                       else span.centre.data_ptr())
    dev = tri_id.device
    out_h, out_w = (height, width) if paste else (rows.size, cols.size)
    planes = torch.empty((n_tris, 24), dtype=f32, device=dev)
    fields = torch.empty((5, out_h, out_w), dtype=f32, device=dev)
    valid = torch.empty((out_h, out_w), dtype=torch.bool, device=dev)
    build.launch(
        "mv_mesh_shade", clip.data_ptr(), verts.data_ptr(),
        indices.data_ptr(), planes.data_ptr(), tri_id.data_ptr(),
        world.data_ptr(), s_vp.data_ptr(), wvp.data_ptr(),
        prev_wvp.data_ptr(), eye.data_ptr(), light_pos.data_ptr(),
        light_color.data_ptr(), ambient.data_ptr(), sh_coeffs.data_ptr(),
        shadow.data_ptr(), centres[0], centres[1], fields.data_ptr(),
        valid.data_ptr(), n_tris, verts.shape[1], tri_id.shape[0], width,
        tri_row0, rows.base, cols.base, rows.size, cols.size, window, height,
        width, out_h, out_w, int(paste), int(has_light_probe),
        shadow.shape[0], shadow.shape[1], device=dev)
    ops.count_launch("mesh_shade")
    return fields, valid
