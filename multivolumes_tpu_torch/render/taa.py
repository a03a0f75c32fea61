"""Temporal anti-aliasing resolve.

Counterpart of `multivolumes_tpu/render/taa.py` (a port of
`CSTemporalAA.hlsl:254-336` with the reference's shipped configure:
variance AABB, YCoCg, `ALPHA_BOUND = 1`). The per-pixel resolve is kernel
B5 (`ops/taa.py`); this module reprojects the history first when the
frame has a velocity field.

Without a mesh nothing writes velocity (the reference's volumes never
do, `PSBasePass.hlsl:107-109`), so the history is used as it is and the
history blur is zero. With a velocity field (the mesh) the history is
reprojected by an ordinary bilinear gather (the JAX package's quad-row
table, `_bilinear_rows16`, is a TPU gather workaround): over the whole
screen, or, given the mesh's screen centre and a window, only in that
window (velocity is zero outside it), the window cut and pasted back by
index arithmetic on the device. The frame's record counts the pixels
reprojected (`utils.timing.add`, counter `taa.reproj_px`).
"""

from __future__ import annotations

import torch

from multivolumes_tpu_torch.ops import taa as taa_ops
from multivolumes_tpu_torch.render.mesh import window_index
from multivolumes_tpu_torch.utils import timing
from multivolumes_tpu_torch.ops.taa import (  # noqa: F401  (the module API)
    OFFSETS, itm, rgb_to_ycocg, tm, ycocg_to_rgb)


def velocity_max(vx, vy):
    """Center + 4 diagonal taps, keep the fastest (`VelocityMax`,
    `CSTemporalAA.hlsl:133-161`)."""
    sx, sy = taa_ops.shift_views(vx), taa_ops.shift_views(vy)
    best_x, best_y = vx, vy
    best_sq = vx * vx + vy * vy
    for off in OFFSETS[4:]:
        nx, ny = sx[off], sy[off]
        sq = nx * nx + ny * ny
        take = sq > best_sq
        best_x = torch.where(take, nx, best_x)
        best_y = torch.where(take, ny, best_y)
        best_sq = torch.maximum(sq, best_sq)
    return best_x, best_y


def _sample_bilinear_ch(img, u, v):
    """img (H, W), u/v (H, W) normalized -> (H, W). Linear clamp."""
    h, w = img.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f

    def cidx(vv, nn):
        return torch.clamp(vv.long(), 0, nn - 1)

    x0, x1 = cidx(x0f, w), cidx(x0f + 1, w)
    y0, y1 = cidx(y0f, h), cidx(y0f + 1, h)
    c0 = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    c1 = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return c0 * (1 - fy) + c1 * fy


def reproject(history, velocity):
    """Full-screen history reprojection -> (history (4, H, W), blur)."""
    _, h, w = history.shape
    mvx, mvy = velocity_max(*velocity)
    dev = history.device
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    vg, ug = torch.meshgrid(ys, xs, indexing="ij")
    ub, vb = ug - mvx, vg - mvy
    hist = torch.stack([_sample_bilinear_ch(history[c], ub, vb)
                        for c in range(4)], 0)
    blur = mvx.abs() * (4.0 * w) + mvy.abs() * (4.0 * h)
    return hist, blur


def reproject_window(history, velocity, center, win: int):
    """History reprojection inside the `win`-square window centred on
    `center` (device scalars (cx, cy), px); the identity elsewhere. The
    velocity dilation sees only the window (edge-clamped there), as the
    JAX package's windowed path does. -> (history, blur)."""
    _, h, w = history.shape
    dev = history.device
    xs = window_index(center[0], win, w, dev)
    ys = window_index(center[1], win, h, dev)
    yi, xi = ys[:, None], xs[None, :]
    mvx, mvy = velocity_max(velocity[0][yi, xi], velocity[1][yi, xi])
    ub = (xs.float() + 0.5)[None, :] / w - mvx
    vb = (ys.float() + 0.5)[:, None] / h - mvy
    hist = history.clone()
    hist[:, yi, xi] = torch.stack([_sample_bilinear_ch(history[c], ub, vb)
                                   for c in range(4)], 0)
    blur = torch.zeros((h, w), dtype=torch.float32, device=dev)
    blur[yi, xi] = mvx.abs() * (4.0 * w) + mvy.abs() * (4.0 * h)
    return hist, blur


def temporal_aa(current, history, velocity, tonemap_out: bool = False,
                impl: str | None = None, reproj_center=None,
                reproj_window: int = 0, device_mesh=None):
    """current: (r, g, b, a) fields ((H, W) each; a < 1 marks
    transparency); history: (4, H, W) previous output + metadata;
    velocity: (vx, vy) fields, or None when nothing writes velocity;
    reproj_center (cx, cy) and 0 < reproj_window < min(H, W) restrict the
    reprojection to that window. Returns ((r, g, b) resolved, new history
    (4, H, W)), and the display image (3, H, W) as a third element when
    `tonemap_out`. With a `device_mesh` that has a "rows" axis, the
    reprojection runs on the whole (gathered) history and the resolve
    runs one row band per device (kernel B5'); the fused tone map is not
    offered there."""
    rows_mesh = device_mesh is not None and "rows" in device_mesh.axis_names
    if rows_mesh and tonemap_out:
        raise ValueError("the fused tone map is not offered on a mesh with "
                         "a rows axis: tone-map the resolved colour")
    cur = torch.stack([x.float() for x in current], 0)
    h, w = cur.shape[1:]
    if velocity is None:
        hist = history
        blur = torch.zeros_like(cur[0])
    elif reproj_center is not None and 0 < reproj_window < min(h, w):
        hist, blur = reproject_window(history, velocity, reproj_center,
                                      reproj_window)
        timing.add("taa.reproj_px", reproj_window * reproj_window)
    else:
        hist, blur = reproject(history, velocity)
        timing.add("taa.reproj_px", h * w)
    if rows_mesh:
        out = taa_ops.taa_resolve_sharded(device_mesh, cur, hist, blur,
                                          impl=impl)
        return tuple(out[:3]), out
    out = taa_ops.taa_resolve(cur, hist, blur, tonemap=tonemap_out,
                              impl=impl)
    if tonemap_out:
        new_history, image = out
        return tuple(new_history[:3]), new_history, image
    return tuple(out[:3]), out
