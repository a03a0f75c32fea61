"""The fused TAA resolve (B5) and its row-band form (B5').

Hand kernels: `csrc/taa.cu`. B5 replaces the TPU kernel
`multivolumes_tpu/ops/pallas/taa_kernel.py::taa_resolve` (through
`_resolve_bands`); B5' (`taa_resolve_band`, `taa_resolve_sharded`)
replaces `::taa_resolve_sharded`, the same resolve on one band of pixel
rows per device of a mesh's "rows" axis, whose only cross-device traffic
is a one-row halo of the current frame.

The plain version below follows the semantics twin
`multivolumes_tpu/render/taa.py::_temporal_aa_jnp` operation for
operation (a port of `CSTemporalAA.hlsl:254-336`): per pixel, Reinhard in
YCoCg over the edge-clamped 3x3 neighbourhood (cross weight 0.5, diagonal
0.25), mean and variance giving a variance AABB (gamma 1 or 16), the
history clamp, the anti-flicker blend with the history count in channel
3 (at most 15), and the NaN guard. With `tonemap=True` it also returns the
display image `|x * 1.05 / (x + 0.7)| ** 1.25` of the resolved colour.

The history reprojection is not part of it: callers pass the reprojected
history and its `blur` field (`render/taa.py`).

The TPU version builds three row-shifted copies of the whole frame with
edge padding and pads the rows to a multiple of 16 x rows (Pallas block
layout). Here a band reads its halo rows directly: `cur_halo` is the band
with the row above and the row below it (`collectives.halo_rows`), and
the bands are ceil(H / rows) rows high, the last one shorter. The fused
tone map is not offered on this path, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvbench.reference.render.postprocess import tone_map_ch

HISTORY_MAX = 15.0  # (1 << 4) - 1, `CSTemporalAA.hlsl:41-43`
ALPHA_BOUND = 1.0   # the reference's vcxproj override

# tap offsets (`g_texOffsets`): 4 cross then 4 diagonal
OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1),
           (-1, -1), (1, -1), (1, 1), (-1, 1))
WEIGHTS = (0.5, 0.5, 0.5, 0.5, 0.25, 0.25, 0.25, 0.25)


def rgb_to_ycocg(r, g, b):
    return (r + 2.0 * g + b, 2.0 * r - 2.0 * b, -r + 2.0 * g - b)


def ycocg_to_rgb(y, co, cg):
    y, co, cg = y * 0.25, co * 0.25, cg * 0.25
    return (y + co - cg, y + cg, y - co - cg)


def tm(r, g, b):
    """Invertible Reinhard in YCoCg (`TM`, `CSTemporalAA.hlsl:106-114`)."""
    y, co, cg = rgb_to_ycocg(r, g, b)
    inv = 1.0 / (4.0 + y)
    return y * inv, co * inv, cg * inv


def itm(y, co, cg):
    """Inverse of `tm` (`ITM`, `CSTemporalAA.hlsl:119-128`)."""
    s = 4.0 / (1.0 - y)
    return ycocg_to_rgb(y * s, co * s, cg * s)


def shift_views(img):
    """(..., H, W) -> {(dx, dy): out} with out[y, x] = img[y + dy, x + dx],
    edge-clamped, for the centre and the 8 neighbours."""
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    pad = F.pad(img.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")
    pad = pad.reshape(*lead, h + 2, w + 2)
    return {(dx, dy): pad[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            for dx in (-1, 0, 1) for dy in (-1, 0, 1)}


def taa_resolve_plain(cur, hist, blur, tonemap: bool = False):
    """Plain version of B5. cur (4, H, W) current rgba; hist (4, H, W)
    reprojected history; blur (H, W) the current history blur. Returns
    the new history (4, H, W), whose channels 0..2 are the resolved
    colour, and with `tonemap` also the display image (3, H, W)."""
    cur = cur.float()
    return _resolve(cur, shift_views(cur), hist, blur, tonemap)


def _resolve(cur, views, hist, blur, tonemap: bool):
    """The per-pixel resolve on `cur` (4, h, W) with its 8 neighbour
    views (each (4, h, W))."""
    hist, blur = hist.float(), blur.float()
    cr, cg_, cb, ca = cur
    history_blur = torch.maximum(1.0 - hist[3], blur)
    hist_w = hist[3] * HISTORY_MAX + 1.0

    cy, cco, ccg = tm(cr, cg_, cb)
    cur_a = torch.where(ca < ALPHA_BOUND, 0.0, 1.0)
    gamma = torch.where((history_blur > 0.0) | (ca < ALPHA_BOUND), 1.0, 16.0)

    # NeighborMinMax (`CSTemporalAA.hlsl:166-236`)
    m1 = [cy, cco, ccg]
    m2 = [cy * cy, cco * cco, ccg * ccg]
    filt = [cy, cco, ccg]
    filt_a = cur_a
    for off, wt in zip(OFFSETS, WEIGHTS):
        nr, ng, nb, na = views[off]
        ny, nco, ncg = tm(nr, ng, nb)
        na = torch.where(na < ALPHA_BOUND, 0.0, 1.0)
        for ci, nv in enumerate((ny, nco, ncg)):
            filt[ci] = filt[ci] + nv * wt
            m1[ci] = m1[ci] + nv
            m2[ci] = m2[ci] + nv * nv
        filt_a = filt_a + na * wt
    filt = [f / 4.0 for f in filt]
    filt_a = filt_a / 4.0

    mu = [m / 9.0 for m in m1]
    sigma = [torch.sqrt((m2[c] / 9.0 - mu[c] * mu[c]).abs())
             for c in range(3)]
    n_min = [torch.minimum(mu[c] - gamma * sigma[c], filt[c])
             for c in range(3)]
    n_max = [torch.maximum(mu[c] + gamma * sigma[c], filt[c])
             for c in range(3)]
    n_min_w = mu[0] - sigma[0]
    n_max_w = mu[0] + sigma[0]

    cur_history_blur = torch.clamp(blur, 0.0, 1.0)
    history_blur = torch.clamp(history_blur, 0.0, 1.0)

    hist_tm = [torch.clamp(v, n_min[c], n_max[c])
               for c, v in enumerate(tm(hist[0], hist[1], hist[2]))]
    contrast = n_max_w - n_min_w

    lum_contrast_factor = 32.0 * 4.0
    add_alias = history_blur * 0.5 + 0.25
    add_alias = torch.clamp(
        add_alias + 1.0 / (1.0 + contrast * lum_contrast_factor), 0.0, 1.0)
    cur_tm = (cy, cco, ccg)
    filt = [filt[c] + (cur_tm[c] - filt[c]) * add_alias for c in range(3)]

    lum_hist = hist_tm[0]
    dist_to_clamp = torch.minimum((n_min_w - lum_hist).abs(),
                                  (n_max_w - lum_hist).abs())
    history_amt = torch.clamp(1.0 / hist_w + history_blur / 8.0, max=1.0)
    blend = 0.25 / (8.0 + (dist_to_clamp + contrast - 8.0) * history_amt)
    blend = torch.clamp(blend, max=0.25)
    blend = torch.where(filt_a > 0.0, blend, 1.0)

    mixed = [hist_tm[c] + (filt[c] - hist_tm[c]) * blend for c in range(3)]
    rr, rg, rb = itm(*mixed)
    fr, fg, fb = itm(*filt)
    bad = torch.isnan(rr) | torch.isnan(rg) | torch.isnan(rb)
    rr = torch.where(bad, fr, rr)
    rg = torch.where(bad, fg, rg)
    rb = torch.where(bad, fb, rb)

    meta = torch.minimum(hist_w / HISTORY_MAX, 1.0 - cur_history_blur)
    new_history = torch.stack([rr, rg, rb, meta], 0)
    if tonemap:
        return new_history, torch.stack(tone_map_ch(rr, rg, rb), 0)
    return new_history


def taa_resolve(cur, hist, blur, tonemap: bool = False, impl=None):
    """B5's plain version: see `taa_resolve_plain`."""
    del impl
    return taa_resolve_plain(cur, hist, blur, tonemap=tonemap)


