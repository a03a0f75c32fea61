"""Roofline arithmetic of the hand kernels B1-B5: the least time a launch
could take on the card, from the operands of the launch.

A frozen copy of `chip_smoke.py:bound_sweep`, `bound_composite`,
`bound_self_scan`, `bound_advect` and `bound_taa` of the port's
repository, with B1's data-dependent sample count taken from the frozen
plain march of `mvbench.reference` (`sweep_march_plain(sample_counts=
True)`), never from the program. Each takes the (args, kwargs) of one
call of the kernel's entry point in `multivolumes_tpu_torch.ops` and
returns (bytes, f32 operations).

The least time is the larger of bytes over the HBM rate and operations
over the f32 rate, against the published peaks of one H100 SXM (dense,
700 W); the run records the card's power limit beside it.
"""

from __future__ import annotations

import torch

MEM_RATE = 3.35e12    # HBM3 bytes/s
F32_RATE = 67e12      # f32 FLOP/s outside the tensor cores


def least_s(nbytes: float, flops: float) -> float:
    return max(nbytes / MEM_RATE, flops / F32_RATE)


def _nbytes(*tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def bound_sweep(args, kwargs):
    """B1: bytes, the distinct texels of the source volumes (4 channels)
    and light stacks (3) that the needed samples' taps read, the per-ray
    parameters and the output; operations, the front-to-back update (14
    f32 operations) of each needed sample: a live sample (density above
    0.01 inside the ray's window) met while the ray's transmittance is
    still at least 0.01 (the trilinear taps are not counted)."""
    from mvbench.reference.ops.sweep import sweep_march_plain

    vols, light, tex = args[:3]
    params, size = args[4], args[8]
    _acc, counts = sweep_march_plain(
        *args[:9], n_eff_b=kwargs.get("n_eff_b"),
        light_ids=kwargs.get("light_ids"), sample_counts=True)
    out = 4 * tex.shape[0] * 6 * 4 * size * size
    nbytes = (counts["vol_texels"] * 4 * vols.element_size()
              + counts["light_texels"] * 3 * light.element_size()
              + _nbytes(*params) + out)
    return nbytes, 14.0 * float(counts["needed"].sum())


def bound_composite(args, kwargs):
    """B2 (B2' with `depth_sel`): the listed volumes' faces (their n_eff
    corners; with the depth variant the depth corners of the volumes
    listed on mesh tiles), the scene plane, the lists and the output;
    operations: the ray / box exit and exit-face test of each (pixel,
    listed volume) pair (60 f32 operations, a lower bound: the warp of
    the pairs that pass is not counted)."""
    color, scene, tlist, counts, vol_flt, face_flt, th, tw = args[:8]
    n = color.shape[0]
    pairs = float(counts.sum()) * th * tw
    listed = torch.zeros(n, dtype=torch.bool, device=color.device)
    for t in range(tlist.shape[0]):
        listed[tlist[t, :int(counts[t])].long()] = True
    n_eff = vol_flt[:, 20]
    corner = float((n_eff[listed] ** 2).sum()) * 6
    nbytes = corner * 4 * color.element_size()
    if kwargs.get("depth_sel") is not None:
        from mvbench.reference.ops.composite import mesh_tiles

        on = mesh_tiles(scene, th, tw).flatten()
        mlisted = torch.zeros_like(listed)
        for t in torch.nonzero(on).flatten().tolist():
            mlisted[tlist[t, :int(counts[t])].long()] = True
        nbytes += float((n_eff[mlisted] ** 2).sum()) * 6 * 4
    nbytes += _nbytes(scene, tlist, counts, vol_flt, face_flt) \
        + 4 * scene.numel() * 4
    return nbytes, 60.0 * pairs


def bound_self_scan(args, kwargs):
    """B3 (B3' with the shadow plane): density in, here out, the
    footprint out (+ the shadow plane); operations per texel and slice:
    the 2-tap lerp (9) and the attenuation (4, counting exp2 and log2 as
    one each), + the shadow plane's lerp and compare (13)."""
    rho = args[0]
    c, l = rho.shape[0], rho.shape[1]
    sm = kwargs.get("sm_vol", args[4] if len(args) > 4 else None)
    per = 13.0 + (13.0 if sm is not None else 0.0)
    nbytes = 2 * _nbytes(rho) + c * l * l * 4 * (2 if sm is not None else 1)
    return nbytes, per * c * l ** 3


def bound_advect(args, kwargs):
    """B4: here in, t_in in, out; the 2-tap lerp and one multiply (10) per
    texel and slice."""
    here, t_in = args[0], args[1]
    return 2 * _nbytes(here) + _nbytes(t_in), 10.0 * here.numel()


def bound_taa(args, kwargs):
    """B5: cur, hist and blur in, the history (and the image) out; nine
    tone-mapped taps with their moments per pixel (130 f32 operations, a
    lower bound)."""
    cur, hist, blur = args[:3]
    out = 4 + (3 if kwargs.get("tonemap") else 0)
    pixels = cur.shape[1] * cur.shape[2]
    return _nbytes(cur, hist, blur) + out * pixels * 4, 130.0 * pixels
