"""The light cohort update around B3 / B4: B10, the prologue, and B11, the
epilogue (kernel wrappers).

Hand kernels: `csrc/lightsweep_prep.cu`, which replace no TPU kernel (the
JAX package leaves this glue to XLA, which fuses it). Plain version:
`render/lightsweep.py` (`light_transmittance`, `_shadow_entry`,
`_shade_light_fields` and the stores), which
`ray_march_light_sweep_update` runs for CPU tensors and `impl="plain"`.

A cohort update on the card is five launches:

* `light_prologue` (B10a): the shear geometry of every volume, the
  cohort's du, dv, f_corr and orientation, its density sweep-major (B3's
  rho_o) and, with the mesh's shadow map, its sm_vol, z_entry, dz_slice
  and soft, the shadow operands of B3';
* B3 or B3' (`ops/lightsweep.py:light_self_scan`), unchanged;
* `light_occlusion` (B10b): t_ins, the occlusion of the volumes ahead of
  each cohort volume on its entry plane, from B3's footprints and the
  cached ones, which it updates;
* B4 (`light_advect_mul`), unchanged;
* `light_epilogue` (B11): the shade and the stores of the light-map rows.

The helpers below state the kernels' tap and rank rules in PyTorch; the
CPU tests hold them to the plain version's `argsort`, `_resample_matrix`
and products.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from multivolumes_tpu_torch import ops

MAX_VOLUMES = 1024   # csrc/lightsweep_prep.cu: kMaxN


class LightPrep(NamedTuple):
    """B10a's outputs: B3's operands and what B10b and B11 read."""
    rho_o: torch.Tensor      # (C, L, L, L) sweep-major density
    du: torch.Tensor         # (C,)
    dv: torch.Tensor         # (C,)
    f_corr: torch.Tensor     # (C,)
    sm: dict                 # B3' operands sm_vol .. soft, or {}
    scal: torch.Tensor       # (6, C): du, dv, f_corr, dz_slice, soft, flip
    table: torch.Tensor      # the geometry table (csrc: Table)
    sub: torch.Tensor        # (C,) int64 the cohort
    n: int                   # volumes
    axis: int


def _f32(t: torch.Tensor, name: str, shape=None) -> torch.Tensor:
    t = t.contiguous()
    ops.check_cuda(t, name, torch.float32)
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def _i64(t: torch.Tensor, name: str, n: int) -> torch.Tensor:
    t = t.contiguous()
    ops.check_cuda(t, name, torch.int64)
    if t.shape != (n,):
        raise ValueError(f"{name}: expected shape ({n},), got "
                         f"{tuple(t.shape)}")
    return t


def light_prologue(rho_light, vol_tex_ids, sub, per_object, light_dir,
                   step_scale: float, axis: int, shadow_map=None,
                   shadow_vp=None, shadow_bias: float = 0.0027) -> LightPrep:
    """B10a: rho_light (N_src, L, L, L) f32; vol_tex_ids (N,) and sub (C,)
    int64; per_object's world and world_i (N, 4, 4); light_dir (3,) unit
    toward the light; with shadow_map (Hs, Ws) and shadow_vp (4, 4) the
    shadow operands of B3'."""
    from multivolumes_tpu_torch.ops import build

    l = rho_light.shape[1]
    n, c = vol_tex_ids.shape[0], sub.shape[0]
    if not 0 < n <= MAX_VOLUMES:
        raise ValueError(f"{n} volumes: B10 takes 1 to {MAX_VOLUMES}")
    rho_light = _f32(rho_light, "rho_light", (rho_light.shape[0], l, l, l))
    vol_tex_ids = _i64(vol_tex_ids, "vol_tex_ids", n)
    sub = _i64(sub, "sub_ids", c)
    world = _f32(per_object.world, "world", (n, 4, 4))
    world_i = _f32(per_object.world_i, "world_i", (n, 4, 4))
    light_dir = _f32(light_dir, "light_dir", (3,))
    dev = rho_light.device
    rho_o = torch.empty((c, l, l, l), dtype=torch.float32, device=dev)
    scal = torch.empty((6, c), dtype=torch.float32, device=dev)
    table = torch.empty(6 * n + 5 * c, dtype=torch.float32, device=dev)
    sm_ptr = vp_ptr = entry = None
    hs = ws = 0
    if shadow_map is not None:
        shadow_map = _f32(shadow_map, "shadow_map")
        shadow_vp = _f32(shadow_vp, "shadow_vp", (4, 4))
        hs, ws = shadow_map.shape
        entry = torch.empty((2, c, l, l), dtype=torch.float32, device=dev)
        sm_ptr, vp_ptr = shadow_map.data_ptr(), shadow_vp.data_ptr()
    # PyTorch on the card divides a float32 tensor by a host scalar as a
    # product with the scalar's reciprocal, taken in double and rounded
    recip = [float(np.float32(1.0 / x)) for x in (step_scale, l, 2 * l)]
    build.launch(
        "mv_light_prologue", rho_light.data_ptr(), vol_tex_ids.data_ptr(),
        sub.data_ptr(), world.data_ptr(), world_i.data_ptr(),
        light_dir.data_ptr(), sm_ptr, vp_ptr, rho_o.data_ptr(),
        scal.data_ptr(), None if entry is None else entry.data_ptr(),
        table.data_ptr(), n, c, l, axis, hs, ws, float(np.float32(2.0 / l)),
        *recip, float(np.float32(shadow_bias)), device=dev)
    ops.count_launch("light_prologue")
    sm = {} if entry is None else dict(sm_vol=entry[0], z_entry=entry[1],
                                       dz_slice=scal[3], soft=scal[4])
    return LightPrep(rho_o, scal[0], scal[1], scal[2], sm, scal, table, sub,
                     n, axis)


def light_occlusion(prep: LightPrep, s_out_c, sout_cache=None):
    """B10b -> t_ins (C, L, L): B4's incoming occlusion. s_out_c (C, L, L)
    is B3's footprints; sout_cache (N, L, L), when given, is read for the
    volumes outside the cohort and takes the cohort's rows in place;
    without it the cohort is every volume."""
    from multivolumes_tpu_torch.ops import build

    c, l, n = prep.rho_o.shape[0], prep.rho_o.shape[1], prep.n
    s_out_c = _f32(s_out_c, "s_out", (c, l, l))
    if sout_cache is None:
        if c != n:
            raise ValueError("without sout_cache the cohort is every volume")
        cache_ptr = None
    else:
        ops.check_cuda(sout_cache, "sout_cache", torch.float32)
        if sout_cache.shape != (n, l, l):
            raise ValueError(f"sout_cache shape {tuple(sout_cache.shape)}")
        cache_ptr = sout_cache.data_ptr()
    t_ins = torch.empty((c, l, l), dtype=torch.float32, device=s_out_c.device)
    build.launch("mv_light_occlusion", prep.table.data_ptr(),
                 prep.sub.data_ptr(), s_out_c.data_ptr(), cache_ptr,
                 t_ins.data_ptr(), n, c, l, device=s_out_c.device)
    ops.count_launch("light_occlusion")
    return t_ins


def light_epilogue(fields, prep: LightPrep, rho_light, ao, grad_dir,
                   vol_tex_ids, sh_coeffs, ambient, light_color,
                   has_light_probe: bool, store=None):
    """B11: B4's oriented fields (C, L, L, L) -> the RGB light maps. With
    `store` = (light_maps (N', 3, L, L, L) f32, light_sweep (N', L, L, L,
    4) bf16 or f32, rows (C,) int64) they are written there in place and
    None is returned; without it -> maps (C, 3, L, L, L)."""
    from multivolumes_tpu_torch.ops import build

    c, l = prep.rho_o.shape[0], prep.rho_o.shape[1]
    n_src = rho_light.shape[0]
    fields = _f32(fields, "fields", (c, l, l, l))
    rho_light = _f32(rho_light, "rho_light", (n_src, l, l, l))
    ao = _f32(ao, "ao", (n_src, l, l, l))
    grad_dir = _f32(grad_dir, "grad_dir", (n_src, 3, l, l, l))
    vol_tex_ids = _i64(vol_tex_ids, "vol_tex_ids", vol_tex_ids.shape[0])
    sh_coeffs = _f32(sh_coeffs, "sh_coeffs", (9, 3))
    ambient = _f32(ambient, "ambient", (4,))
    light_color = _f32(light_color, "light_color", (4,))
    dev = fields.device
    if store is None:
        maps = torch.empty((c, 3, l, l, l), dtype=torch.float32, device=dev)
        rows_ptr = sweep_ptr = None
        bf16 = 0
    else:
        maps, sweep, rows = store
        ops.check_cuda(maps, "light_maps", torch.float32)
        ops.check_cuda(sweep, "light_sweep", (torch.bfloat16, torch.float32))
        if maps.shape[1:] != (3, l, l, l) or sweep.shape[1:] != (l, l, l, 4) \
                or sweep.shape[0] != maps.shape[0]:
            raise ValueError(f"light stacks {tuple(maps.shape)} "
                             f"{tuple(sweep.shape)}")
        rows = _i64(rows, "rows", c)
        rows_ptr, sweep_ptr = rows.data_ptr(), sweep.data_ptr()
        bf16 = int(sweep.dtype == torch.bfloat16)
    build.launch(
        "mv_light_epilogue", fields.data_ptr(), prep.scal.data_ptr(),
        rho_light.data_ptr(), ao.data_ptr(), grad_dir.data_ptr(),
        vol_tex_ids.data_ptr(), prep.sub.data_ptr(), sh_coeffs.data_ptr(),
        ambient.data_ptr(), light_color.data_ptr(), maps.data_ptr(),
        rows_ptr, sweep_ptr, rows_ptr, c, l, prep.axis,
        int(has_light_probe), bf16, device=dev)
    ops.count_launch("light_epilogue")
    return maps if store is None else None


def light_ranks(key):
    """Each volume's place in light order, counted as B10a counts it: the
    keys (-proj) before it in a stable ascending order (NaN last) ->
    (N,) int64, `argsort(argsort(key, stable=True), stable=True)`."""
    i = torch.arange(key.shape[0], device=key.device)
    kj, ki = key[None, :], key[:, None]
    nj, ni = torch.isnan(kj), torch.isnan(ki)
    lower = i[None, :] < i[:, None]
    before = torch.where(ni | nj, torch.where(nj, ni & lower, True),
                         (kj < ki) | ((kj == ki) & lower))
    return before.sum(1)


def entry_taps(n_out: int, n_in: int, scale, offset):
    """The non-zeros of `_resample_matrix(n_out, n_in, scale, offset)`, as
    B10 reads them: src = clamp(i scale + offset, 0, n_in - 1), taps
    floor(src) and the next (absent past n_in - 1) -> (i0, w0, w1), each
    (C, n_out); w1 is 0 where the second tap is absent."""
    rows = torch.arange(n_out, dtype=torch.float32, device=scale.device)
    src = torch.clamp(rows * scale[:, None] + offset[:, None], 0.0,
                      n_in - 1.0)
    i0 = torch.floor(src)
    w0 = torch.clamp(1.0 - (src - i0).abs(), min=0.0)
    w1 = torch.where(i0 + 1 <= n_in - 1,
                     torch.clamp(1.0 - (src - (i0 + 1)).abs(), min=0.0), 0.0)
    return i0.long(), w0, w1


def exit_taps(n_in: int, n_out: int, scale, offset):
    """The exit-plane tent rows of `light_transmittance` (wu_all, wv_all:
    src = (gi - offset) / scale, unclamped, zero outside the footprint),
    as B10b reads them at every global texel gi < n_in -> (i0, w0, w1),
    each (N, n_in), i0 = floor(src) (taps outside [0, n_out) weigh 0)."""
    gi = torch.arange(n_in, dtype=torch.float32, device=scale.device)
    src = (gi[None, :] - offset[:, None]) / scale[:, None]
    i0 = torch.floor(torch.clamp(src, -2.0, float(n_out + 1)))
    w0 = torch.where((i0 >= 0) & (i0 <= n_out - 1),
                     torch.clamp(1.0 - (src - i0).abs(), min=0.0), 0.0)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 <= n_out - 1),
                     torch.clamp(1.0 - (src - (i0 + 1)).abs(), min=0.0), 0.0)
    return i0.long(), w0, w1


def occlusion_by_taps(s_out_all, ranks, sub, su, sv, ou_o, ov_o, su_in,
                      ou_in, sv_in, ov_in, l: int):
    """t_ins as B10b forms it, without any (N, G, G) tensor: each entry
    texel of each cohort volume takes its 2 x 2 taps of g_in, and each
    g_in texel is the product, in light order over the volumes ahead, of
    fac = o + (1 - cover), o the 2 x 2 tent sample of that volume's
    footprint. Equal to the plain version's einsums and masked product to
    rounding. s_out_all (N, L, L); ranks (N,); sub (C,); su .. ov_o (N,)
    the exit resample of every volume; su_in .. ov_in (C,) the cohort's
    entry resample -> (C, L, L)."""
    g = 2 * l
    order = torch.argsort(ranks)
    vi0, vw0, vw1 = entry_taps(l, g, sv_in, ov_in)     # (C, L) rows v
    ui0, uw0, uw1 = entry_taps(l, g, su_in, ou_in)     # (C, L) columns u
    gv_i0, gv_w0, gv_w1 = exit_taps(g, l, sv, ov_o)    # (N, G)
    gu_i0, gu_w0, gu_w1 = exit_taps(g, l, su, ou_o)
    out = []
    for ci in range(sub.shape[0]):
        rank = int(ranks[sub[ci]])
        # the (g, h) grid the cohort volume's entry taps read
        gs = torch.stack([vi0[ci], torch.clamp(vi0[ci] + 1, max=g - 1)])
        hs = torch.stack([ui0[ci], torch.clamp(ui0[ci] + 1, max=g - 1)])
        gin = torch.ones((2, l, 2, l), dtype=torch.float32,
                         device=s_out_all.device)
        for j in order[:rank].tolist():
            s = s_out_all[j]

            def taps(i0, w0, w1, at):
                i = i0[j][at]
                return (torch.clamp(i, 0, l - 1), w0[j][at],
                        torch.clamp(i + 1, 0, l - 1), w1[j][at])

            l0, a0, l1, a1 = taps(gv_i0, gv_w0, gv_w1, gs)   # (2, L)
            k0, b0, k1, b1 = taps(gu_i0, gu_w0, gu_w1, hs)

            def at(li, ki):
                return s[li[:, :, None, None], ki[None, None, :, :]]

            A0 = a0[:, :, None, None] * at(l0, k0) \
                + a1[:, :, None, None] * at(l1, k0)
            A1 = a0[:, :, None, None] * at(l0, k1) \
                + a1[:, :, None, None] * at(l1, k1)
            o = A0 * b0[None, None] + A1 * b1[None, None]
            cover = torch.clamp((a0 + a1)[:, :, None, None]
                                * (b0 + b1)[None, None], 0.0, 1.0)
            gin = gin * (o + (1.0 - cover))
        tv = vw0[ci][:, None, None] * gin[0] + vw1[ci][:, None, None] * gin[1]
        out.append(tv[:, 0] * uw0[ci][None, :] + tv[:, 1] * uw1[ci][None, :])
    return torch.stack(out)
