"""Where kernel B1 and its plain version part, ray by ray.

On the card, from the repository root:

    python -m multivolumes_tpu_torch.tools.sweep_outliers [--rays 3]
        [--bucketed]

It renders the first frame of the 64-volume 1280x800 demo (orbit camera
at t = 0) with `lod_bucket_caps=None`, so that every volume marches at
S = 128 in one B1 launch (with `--bucketed`, the LOD sweep's S = 128
bucket instead), and runs B1 and its plain version on that launch's
operands, with the bf16 stacks of the frame and with f32 stacks. It
prints how many elements differ by more than atol 2e-3 + rtol 2e-2 and
on which rays. For the first `--rays` of those rays it then cuts the
ray's window after plane m, for every m, and prints the first plane at
which the two part, with the alpha and red both have accumulated around
it: a threshold flip shows as one plane where one side adds a sample and
the other does not. `one_sample_flip` finds that plane by bisection and
checks the flip's signature on any B1 launch's operands.
"""

from __future__ import annotations

import argparse
import sys

import torch

DEMO = dict(width=1280, height=800, grid_size=128, light_grid_size=96,
            max_ray_samples=256, max_light_samples=96, num_volumes=64,
            num_volume_srcs=10, cube_map_size=128)


def _beyond(got, want):
    return (got - want).abs() > 2e-3 + 2e-2 * want.abs()


def frame_launch(bucketed: bool, device):
    """The (args, kwargs) of the frame's B1 launch at S = 128."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod

    cfg = RenderConfig(**DEMO)
    if not bucketed:
        cfg = cfg.with_(lod_bucket_caps=None, composite_mode="warp")
    engine = MultiRayCaster(cfg, device=device)
    calls = []
    orig = sweep_mod.sweep_march

    def record(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    sweep_mod.sweep_march = record
    try:
        frame_lib.render_frame(engine.state, cam_lib.orbit_camera(
            0.0, cfg.aspect_ratio, device=device), engine.config)
    finally:
        sweep_mod.sweep_march = orig
    a, k = calls[0]
    k = dict(k)
    k.pop("impl", None)
    return a, k


def cut_march(a, k, ray, dtype, m: int):
    """March ray (v, f, i, j)'s volume alone with its window cut after
    plane m, by B1 and by its plain version -> (2, 4): the ray's
    accumulated (r, g, b, a) of each; zeros for m < 0."""
    from multivolumes_tpu_torch.render import sweep as sweep_mod
    from multivolumes_tpu_torch.render.sweep import SweepParams

    vols, light, tex, eye_f, params, smp, run, planes, size = a
    v, f, i, j = ray
    if m < 0:
        return torch.zeros((2, 4), device=eye_f.device)
    q = slice(v, v + 1)
    ew = eye_f[v, f, 2]
    ew_c = ew.clamp(-1.0, 1.0)
    delta = (1.0 - ew_c) / planes
    inv_gz = 1.0 / (1.0 - ew).clamp(min=1e-6)
    s_m = (ew_c + (m + 0.5) * delta - ew) * inv_gz
    lrow = (torch.tensor([v], device=ew.device) if k.get("light_ids") is None
            else k["light_ids"][q])
    cut = SweepParams(params.s_in[q], torch.minimum(params.s_end[q],
                                                    s_m + 1e-7),
                      params.ray_len[q], params.active[q])
    a1 = (vols.to(dtype), light.to(dtype), tex[q], eye_f[q], cut, smp[q],
          run[q], planes, size)
    kw = dict(light_ids=lrow, vol_zmax=k.get("vol_zmax"),
              n_eff_b=None if k.get("n_eff_b") is None else k["n_eff_b"][q])
    return torch.stack([sweep_mod.sweep_march(*a1, **kw, impl=impl)[
        0, f, :, i, j] for impl in ("kernel", "plain")])


def _parted(rows) -> bool:
    return bool((rows[0] - rows[1]).abs().amax() > 1e-4)


def first_parting_plane(a, k, ray, dtype):
    """Ray (v, f, i, j) cut after each plane in turn (`cut_march`) ->
    (first plane where kernel and plain version part by more than 1e-4,
    or -1; per-plane (kernel, plain) of the ray's accumulated (r, g, b,
    a))."""
    rows = torch.stack([cut_march(a, k, ray, dtype, m)
                        for m in range(a[7])])           # (P, 2, 4)
    parted = (rows[:, 0] - rows[:, 1]).abs().amax(1) > 1e-4
    first = int(parted.nonzero()[0]) if bool(parted.any()) else -1
    return first, rows


def one_sample_flip(a, k, ray):
    """Whether B1 and its plain version part on ray (v, f, i, j) by one
    sample that one side composites and the other skips (a threshold
    flip): bisect the plane m after which the two cut marches part
    (`cut_march`, agreeing within 1e-4 after plane m - 1), then require
    one side's accumulation to be unchanged across plane m (within 1e-6)
    while the other's alpha grows. -> (m, "kernel" or "plain", the side
    that adds the sample; or None when the two do not part so)."""
    dtype = a[0].dtype
    lo, hi = -1, a[7] - 1
    rows_lo, rows_hi = cut_march(a, k, ray, dtype, lo), \
        cut_march(a, k, ray, dtype, hi)
    if not _parted(rows_hi):
        return hi, None
    while hi - lo > 1:
        mid = (lo + hi) // 2
        rows = cut_march(a, k, ray, dtype, mid)
        if _parted(rows):
            hi, rows_hi = mid, rows
        else:
            lo, rows_lo = mid, rows
    grew = rows_hi - rows_lo                     # (2, 4): kernel, plain
    still = grew.abs().amax(1) <= 1e-6
    for side, other, name in ((1, 0, "kernel"), (0, 1, "plain")):
        if bool(still[side]) and float(grew[other, 3]) > 1e-4:
            return hi, name
    return hi, None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rays", type=int, default=3)
    p.add_argument("--bucketed", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_outliers: needs a CUDA device", file=sys.stderr)
        return 2
    from multivolumes_tpu_torch.render import sweep as sweep_mod

    dev = torch.device("cuda")
    a, k = frame_launch(args.bucketed, dev)
    got = sweep_mod.sweep_march(*a, **k, impl="kernel")
    want = sweep_mod.sweep_march(*a, **k, impl="plain")
    bad = _beyond(got, want)
    rays = sorted({tuple(x[:2] + x[3:]) for x in bad.nonzero().tolist()})
    print(f"bf16: {int(bad.sum())} of {bad.numel()} elements beyond, on "
          f"{len(rays)} rays; largest {float((got - want).abs().max()):.3e}")
    a32 = (a[0].float(), a[1].float()) + tuple(a[2:])
    bad32 = _beyond(sweep_mod.sweep_march(*a32, **k, impl="kernel"),
                    sweep_mod.sweep_march(*a32, **k, impl="plain"))
    print(f"f32: {int(bad32.sum())} elements beyond")
    eye_f, params = a[3], a[4]
    for ray in rays[:args.rays]:
        v, f, i, j = ray
        first, rows = first_parting_plane(a, k, ray, a[0].dtype)
        print(f"ray {ray}: eye {[round(x, 3) for x in eye_f[v, f].tolist()]}"
              f" window [{float(params.s_in[v, f, i, j]):.4f}, "
              f"{float(params.s_end[v, f, i, j]):.4f}], first parting "
              f"plane {first}")
        for m in range(max(first - 1, 0), min(first + 2, rows.shape[0])):
            (kr, ka), (pr, pa) = rows[m, 0, [0, 3]].tolist(), \
                rows[m, 1, [0, 3]].tolist()
            print(f"  plane {m}: kernel r {kr:.5f} a {ka:.5f}   plain r "
                  f"{pr:.5f} a {pa:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
