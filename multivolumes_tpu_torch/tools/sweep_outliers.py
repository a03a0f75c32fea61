"""Where kernel B1 and its plain version part, ray by ray.

On the card, from the repository root:

    python -m multivolumes_tpu_torch.tools.sweep_outliers [--rays 3]
        [--bucketed]
    python -m multivolumes_tpu_torch.tools.sweep_outliers --sharded
        [--rays 3] [--time-only]

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
the other does not. `one_sample_flips` finds that plane by bisection and
checks the flip's signature on any B1 launch's operands, for many rays
at once.

With `--sharded` it takes the second frame (orbit t = 0.25) of the same
demo through the sharded step on 2 rows x 4 volume shards of the card,
with the tile composite: it times each shard's B1 launch, proves every
ray beyond the limit a one-sample flip where it is one, and for each
other ray prints B1, the plain version and the per-ray twin in B1's
operation order (`ops.sweep.sweep_march_rays_plain`) around the plane
where B1 and the plain version first part; then it holds the B2 band
calls of that frame against their plain version, and both against the
plain version in f64.
"""

from __future__ import annotations

import argparse
import sys

import torch

from multivolumes_tpu_torch.tools import DEMO


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


def _march(side: str):
    """B1 ("kernel"), its plain version ("plain") or the per-ray twin in
    the kernel's operation order ("twin", `ops.sweep.
    sweep_march_rays_plain`), with `sweep_march`'s arguments."""
    from multivolumes_tpu_torch.ops import sweep as sweep_ops
    from multivolumes_tpu_torch.render import sweep as sweep_mod

    if side == "twin":
        return lambda *a, vol_zmax=None, **k: \
            sweep_ops.sweep_march_rays_plain(*a, **k)
    return lambda *a, **k: sweep_mod.sweep_march(*a, **k, impl=side)


def cut_rows(a, k, rays, m, sides=("kernel", "plain")):
    """Each ray (v, f, i, j) of `rays` with its window cut after its own
    plane m (a tensor, one plane a ray; -1: nothing), marched by each of
    `sides` (`_march`) on the launch's volumes that hold the rays ->
    (R, len(sides), 4): the rays' accumulated (r, g, b, a)."""
    from multivolumes_tpu_torch.render.sweep import SweepParams

    vols, light, tex, eye_f, params, smp, run, planes, size = a
    dev = eye_f.device
    vs = sorted({r[0] for r in rays})
    q = torch.tensor(vs, device=dev)
    at = {v: n for n, v in enumerate(vs)}
    qv = torch.tensor([at[r[0]] for r in rays], device=dev)
    f, i, j = (torch.tensor([r[c] for r in rays], device=dev)
               for c in (1, 2, 3))
    ew = eye_f[q[qv], f, 2]
    ew_c = ew.clamp(-1.0, 1.0)
    delta = (1.0 - ew_c) / planes
    inv_gz = 1.0 / (1.0 - ew).clamp(min=1e-6)
    s_m = (ew_c + (m.float() + 0.5) * delta - ew) * inv_gz
    s_end = params.s_end[q].clone()
    s_end[qv, f, i, j] = torch.minimum(s_end[qv, f, i, j], s_m + 1e-7)
    p = SweepParams(params.s_in[q], s_end, params.ray_len[q],
                    params.active[q])
    lrow = q if k.get("light_ids") is None else k["light_ids"][q]
    kw = dict(light_ids=lrow, vol_zmax=k.get("vol_zmax"),
              n_eff_b=None if k.get("n_eff_b") is None else k["n_eff_b"][q])
    out = torch.stack([_march(side)(
        vols, light, tex[q], eye_f[q], p, smp[q], run[q], planes, size,
        **kw)[qv, f, :, i, j] for side in sides], 1)
    return torch.where((m >= 0)[:, None, None], out, 0.0)


def one_sample_flips(a, k, rays, sides=("kernel", "plain")):
    """Whether the two `sides` (B1 and its plain version by default; see
    `_march`) part on each ray (v, f, i, j) of `rays` by one sample that
    one side composites and the other skips (a threshold flip): bisect,
    ray by ray, the plane m after which the two cut marches part
    (`cut_rows`; by more than 1e-4 after plane m, within it after plane
    m - 1), then require one side's accumulation to be unchanged across
    plane m (within 1e-6) while the other's alpha grows. Every ray's
    bisection step shares one march a side of the
    launch's volumes that hold the rays. -> [(m, the side that adds the
    sample; or None when the two do not part so, with m the plane where
    they first part, or P - 1 when they never do)], one per ray."""
    planes, dev = a[7], a[3].device

    def parted(rows):
        return (rows[:, 0] - rows[:, 1]).abs().amax(1) > 1e-4

    n = len(rays)
    if not n:
        return []
    lo = torch.full((n,), -1, device=dev)
    hi = torch.full((n,), planes - 1, device=dev)
    rows_lo, rows_hi = (cut_rows(a, k, rays, m, sides) for m in (lo, hi))
    parts = parted(rows_hi)
    while bool(((hi - lo > 1) & parts).any()):
        mid = (lo + hi) // 2
        rows = cut_rows(a, k, rays, mid, sides)
        go = (hi - lo > 1) & parts
        up = go & parted(rows)
        down = go & ~up
        hi, lo = torch.where(up, mid, hi), torch.where(down, mid, lo)
        rows_hi = torch.where(up[:, None, None], rows, rows_hi)
        rows_lo = torch.where(down[:, None, None], rows, rows_lo)
    grew = rows_hi - rows_lo                   # (R, 2, 4): the two sides
    still = grew.abs().amax(2) <= 1e-6         # (R, 2)
    out = []
    for r in range(n):
        side = None
        for s_, other in ((1, 0), (0, 1)):
            if bool(parts[r]) and bool(still[r, s_]) \
                    and float(grew[r, other, 3]) > 1e-4:
                side = sides[other]
        out.append((int(hi[r]), side))
    return out


def sharded_launches(device):
    """The B1 launches (one a volume shard) and the B2 band calls of the
    second frame (orbit t = 0.25) of the demo with `lod_bucket_caps=None`
    and the tile composite through the sharded step on 2 rows x 4 volume
    shards of one card, as `chip_smoke.py` drives it -> ([(args, kwargs)]
    of B1, [(args, kwargs)] of B2)."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.parallel import sharding
    from multivolumes_tpu_torch.render import sweep as sweep_mod
    from multivolumes_tpu_torch.render import tilecast as tile_mod

    cfg = RenderConfig(**DEMO).with_(lod_bucket_caps=None)
    engine = MultiRayCaster(cfg, device=device)
    mesh = sharding.make_mesh([device] * 8, rows=2)
    step = sharding.make_sharded_step(engine.config, mesh)
    state = sharding.shard_state(engine.state, mesh)
    _img, state = step(state, cam_lib.orbit_camera(
        0.0, cfg.aspect_ratio, device=device))
    calls = {"sweep_march": [], "tile_composite": []}
    saved = [(mod, name, getattr(mod, name)) for mod, name in
             ((sweep_mod, "sweep_march"), (tile_mod, "tile_composite"))]
    for mod, name, orig in saved:
        def record(*a, _orig=orig, _name=name, **k):
            calls[_name].append((a, {n: x for n, x in k.items()
                                     if n != "impl"}))
            return _orig(*a, **k)
        setattr(mod, name, record)
    try:
        step(state, cam_lib.orbit_camera(0.25, cfg.aspect_ratio,
                                         device=device))
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return calls["sweep_march"], calls["tile_composite"]


def _rays(bad):
    return sorted({tuple(x[:2] + x[3:]) for x in bad.nonzero().tolist()})


def explain_sweep(a, k, what: str, show: int):
    """Every ray of one B1 launch beyond atol 2e-3 + rtol 2e-2 of the
    plain version: the one-sample-flip proof against the plain version;
    for each ray where it fails, the three marches (B1, the plain
    version, the per-ray twin in B1's operation order) around the plane
    where B1 and the plain version first part by 1e-4, and the proof of
    B1 against the twin and of the plain version against the twin; the
    same launch with f32 stacks, its rays proven as well."""
    got, want = (_march(s)(*a, **k) for s in ("kernel", "plain"))
    rays = _rays(_beyond(got, want))
    proofs = one_sample_flips(a, k, rays)
    odd = [(r, m) for r, (m, side) in zip(rays, proofs) if side is None]
    print(f"{what}: {len(rays)} rays beyond, {len(rays) - len(odd)} first "
          f"part from the plain version by a one-sample flip, {len(odd)} "
          f"not")
    if odd:
        dev = a[3].device
        rs = [r for r, _m in odd]
        m = torch.tensor([m for _r, m in odd], device=dev)
        sides = ("kernel", "plain", "twin")
        at, before = (cut_rows(a, k, rs, x, sides) for x in (m, m - 1))
        twin = one_sample_flips(a, k, rs, sides=("kernel", "twin"))
        plain = one_sample_flips(a, k, rs, sides=("plain", "twin"))
        n_twin = sum(1 for (mt, st) in twin if st is not None
                     or mt == a[7] - 1)
        print(f"  B1 against the twin: {n_twin} of {len(rs)} rays part by "
              f"no more than 1e-4 or first by a one-sample flip")
        for n, (r, mm) in enumerate(odd[:show]):
            grew = at[n] - before[n]                          # (3, 4)
            print(f"  ray {r}: first 1e-4 parting at plane {mm}; a, r "
                  f"gained there: " + ", ".join(
                      f"{s} {float(grew[c, 3]):.6f} {float(grew[c, 0]):.6f}"
                      for c, s in enumerate(sides))
                  + f"; accumulated: " + ", ".join(
                      f"{s} {float(at[n, c, 3]):.6f} {float(at[n, c, 0]):.6f}"
                      for c, s in enumerate(sides))
                  + f"; B1 vs twin {twin[n]}, plain vs twin {plain[n]}")
    a32 = (a[0].float(), a[1].float()) + tuple(a[2:])
    got32, want32 = (_march(s)(*a32, **k) for s in ("kernel", "plain"))
    bad32 = _beyond(got32, want32)
    rays32 = _rays(bad32)
    proofs32 = one_sample_flips(a32, k, rays32)
    print(f"  f32 stacks: {int(bad32.sum())} elements beyond on "
          f"{len(rays32)} rays: " + "; ".join(
              f"{r} plane {m} {side}" for r, (m, side) in
              zip(rays32[:20], proofs32)))


def explain_band(a, k, show: int):
    """The B2 band on the unsorted f32 maps against its plain version,
    with the plain version in f64 as the judge: the elements beyond
    1e-4 + 1e-4 rel, each with the f64 value; how far each f32 form is
    from f64; and the same launch on the maps rounded to bf16."""
    from multivolumes_tpu_torch.ops.composite import (tile_composite,
                                                      tile_composite_plain)

    got, want = (tile_composite(*a, **k, impl=i) for i in ("kernel", "plain"))
    a64 = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                else x for x in a)
    ref = tile_composite_plain(*a64, **k).float()
    beyond = (got - want).abs() > 1e-4 + 1e-4 * want.abs()
    print(f"B2 band ({tuple(a[0].shape)} {a[0].dtype}, tile_row0 "
          f"{k.get('tile_row0')}): {int(beyond.sum())} elements beyond, max "
          f"{float((got - want).abs().max()):.3e}; from f64: kernel max "
          f"{float((got - ref).abs().max()):.3e}, plain max "
          f"{float((want - ref).abs().max()):.3e}; beyond 1e-4 + 1e-4 rel "
          f"of f64: kernel "
          f"{int(((got - ref).abs() > 1e-4 + 1e-4 * ref.abs()).sum())}, "
          f"plain "
          f"{int(((want - ref).abs() > 1e-4 + 1e-4 * ref.abs()).sum())}")
    th, tw, tiles_x = a[6], a[7], a[8]
    for c, y, x in beyond.nonzero().tolist()[:show]:
        t = (y // th) * tiles_x + x // tw
        print(f"  ({c}, {y}, {x}): kernel {float(got[c, y, x]):.6f} plain "
              f"{float(want[c, y, x]):.6f} f64 {float(ref[c, y, x]):.6f}; "
              f"{int(a[3][t])} volumes on the tile")
    a16 = (a[0].bfloat16(),) + tuple(a[1:])
    g16, w16 = (tile_composite(*a16, **k, impl=i) for i in ("kernel",
                                                            "plain"))
    print(f"  on the maps rounded to bf16: "
          f"{int(((g16 - w16).abs() > 1e-4 + 1e-4 * w16.abs()).sum())} "
          f"elements beyond, max {float((g16 - w16).abs().max()):.3e}")


def time_sweeps(marches, reps: int = 20):
    """Mean time of each B1 launch of `marches` by CUDA events over
    `reps` launches, after one."""
    out = []
    for a, k in marches:
        _march("kernel")(*a, **k)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            _march("kernel")(*a, **k)
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    print("B1 ms a launch, by volume shard (CUDA events, mean of "
          f"{reps}): " + " ".join(f"{t:.4f}" for t in out))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rays", type=int, default=3)
    p.add_argument("--bucketed", action="store_true")
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--time-only", action="store_true",
                   help="with --sharded: time the B1 launches, no proofs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_outliers: needs a CUDA device", file=sys.stderr)
        return 2
    from multivolumes_tpu_torch.render import sweep as sweep_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.sharded:
        marches, bands = sharded_launches(dev)
        time_sweeps(marches)
        if args.time_only:
            return 0
        for d, (a, k) in enumerate(marches):
            explain_sweep(a, k, f"B1 volume shard {d}", args.rays)
        for a, k in bands[-2:]:
            explain_band(a, k, args.rays)
        return 0
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
