"""Time edited copies of the hand kernels against the sources as they are,
on the card: the measurements behind the design decisions recorded in
`PERF.md` (which path a launch takes, how often the early-exit vote runs,
when the light is staged, what the attenuation and the ring depth cost,
where the advect's product is formed, the composite's register bound and
divisions, the TAA resolve's tile and thread shape, the raster eval's
pixels per thread and its exact shortcuts).

    python -m multivolumes_tpu_torch.tools.kernel_variants
    python -m multivolumes_tpu_torch.tools.kernel_variants \\
        --old-lightsweep old_lightsweep.cu     # e.g. from `git show`
    python -m multivolumes_tpu_torch.tools.kernel_variants \\
        --only composite advect --old-composite old_composite.cu \\
        --mesh mesh.obj
    python -m multivolumes_tpu_torch.tools.kernel_variants \\
        --only taa raster --old-taa old_taa.cu --old-raster-bin old_rb.cu \\
        --sass

Each variant is the committed source with a few exact text replacements
(`SWEEP_VARIANTS`, `SCAN_VARIANTS`, `ADVECT_VARIANTS`,
`COMPOSITE_VARIANTS`, `TAA_VARIANTS`, `RASTER_VARIANTS`), compiled by its
own `nvcc` into its own library under `build/torch_ext/variants/` and
called through the ordinary wrapper, so a variant times exactly what the
frame would run. A replacement whose text is no longer in the source
raises (the CPU test `tests/test_torch_kernel_variants.py` holds the lists
against the sources). Times are device times of the kernels a call
launches, from the profiler's kernel events, on the operands of one
demo-scale frame (B1: its three LOD buckets, `--f32` adds the
full-resolution bucket on f32 stacks; B2: the frame's composite, and with
`--mesh` the depth variant on a frame with that mesh; B5: the third
frame's resolve, with and without the display image), on seeded
operands (B5 at 1280x800 with the display image, B5' on the lower
400-row band of it, B6 at the raster microbench's 600 chunks) and on
seeded cohorts of 1, 8 and 64 volumes of 96^3 (B3, B3', B4). With
`--old-lightsweep` / `--old-composite` / `--old-taa` / `--old-raster-bin`,
an earlier source with the same C entry points (an earlier `composite.cu`
takes no scratch for the mesh vote: its entry point is called without it)
is timed beside the current one and its outputs are compared bit for bit.
With `--sass`, each B5 and B6 library's machine code (`cuobjdump -sass`)
is counted: the instructions of each kernel, and for B6 those of its
candidate loop per (pixel, candidate) pair.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from multivolumes_tpu_torch.ops import build
from multivolumes_tpu_torch.ops import lightsweep as light_ops
from multivolumes_tpu_torch.ops import sweep as sweep_ops

_STAGES = "  return is_bf16 && kTile * n + 2 * S <= kVolRows * S"
_LIGHT_NEXT = "    const bool light_next = stage_next && any_prev;"
_EXIT = "constexpr int kExitEvery = 8;"
# name -> [(text in csrc/sweep.cu, its replacement), ...]
SWEEP_VARIANTS = {
    "as it is": [],
    # every launch marches by the direct fetch (no slab staging)
    "no staging": [(_STAGES, "  return false && kTile * n + 2 * S"
                             " <= kVolRows * S")],
    # f32 stacks staged too (they march by the direct fetch as it is)
    "f32 staged too": [
        (_STAGES, "  return kTile * n + 2 * S <= kVolRows * S"),
        ("    err = MV_SWEEP_LAUNCH(__nv_bfloat16, true);",
         "    err = is_bf16 ? MV_SWEEP_LAUNCH(__nv_bfloat16, true)\n"
         "                  : MV_SWEEP_LAUNCH(float, true);")],
    # the light staged with every staged plane, or never
    "light always staged": [(_LIGHT_NEXT,
                             "    const bool light_next = stage_next;")],
    "light never staged": [(_LIGHT_NEXT,
                            "    const bool light_next = false;")],
    # the early-exit vote (and the tap tables) every 4 planes, or no vote
    "vote every 4 planes": [(_EXIT, "constexpr int kExitEvery = 4;")],
    "no exit vote": [("          face_done = *reinterpret_cast<volatile int*>"
                      "(done + b) == S * S;", "          face_done = 0;")],
    # no register bound on the bf16 instantiations
    "no register bound": [("sizeof(T) == 2 ? 4 : 1", "1")],
}
_ATTEN = "        slot[(ar0 + u * rpp) * l + d] = atten_of(x[u], f);"
# name -> [(text in csrc/lightsweep.cu, its replacement), ...]
SCAN_VARIANTS = {
    "as it is": [],
    # the attenuation replaced by one multiply (a wrong result: what the
    # special-function work still costs between arrive and wait)
    "attenuation as a multiply": [
        (_ATTEN, "        slot[(ar0 + u * rpp) * l + d] = x[u] * f;")],
    "ring of 8 slices": [("constexpr int kRing = 4;",
                          "constexpr int kRing = 8;")],
    # here_k stored from the threads, no bulk copies
    "direct stores": [("(int)(kMode != kAdvect && l % 4 == 0));", "0);")],
    "2 rows in flight": [("constexpr int kUnroll = 4;",
                          "constexpr int kUnroll = 2;")],
}
# name -> [(text in csrc/lightsweep.cu, its replacement), ...], timed on B4
ADVECT_VARIANTS = {
    "as it is": [],
    # the product formed and stored inside the chain, before the arrive
    "product on the chain": [
        ("            nxt[i] = sh;\n          } else {",
         "            nxt[i] = sh;\n            out_k[i] = sh * a_k[i];\n"
         "          } else {"),
        ("        out_k[i] = nxt[i] * a_k[i];\n", "")],
    "ring of 8 slices": SCAN_VARIANTS["ring of 8 slices"],
}
_BOUND = "constexpr int kMinCtas = 3;"
_SLAB = ("  float ds = safe(d);\n"
         "  float t1 = (-1.0f - o) / ds, t2 = (1.0f - o) / ds;")
# name -> [(text in csrc/composite.cu, its replacement), ...]
COMPOSITE_VARIANTS = {
    "as it is": [],
    # the register bound: CTAs an SM must hold (1: no bound)
    "no register bound": [(_BOUND, "constexpr int kMinCtas = 1;")],
    "2 CTAs an SM": [(_BOUND, "constexpr int kMinCtas = 2;")],
    "4 CTAs an SM": [(_BOUND, "constexpr int kMinCtas = 4;")],
    # one reciprocal per axis in place of two divisions (rounds otherwise:
    # the tool counts the pixels that move)
    "reciprocal slab": [(_SLAB, "  float r = 1.0f / safe(d);\n"
                                "  float t1 = (-1.0f - o) * r, t2 = (1.0f - o)"
                                " * r;")],
    # the per-pair loop reads the records from device memory (the L1)
    "records from device memory": [
        ("      const float* vf = rec + e * kRecF;",
         "      const float* vf = vol_flt + (size_t)list[i0 + e] * kVolF;"),
        ("      const float* fq = vf + kVolF + face * 9;",
         "      const float* fq = face_flt + ((size_t)vid * 6 + face) * 9;")],
    "chunks of 16 volumes": [("constexpr int kChunk = 32;",
                              "constexpr int kChunk = 16;")],
    # the face colours not read (a wrong result: what the texel gathers
    # cost, the most a shared-memory cache of the faces could save)
    "no colour gathers": [("  const size_t pl = (size_t)t.s * t.s;\n",
                           "  if (t.s > 0)\n    return make_float4(t.w0, "
                           "t.w1, 0.5f * t.w0, 0.25f);\n"
                           "  const size_t pl = (size_t)t.s * t.s;\n")],
}
_NMIN = ('  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));')
_NMAX = ('  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));')
TAA_VARIANTS = {
    "as it is": [],
    # one tile a CTA, so nothing is loaded while a tile is resolved
    "a CTA a tile": [("  return std::min(n_tiles, resident_ctas<kBand>());",
                      "  return n_tiles;")],
    "tiles of 32 x 16": [("constexpr int kTileH = 8;",
                          "constexpr int kTileH = 16;")],
    # the register bound: CTAs an SM must hold
    "4 CTAs an SM": [("constexpr int kMinCtas = 1;",
                      "constexpr int kMinCtas = 4;")],
    "6 CTAs an SM": [("constexpr int kMinCtas = 1;",
                      "constexpr int kMinCtas = 6;")],
    "8 CTAs an SM": [("constexpr int kMinCtas = 1;",
                      "constexpr int kMinCtas = 8;")],
    # 1 / x, 4 / x, 0.25 / x as PyTorch forms them, x.reciprocal() * num
    # (the same values)
    "reciprocals": [("  return div(num, x);",
                     "  return mul(__frcp_rn(x), num);")],
    # min and max by NaN tests and a compare (the earlier source's form)
    "NaN tests": [
        (_NMIN, "  r = (a != a || b != b) ? __int_as_float(0x7fffffff) : "
                "(a < b ? a : b);"),
        (_NMAX, "  r = (a != a || b != b) ? __int_as_float(0x7fffffff) : "
                "(a > b ? a : b);")],
}
_PACK = "(int)(kNarrow ? zq * 131072u + tid : (zq << 17) | tid);"
_ZQ = ("        const unsigned zq =\n"
       "            __float_as_uint(__fadd_rz(mul(z, 32767.0f), 8388608.0f));")
# name -> [(text in csrc/raster_bin.cu, its replacement), ...], timed on B6
RASTER_VARIANTS = {
    "as it is": [],
    # how the work is cut: pixels a thread, CTAs a chunk (the tail: 600
    # chunks on 132 SMs), thread groups a candidate list is split over
    "8 pixels a thread": [("constexpr int kPy = 4;",
                           "constexpr int kPy = 2;")],
    "8 pixels a thread, one CTA a chunk": [
        ("constexpr int kPy = 4;", "constexpr int kPy = 2;"),
        ("constexpr int kCtaRows = 4;", "constexpr int kCtaRows = 8;")],
    "one CTA a chunk": [("constexpr int kCtaRows = 4;",
                         "constexpr int kCtaRows = 8;")],
    "8 x 2 pixels, four CTAs a chunk": [
        ("constexpr int kPx = 4;", "constexpr int kPx = 8;"),
        ("constexpr int kPy = 4;", "constexpr int kPy = 2;"),
        ("constexpr int kCtaRows = 4;", "constexpr int kCtaRows = 2;")],
    "one group": [("constexpr int kSplit = 2;", "constexpr int kSplit = 1;")],
    "four groups": [("constexpr int kSplit = 2;",
                     "constexpr int kSplit = 4;")],
    "unroll 2": [("#pragma unroll 4\n", "#pragma unroll 2\n")],
    "no unroll": [("#pragma unroll 4\n", "#pragma unroll 1\n")],
    # what each exact shortcut saves: the shift-and-or pack for every
    # chunk, the plain version's c0, and its clamp-and-convert quantisation
    "shift-and-or pack": [(_PACK, "(int)((zq << 17) | tid);")],
    "c0 formed": [("__fsub_rn(1.0f, c1) >= c2",
                   "__fsub_rn(__fsub_rn(1.0f, c1), c2) >= 0.0f")],
    "clamp and convert": [(_ZQ, (
        "        const unsigned zq = (unsigned)(int)fminf(\n"
        "            fmaxf(mul(z, 32767.0f), 0.0f), 32767.0f);"))],
}
DEMO = dict(width=1280, height=800, grid_size=128, light_grid_size=96,
            max_ray_samples=256, max_light_samples=96, num_volumes=64,
            num_volume_srcs=10, cube_map_size=128)


def apply_edits(source: str, edits) -> str:
    """`source` with every (old, new) applied; raises when an old text is
    missing or not unique."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"{source.count(old)} occurrences of {old!r}")
        source = source.replace(old, new)
    return source


# an earlier composite.cu's entry point: no scratch for the mesh vote
_OLD_COMPOSITE = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 \
    + [ctypes.c_void_p]


def build_variants(stem: str, variants, entry_points, extra=()):
    """Compile csrc/<stem>.cu under each variant's edits (and the sources
    in `extra`: name -> path) into a library each, all nvcc at once
    -> {name: ctypes library with the entry points typed}."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (build.CSRC / f"{stem}.cu").read_text()
    jobs = []
    texts = {name: apply_edits(source, edits)
             for name, edits in variants.items()}
    texts.update({name: open(path).read() for name, path in extra})
    for i, (name, text) in enumerate(texts.items()):
        src = out_dir / f"{stem}_{i}.cu"
        src.write_text(text)
        lib = out_dir / f"{stem}_{i}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
               "-shared", str(src), "-o", str(lib)]
        jobs.append((name, lib, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, lib, cmd, proc in jobs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{err}")
        cdll = ctypes.CDLL(str(lib))
        for fn in entry_points:
            getattr(cdll, fn).argtypes = build.SIGNATURES[fn]
            getattr(cdll, fn).restype = ctypes.c_int
        if stem == "composite" and "void* flags" not in texts[name]:
            # an earlier source: called with the current arguments, less
            # the vote's scratch (the 8th)
            old = cdll.mv_tile_composite
            old.argtypes = _OLD_COMPOSITE
            cdll.mv_tile_composite = lambda *a, _old=old: _old(*a[:7],
                                                              *a[8:])
        libs[name] = cdll
    return libs


class _Library:
    """The loaded kernel library with some entry points taken from a
    variant's library."""

    def __init__(self, base, variant, entry_points):
        self._base, self._variant = base, variant
        self._entry_points = entry_points

    def __getattr__(self, name):
        return getattr(self._variant if name in self._entry_points
                       else self._base, name)


def device_ms(fn, kernel, reps: int) -> float:
    """Device time per fn() of the kernels whose name contains `kernel`
    (a name or a tuple of names, each launched once a call), the median
    over `reps` calls (a profile now and then records no kernel: tried
    again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = (kernel,) if isinstance(kernel, str) else kernel
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA \
                    and any(k in e.name for k in names):
                per.setdefault(e.name, []).append(
                    e.time_range.elapsed_us() / 1e3)
        if per:
            # each name's median: a profile may drop or clip an event now
            # and then
            return sum(sorted(t)[len(t) // 2] for t in per.values())
    raise RuntimeError(f"the profiler recorded no {kernel} kernel")


def time_variants(what, fn, libs, entry_points, kernel, reps, rounds=2):
    """Print, per round, each variant's device time of fn() and the
    largest difference of its outputs from the first variant's."""
    cached = build.library
    base = cached()
    ref = None
    for rnd in range(rounds):
        cells = []
        for name, lib in libs.items():
            build.library = lambda lib=lib: _Library(base, lib, entry_points)
            try:
                got = fn()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                if ref is None:
                    ref = got
                diff = max(float((g - r).abs().max())
                           for g, r in zip(got, ref))
                moved = sum(int(((g - r).abs() > 1e-4).sum())
                            for g, r in zip(got, ref))
                same = all(torch.equal(g, r) for g, r in zip(got, ref))
                ms = device_ms(fn, kernel, reps)
            finally:
                build.library = cached
            cells.append(f"{name} {ms:.4f}" + (
                "" if same else f" (differs by {diff:.1e}, {moved} "
                                f"elements by more than 1e-4)"))
        print(f"{what}, round {rnd + 1}, device ms: " + "; ".join(cells),
              flush=True)


def frame_calls(device, mesh=None):
    """The B1 and B2 calls of one demo-scale frame (with `mesh`, an OBJ
    file, set on the engine): {"sweep": [(args, kwargs), ...],
    "composite": [...]}."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod
    from multivolumes_tpu_torch.render import tilecast as tile_mod

    cfg = RenderConfig(**DEMO)
    engine = MultiRayCaster(cfg, device=device)
    if mesh is not None:
        engine.set_mesh(mesh)
        engine.select_raster_preset((0.0, 6.0, 60.0))
    calls = {"sweep": [], "composite": []}
    spied = [(sweep_mod, "sweep_march", "sweep"),
             (tile_mod, "tile_composite", "composite")]
    origs = [getattr(mod, fn) for mod, fn, _key in spied]
    for (mod, fn, key), orig in zip(spied, origs):
        def spy(*a, _orig=orig, _key=key, **k):
            calls[_key].append((a, {n: v for n, v in k.items()
                                    if n != "impl"}))
            return _orig(*a, **k)
        setattr(mod, fn, spy)
    try:
        frame_lib.render_frame(
            engine.state, cam_lib.orbit_camera(0.0, cfg.aspect_ratio,
                                               device=device), engine.config)
    finally:
        for (mod, fn, _key), orig in zip(spied, origs):
            setattr(mod, fn, orig)
    torch.cuda.synchronize()
    return calls


def scan_case(device, c: int, l: int, seed: int = 0):
    """Seeded operands of a self scan: a density with empty texels, shifts
    up to 2.6 texels, and a shadow plane with a penumbra."""
    rng = np.random.RandomState(seed)
    rho = rng.rand(c, l, l, l) * (rng.rand(c, l, l, l) < 0.6)
    dz = rng.uniform(2e-4, 1e-3, c) * np.where(rng.rand(c) < 0.5, -1, 1)
    arrs = (rho, rng.uniform(-2.6, 2.6, c), rng.uniform(-2.6, 2.6, c),
            rng.uniform(0.3, 2.0, c), 0.4 + 0.05 * rng.rand(c, l, l),
            0.4 + 0.05 * rng.rand(c, l, l), dz, np.maximum(np.abs(dz), 1e-6))
    ts = tuple(torch.tensor(a, dtype=torch.float32, device=device)
               for a in arrs)
    return ts[:4], ts[4:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", default=list(SECTIONS),
                    choices=list(SECTIONS), help="the kernels to time")
    ap.add_argument("--old-lightsweep", help="an earlier lightsweep.cu to "
                    "time and compare bit for bit (B3, B4)")
    ap.add_argument("--old-composite", help="an earlier composite.cu to "
                    "time and compare bit for bit (B2)")
    ap.add_argument("--old-taa", help="an earlier taa.cu to time and "
                    "compare bit for bit (B5, B5')")
    ap.add_argument("--old-raster-bin", help="an earlier raster_bin.cu to "
                    "time and compare bit for bit (B6)")
    ap.add_argument("--mesh", help="an OBJ mesh: also time the composite's "
                    "depth variant on a frame with it")
    ap.add_argument("--sass", action="store_true",
                    help="count the B5 and B6 libraries' instructions "
                    "(cuobjdump -sass)")
    ap.add_argument("--f32", action="store_true",
                    help="also the full-resolution bucket on f32 stacks")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    build.library()
    for name in args.only:
        SECTIONS[name](args, device)
    return 0


def time_sweep(args, device):
    entry = ("mv_sweep_march",)
    libs = build_variants("sweep", SWEEP_VARIANTS, entry)
    for a, k in frame_calls(device)["sweep"]:
        dtypes = [a[0].dtype] + ([torch.float32] if args.f32
                                 and a[8] == DEMO["cube_map_size"] else [])
        for dtype in dtypes:
            a2 = (a[0].to(dtype), a[1].to(dtype)) + tuple(a[2:])
            time_variants(
                f"B1 {a[2].shape[0]} volumes @ S={a[8]} {dtype}",
                lambda: sweep_ops.sweep_march(*a2, **k, impl="kernel"),
                libs, entry, "sweep_kernel", args.reps)


def _extra(path):
    return [("old source", path)] if path else []


def time_scan(args, device):
    entry = ("mv_light_self_scan", "mv_light_self_scan_sm")
    libs = build_variants("lightsweep", SCAN_VARIANTS, entry,
                          _extra(args.old_lightsweep))
    for c in (1, 8, 64):
        for has_sm in (False, True):
            ops_in, sm = scan_case(device, c, 96)
            more = sm if has_sm else ()
            time_variants(
                f"B3{chr(39) if has_sm else ''} C={c} L=96",
                lambda: light_ops.light_self_scan(*ops_in, *more,
                                                  impl="kernel"),
                libs, entry, "self_scan_kernel", args.reps)
            floor = device_ms(
                lambda: light_ops.scan_chain_floor(c, 96, has_sm, device),
                "self_scan_kernel", args.reps)
            print(f"  its chain floor (empty body, 96 barriers): "
                  f"{floor:.4f} ms", flush=True)


def time_advect(args, device):
    entry = ("mv_light_advect_mul",)
    libs = build_variants("lightsweep", ADVECT_VARIANTS, entry,
                          _extra(args.old_lightsweep))
    for c in (1, 8, 64):
        (rho, du, dv, f), _sm = scan_case(device, c, 96)
        here, _ = light_ops.light_self_scan(rho, du, dv, f, impl="kernel")
        t_in = 0.2 + 0.8 * torch.rand((c, 96, 96), generator=torch.Generator(
            device=device).manual_seed(c), device=device)
        time_variants(
            f"B4 C={c} L=96",
            lambda: light_ops.light_advect_mul(here, t_in, du, dv,
                                               impl="kernel"),
            libs, entry, ("self_scan_kernel", "advect_mul_kernel"),
            args.reps)
        floor = device_ms(
            lambda: light_ops.scan_chain_floor(c, 96, False, device,
                                               advect=True),
            "self_scan_kernel", args.reps)
        print(f"  its chain floor (empty body, 96 barriers): {floor:.4f} ms",
              flush=True)


def time_composite(args, device):
    from multivolumes_tpu_torch.ops import composite as composite_ops

    entry = ("mv_tile_composite",)
    libs = build_variants("composite", COMPOSITE_VARIANTS, entry,
                          _extra(args.old_composite))
    cases = [("B2", frame_calls(device)["composite"][0])]
    if args.mesh:
        cases.append(("B2'", frame_calls(device, args.mesh)["composite"][0]))
    for what, (a, k) in cases:
        time_variants(
            f"{what} 1280x800",
            lambda: composite_ops.tile_composite(*a, **k, impl="kernel"),
            libs, entry, ("tile_composite_kernel", "mesh_tile_kernel"),
            args.reps)


def taa_frame_operands(device):
    """B5's operands in the third demo-scale frame (the history is no
    longer zero there): (cur, hist, blur)."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import taa as taa_ops
    from multivolumes_tpu_torch.render import frame as frame_lib

    cfg = RenderConfig(**DEMO)
    calls = []
    orig = taa_ops.taa_resolve

    def spy(*a, **k):
        calls.append(a[:3])
        return orig(*a, **k)

    taa_ops.taa_resolve = spy
    try:
        engine = MultiRayCaster(cfg, device=device)
        state, config = engine.state, engine.config
        for i in range(3):
            state = frame_lib.render_frame(
                state, cam_lib.orbit_camera(0.25 * i, cfg.aspect_ratio,
                                            device=device), config).state
    finally:
        taa_ops.taa_resolve = orig
    torch.cuda.synchronize()
    return tuple(x.clone() for x in calls[-1])


def taa_synthetic(device, h=800, w=1280, seed=0):
    """Seeded B5 operands, independent per pixel (so a wrong halo or edge
    clamp changes the output): half the alpha at 1, a random history with
    some full counts, a non-zero blur on half the pixels."""
    rng = np.random.RandomState(seed)
    cur = rng.rand(4, h, w).astype(np.float32) * 2.0
    cur[3] = np.where(rng.rand(h, w) < 0.5, 1.0, 0.5)
    hist = rng.rand(4, h, w).astype(np.float32)
    hist[3] = np.where(rng.rand(h, w) < 0.3, 1.0, hist[3])
    blur = np.where(rng.rand(h, w) < 0.5, 0.0, rng.rand(h, w) * 1.5)
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (cur, hist, blur))


def band_operands(cur, hist, blur, y0, y1):
    """B5' operands of rows y0..y1 of a whole image: the band with the row
    above and the row below it (the replicated edge row at the image's
    edge, as `collectives.halo_rows` builds them), its history and blur."""
    h = cur.shape[1]
    above, below = max(y0 - 1, 0), min(y1, h - 1)
    cur_halo = torch.cat([cur[:, above:above + 1], cur[:, y0:y1],
                          cur[:, below:below + 1]], 1)
    return (cur_halo.contiguous(), hist[:, y0:y1].contiguous(),
            blur[y0:y1].contiguous())


def time_taa(args, device):
    from multivolumes_tpu_torch.ops import taa as taa_ops

    entry = ("mv_taa_resolve", "mv_taa_resolve_band")
    libs = build_variants("taa", TAA_VARIANTS, entry, _extra(args.old_taa))
    frame = taa_frame_operands(device)
    synth = taa_synthetic(device)
    band = band_operands(*synth, 400, 800)
    cases = [("B5 frame 3", lambda: taa_ops.taa_resolve(*frame,
                                                         impl="kernel")),
             ("B5 frame 3 + display image",
              lambda: taa_ops.taa_resolve(*frame, tonemap=True,
                                          impl="kernel")),
             ("B5 synthetic + display image",
              lambda: taa_ops.taa_resolve(*synth, tonemap=True,
                                          impl="kernel")),
             ("B5' 400-row band", lambda: taa_ops.taa_resolve_band(
                 *band, impl="kernel"))]
    for what, fn in cases:
        time_variants(what, fn, libs, entry, "taa_resolve_kernel", args.reps)
    if args.sass:
        sass_counts(libs, "taa_resolve_kernel")


def time_raster(args, device):
    from multivolumes_tpu_torch.ops import raster_bin
    from multivolumes_tpu_torch.tools.raster_bin_microbench import \
        eval_inputs

    entry = ("mv_raster_bin_eval",)
    libs = build_variants("raster_bin", RASTER_VARIANTS, entry,
                          _extra(args.old_raster_bin))
    operands = eval_inputs(600, 150, device)
    time_variants("B6 600 chunks",
                  lambda: raster_bin.raster_bin_eval(*operands, 150,
                                                     impl="kernel"),
                  libs, entry, "raster_bin_eval_kernel", args.reps)
    if args.sass:
        sass_counts(libs, "raster_bin_eval_kernel", per_pair=True)


def sass_counts(libs, kernel, per_pair=False):
    """Print, for each variant's library, the instructions of each
    function whose name contains `kernel` (`cuobjdump -sass`) and of each
    of its loops (a backward branch: the instructions from its target to
    it); with `per_pair`, a loop's instructions per (pixel, candidate)
    pair, each pair quantising its depth with one FADD.RZ (a variant
    that converts instead shows its loop's length only)."""
    import re
    from pathlib import Path

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    for name, lib in libs.items():
        text = subprocess.run([str(tool), "-sass", lib._name],
                              capture_output=True, text=True,
                              check=True).stdout
        for fn in re.split(r"\n\s*Function : ", text)[1:]:
            fname = fn.split("\n", 1)[0].strip()
            if kernel not in fname:
                continue
            insts, labels = [], {}
            for line in fn.splitlines():
                m = re.match(r"\s*(\.L_x_\d+):", line)
                if m:
                    labels[m.group(1)] = len(insts)
                m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
                if m:
                    insts.append(m.group(2))
            loops = []
            for i, ins in enumerate(insts):
                m = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                              ins)
                if m is None:
                    continue
                tgt = (labels.get(m.group(1), i) if m.group(1)
                       else int(m.group(2), 16) // 16)
                if tgt < i:
                    loops.append(insts[tgt:i + 1])
            line = f"  [sass] {name}: {fname[:60]}: {len(insts)} instructions"
            for body in loops:
                line += f"; a loop of {len(body)}"
                pairs = sum("FADD.RZ" in ins for ins in body)
                if per_pair and pairs:
                    line += (f" with {pairs} pairs: {len(body) / pairs:.2f} "
                             f"instructions a pair")
            print(line, flush=True)


SECTIONS = {"sweep": time_sweep, "scan": time_scan, "advect": time_advect,
            "composite": time_composite, "taa": time_taa,
            "raster": time_raster}


if __name__ == "__main__":
    sys.exit(main())
