"""Time edited copies of the B1 and B3 kernels against the sources as they
are, on the card: the measurements behind the design decisions recorded
in `PERF.md` (which path a launch takes, how often the early-exit vote
runs, when the light is staged, what the attenuation and the ring depth
cost).

    python -m multivolumes_tpu_torch.tools.kernel_variants
    python -m multivolumes_tpu_torch.tools.kernel_variants \\
        --old-lightsweep old_lightsweep.cu     # e.g. from `git show`

Each variant is the committed source with a few exact text replacements
(`SWEEP_VARIANTS`, `SCAN_VARIANTS`), compiled by its own `nvcc` into its
own library under `build/torch_ext/variants/` and called through the
ordinary wrapper, so a variant times exactly what the frame would run. A
replacement whose text is no longer in the source raises (the CPU test
`tests/test_torch_kernel_variants.py` holds the lists against the
sources). Times are device times of the kernel alone, from the
profiler's kernel events, on the operands of one demo-scale frame (B1:
its three LOD buckets; `--f32` adds the full-resolution bucket on f32
stacks) and on seeded cohorts of 1, 8 and 64 volumes of 96^3 (B3, B3').
With `--old-lightsweep`, an earlier `lightsweep.cu` with the same C entry
points is timed beside the current one and its outputs are compared bit
for bit.
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
    "direct stores": [("(int)(l % 4 == 0));", "0);")],
    "2 rows in flight": [("constexpr int kUnroll = 4;",
                          "constexpr int kUnroll = 2;")],
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


def device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time of the kernels named `kernel` over `reps` fn()
    (a profile now and then records no kernel: tried again)."""
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
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if times:
            return sum(times) / len(times)
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
                same = all(torch.equal(g, r) for g, r in zip(got, ref))
                ms = device_ms(fn, kernel, reps)
            finally:
                build.library = cached
            cells.append(f"{name} {ms:.4f}"
                         + ("" if same else f" (differs by {diff:.1e})"))
        print(f"{what}, round {rnd + 1}, device ms: " + "; ".join(cells),
              flush=True)


def sweep_calls(device):
    """The B1 calls of one demo-scale frame: [(args, kwargs), ...]."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod

    cfg = RenderConfig(**DEMO)
    engine = MultiRayCaster(cfg, device=device)
    calls, orig = [], sweep_mod.sweep_march

    def spy(*a, **k):
        calls.append((a, {n: v for n, v in k.items() if n != "impl"}))
        return orig(*a, **k)

    sweep_mod.sweep_march = spy
    try:
        frame_lib.render_frame(
            engine.state, cam_lib.orbit_camera(0.0, cfg.aspect_ratio,
                                               device=device), engine.config)
    finally:
        sweep_mod.sweep_march = orig
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
    ap.add_argument("--old-lightsweep", help="an earlier lightsweep.cu to "
                    "time and compare bit for bit")
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

    entry = ("mv_sweep_march",)
    libs = build_variants("sweep", SWEEP_VARIANTS, entry)
    for a, k in sweep_calls(device):
        dtypes = [a[0].dtype] + ([torch.float32] if args.f32
                                 and a[8] == DEMO["cube_map_size"] else [])
        for dtype in dtypes:
            a2 = (a[0].to(dtype), a[1].to(dtype)) + tuple(a[2:])
            time_variants(
                f"B1 {a[2].shape[0]} volumes @ S={a[8]} {dtype}",
                lambda: sweep_ops.sweep_march(*a2, **k, impl="kernel"),
                libs, entry, "sweep_kernel", args.reps)

    entry = ("mv_light_self_scan", "mv_light_self_scan_sm")
    extra = ([("old source", args.old_lightsweep)]
             if args.old_lightsweep else [])
    libs = build_variants("lightsweep", SCAN_VARIANTS, entry, extra)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
