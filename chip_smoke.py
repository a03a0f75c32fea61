#!/usr/bin/env python3
"""Drive the PyTorch port (`multivolumes_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card
    python3 chip_smoke.py --profile-reference   # phase 10 alone, profiled
    python3 chip_smoke.py --profile-sharded-settings   # phase 11 alone,
                                                       # every setting profiled
    python3 chip_smoke.py --mesh-shade   # phases 1, 2 and B8's rows alone
    python3 chip_smoke.py --raster   # phases 1, 2 and B9's rows alone
    python3 chip_smoke.py --light    # phases 1, 2 and B10's / B11's rows
    python3 chip_smoke.py --partition   # phases 1, 2 and B12's / B13's rows

Phases (any failure exits non-zero, and no result line is printed):
  1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build every hand kernel from `multivolumes_tpu_torch/csrc/` (one nvcc
     per source, all at once, sm_90a) and load them;
  3. each kernel against its plain PyTorch version on the card, on the
     operands the main path gives it (captured from the demo-scale scene
     and its frames; the TAA resolve from the third frame, so the history
     is not zero, with and without the fused tone map, and on seeded
     synthetic cases with half the alpha at 1, independent per pixel:
     1280x800, the same with NaN colours in cur and in hist (NaN must
     spread exactly to the taps of the first, the NaN guard must fire on
     the second), 1283x803 and 7x5 (no tile divides them) and the
     row-band form on the 402- and 401-row bands of 1283x803, first and
     last, which together must equal the whole image, all bit for bit;
     the mesh variants of B2 and B3 from a demo-scale frame with the
     mesh, where the depth weights must move some seam pixels, and B3's
     also on the full light refresh of `set_light` with a light from
     below the mesh's side, on
     the volumes that hold a penumbra of its shadow and at the refresh's
     full cohort, and on a refresh whose light sweep runs along y: the
     demo's light is above the volumes and the mesh lies low, so there it
     may shadow none; B1 on the first four volumes of the frame's S=128
     bucket and on the whole S=128, S=64 and S=32
     buckets; B7, each bucket's prologue, on the same three buckets of
     the frame without and with the mesh (the depth bound and the tile
     composite's cube depth), every output within 1e-6 relative; B3 and
     B4 also at the full refresh's 64 volumes; B8, the mesh's deferred
     shade, on the shade of a frame with the test torus at 1280x800 (its
     384 window, the far preset) and at 2560x1440 (the full screen, the
     near preset), colour, velocity and validity within 1e-4 + 1e-4
     relative, with the kernels one call launches; B9, the mesh's
     raster, on the raster of the same two frames, depth and triangle
     ids equal; B12 and B13, the LOD sweep's partition and bucket
     stores, on the demo frame with the torus, equal), with
     the parity tolerance of the kernel's card test; times of both from
     CUDA events after warm-up, each kernel's bound (below), for B1, B2,
     B2', the B2 band, B4, B5, B5' and B6 the device time of the kernels
     a call launches (`device_ms`, profiler), and on lines of their own
     ("[occupancy]", "[floor]") the registers, shared memory, cluster
     size and CTAs per SM of the B1, B2, B3 and B4 launches, the
     composite's list lengths, and the floor of B3's and B4's dependent
     chains (their launch with an empty body: L cluster barriers);
  4. the main path at the 64-volume 1280x800 demo scale (no mesh, TAA on):
     4 frames along the orbit through `MultiRayCaster.render`, then the
     same 4 cameras through `MultiRayCaster.render_block` from a copy of
     the starting state. Each path runs with the launch counts set to 0
     just before it and read just after, and every kernel of the path
     must have launched in each; the block's images must equal the
     sequential ones (atol 2e-5), and the image must be finite with real
     volume coverage;
  5. the same with the opaque mesh: a closed test mesh of 69,960
     triangles (the reference demo's bunny has 69,451; `bunny.obj` is not
     in the repository) written to `build/`, loaded with `set_mesh` at the
     demo placement, 4 orbit frames through `render` (the raster preset
     picked before each frame from the host-side eye, as the app does:
     the mesh's box projects at 272-340 px, the far preset with its
     windows)
     and `render_block`, with the mesh variants of B2 and B3 among the
     kernels that must launch; then a close-up frame on the near preset;
  6. three small frames with TAA rendered with impl="kernel" and with
     impl="plain" from the same state, compared with the golden-image
     tolerance, without and with the mesh;
  7. the app, `python -m multivolumes_tpu_torch.app` at the demo scale
     for 4 animated frames, in its own process, without and with
     `--mesh`: exit code 0 and a non-empty PNG;
  8. the sharded frame step at the demo scale on a logical mesh of 2 rows
     x 4 volume shards on the one card (and on the machine's cards when
     it has several): 3 frames through `sharding.make_sharded_step`
     against 3 frames of the unsharded `render_frame` (mean < 2e-3, p99.9
     < 1e-1: each volume shard fills its own LOD buckets, so some volumes
     march at another resolution; on 2 rows x 1 volume shard, where the
     buckets agree, atol 2e-5), the row-band TAA resolve (B5') and the
     `tile_row0` band composite against their plain versions on a frame's
     operands (and the bands against B5 on the whole image, equal), their
     launches (2 band resolves, 2 band composites and at least 4 sweeps
     per frame), the movements the frame logged; then the demo with the
     test mesh (phase 5's scene) through the sharded step on the same two
     meshes, 3 orbit frames on the far preset and a close-up on the near
     one, held against the unsharded mesh frames at the same limits, with
     B1, B2' in row bands, B3', B4 and B5' launched, per-frame host
     times, peak memory, a profiled window and the movements of the mesh
     pass (depth, triangle ids, the shaded window); on 2 rows x 4, each B1
     launch of the last orbit frame (per volume shard and LOD bucket,
     rays bounded by the scene depth) against its plain version (the
     `sweep@shard-S<size>-d<shard>` rows, atol 1e-4 on every element,
     `B1_ATOL`), and the orbit
     frames again with B1's plain version on both sides (where the
     largest pixel difference from the unsharded frame comes from); B2'
     band on a band of the last frame whose depth weights change pixels
     against its plain version (the `composite@depth-band` row) and the
     two bands against the unbanded B2' launch, bit for bit; then
     `sharding.placement_check(8)` and
     `sharding.dryrun(8)` on the card;
  9. the binned-raster eval kernel (B6) against its plain version at the
     microbench's default size (exact equality), then the microbench
     itself, `tools.raster_bin_microbench.main`, whose table is printed;
 10. the reference phase (after the sharded phase, with the demo scenes
     freed; its wall time printed):
     the demo with `lod_bucket_caps=None` and the warp composite, its one
     B1 launch (64 volumes at S=128, `sweep_planes` planes) against the
     plain version (the `sweep@unbucketed` row, `B1_ATOL`), then 2
     frames through `render` and `render_block` as in 4; the sweep
     light path refusing a rotated world; the demo in full
     reference semantics (reference march and light, gather composite)
     for 2 frames with per-pass times and peak memory, then the same
     with every volume world rotated through `set_volume_world`, B1-B4
     launched by neither; and the pinned `reference_4vol` golden
     (tests/goldens/, read with numpy) rendered on the card at its limits
     (mean < 2e-3, p99.9 < 3e-2);
 11. the sharded step's other settings (`phase_sharded_settings`): the
     demo un-bucketed with the tile composite, un-bucketed with the warp
     composite, with the point light (the reference light march) and the
     LOD sweep, in full reference semantics, and un-bucketed with the
     test mesh, each for 2 orbit frames (1 under the reference light)
     through `sharding.make_sharded_step` on 2 rows x 1 and 2 rows x 4 volume
     shards of the card against the unsharded frames of the same setting
     (atol 2e-5 where no per-shard LOD caps apply, else the no-mesh
     sharded limits), with its kernels launched and no other, ms/frame,
     peak memory, the movements and a profiled frame (not under the
     reference light: `--profile-sharded-settings`); on 2 rows x 4 of the
     un-bucketed tile setting, B1 per volume shard (16 @ 128) against its
     plain version (the `sweep@unbucketed-shard-d<shard>` rows,
     `B1_ATOL`) and the B2 band on the unsorted f32 maps (the
     `composite@band-unsorted` row), its two bands against the unbanded
     launch bit for bit.
 12. the tools (`phase_tools`), each entry point with the launch counts
     set to 0 just before it and read just after: `entry.entry()`'s
     frame step (finite 192x128 image), `entry.dryrun_multichip(2)` and
     (4) on logical shards, `utils.timing.time_fn` of the demo frame
     against `profile_frame`'s pass sum (medians of 9 rounds taken in
     turn, within 25%), `tools.trace_ops`
     on 2 demo frames without and with the torus (B1 in `sweep`, B2 and
     its vote in `composite`, B3 / B4 in `light`, B5 in `taa`, at most
     1% of the device time unattributed; per-pass device table printed),
     `tools.fidelity_demo` at full width with the torus and 16 volumes,
     `tools.bench_fallbacks --volumes 8 --frames 2` and the gallery's 4
     and 16 volumes (`tools.render_gallery.render_count`).
 13. the bench (`phase_bench`): `multivolumes_tpu_torch.bench.run` at its
     card config (the all64 workload, 32 frames in both dispatch modes,
     4-frame batches, the per-pass breakdown) without the mesh, as the
     CLI runs where `bunny.obj` is absent, and with the test torus, each
     with the launch counts set to 0 just before and read just after; its
     record must have exactly the bench's five keys, a value above 0, a
     mode of "scan" or "async" and p50 <= p95; then one bench frame of
     each under the profiler must launch B1 three times, B2 (B2' and its
     vote with the torus), B3 (B3'), B4 and B5 once each, and call none
     of their plain versions.

Each kernel's bound (`bound_ms`) is the larger of two times: the bytes
it must move (each input read once, each output written once) over the
card's 3.35 TB/s, and a count of its f32 operations on this run's
inputs over 67 TFLOP/s (the H100 SXM's f32 rate outside the tensor
cores); where the work depends on the data, the counts are of what this
run's inputs need (B1: the samples its march composites before a ray's
transmittance falls below 0.01, and the texels they read; see
`bound_*`). No single PyTorch call computes any of these functions, so
`library_ms` is null (B6's yardstick, the `scatter_reduce_` raster it
would replace, is another function: the microbench prints its time).

The last line is `{"ok": true, "device": {...}}`; the line before it is
the per-kernel JSON summary, and the one before that the `nvidia-smi`
line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# kernel name -> (CUDA source, the TPU kernel it replaces)
_CSRC = "multivolumes_tpu_torch/csrc/"
_PALLAS = "multivolumes_tpu/ops/pallas/"
KERNELS = {
    "sweep": (_CSRC + "sweep.cu", _PALLAS + "sweep_kernel.py:318"),
    # B7 replaces no Pallas kernel: the JAX frame's bucket prologue in XLA
    "sweep_prologue": (_CSRC + "sweep_prep.cu",
                       "multivolumes_tpu/render/sweep.py:673"),
    "composite": (_CSRC + "composite.cu", _PALLAS + "composite_kernel.py:691"),
    "composite_depth": (_CSRC + "composite.cu",
                        _PALLAS + "composite_kernel.py:691"),
    "light_self_scan": (_CSRC + "lightsweep.cu",
                        _PALLAS + "lightsweep_kernel.py:96"),
    "light_self_scan_sm": (_CSRC + "lightsweep.cu",
                           _PALLAS + "lightsweep_kernel.py:96"),
    "light_advect_mul": (_CSRC + "lightsweep.cu",
                         _PALLAS + "lightsweep_kernel.py:152"),
    "taa": (_CSRC + "taa.cu", _PALLAS + "taa_kernel.py:226"),
    "composite_band": (_CSRC + "composite.cu",
                       _PALLAS + "composite_kernel.py:691"),
    "composite_depth_band": (_CSRC + "composite.cu",
                             _PALLAS + "composite_kernel.py:691"),
    "taa_band": (_CSRC + "taa.cu", _PALLAS + "taa_kernel.py:247"),
    "raster_bin_eval": (_CSRC + "raster_bin.cu",
                        "tools/raster_bin_microbench.py:172"),
    # B8 replaces no Pallas kernel: the JAX frame's deferred shade in XLA
    "mesh_shade": (_CSRC + "mesh_shade.cu",
                   "multivolumes_tpu/render/mesh.py:889"),
    # B9 replaces no Pallas kernel: the JAX frame's scatter raster in XLA
    "raster": (_CSRC + "raster.cu", "multivolumes_tpu/render/mesh.py:257"),
    # B10 and B11 replace no Pallas kernel: the JAX light glue in XLA
    "light_prologue": (_CSRC + "lightsweep_prep.cu",
                       "multivolumes_tpu/render/lightsweep.py:100"),
    "light_epilogue": (_CSRC + "lightsweep_prep.cu",
                       "multivolumes_tpu/render/lightsweep.py:527"),
    # B12 and B13 replace no Pallas kernel: the JAX LOD sweep's glue in XLA
    "lod_partition": (_CSRC + "lod_partition.cu",
                      "multivolumes_tpu/render/sweep.py:637"),
    "lod_store": (_CSRC + "lod_partition.cu",
                  "multivolumes_tpu/render/sweep.py:673"),
}
# the light cohort update's kernels around B3 / B4 (B10, B11)
LIGHT = ("light_prologue", "light_occlusion", "light_epilogue")
# the LOD sweep's partition and bucket stores (B12, B13)
LOD = ("lod_partition", "lod_store")
# the kernels of the frame without and with the opaque mesh
NO_MESH = ("sweep", "sweep_prologue", *LOD, "composite", "light_self_scan",
           "light_advect_mul", *LIGHT, "taa")
WITH_MESH = ("sweep", "sweep_prologue", *LOD, "composite_depth",
             "light_self_scan_sm", "light_advect_mul", *LIGHT, "taa",
             "mesh_shade", "raster")
# summary row name -> (launch-count key, the path whose counts it reports)
ROW_KERNEL = {"sweep@unbucketed": ("sweep", "unbucketed"),
              "sweep_prologue@depth": ("sweep_prologue", "mesh"),
              "composite@depth": ("composite_depth", "mesh"),
              "light_self_scan@sm": ("light_self_scan_sm", "mesh"),
              "composite@band": ("composite_band", "sharded"),
              "composite@depth-band": ("composite_depth_band",
                                       "sharded_mesh"),
              "sweep@shard": ("sweep", "sharded_mesh"),
              "sweep@unbucketed-shard": ("sweep", "sharded_settings"),
              "composite@band-unsorted": ("composite_band",
                                          "sharded_settings"),
              "taa_band": ("taa_band", "sharded"),
              "raster_bin_eval": ("raster_bin_eval", "raster_bin"),
              "mesh_shade@1280x800-window": ("mesh_shade", "mesh_800p"),
              "mesh_shade@2560x1440-full": ("mesh_shade", "mesh_1440p"),
              "raster@1280x800-far": ("raster", "raster_800p"),
              "raster@2560x1440-near": ("raster", "raster_1440p"),
              "light_prologue": ("light_prologue", "light"),
              "light_epilogue": ("light_epilogue", "light"),
              "lod_partition": ("lod_partition", "partition"),
              "lod_store": ("lod_store", "partition")}
# the kernels of the un-bucketed frame with the warp composite, and of the
# frame in full reference semantics (the gather passes have none but B5)
UNBUCKETED = ("sweep", "light_self_scan", "light_advect_mul", *LIGHT, "taa")
REFERENCE = ("taa",)
# the kernels of the sharded frame step on a mesh with a rows axis,
# without and with the opaque mesh
SHARDED = ("sweep", "composite_band", "light_self_scan", "light_advect_mul",
           *LIGHT, "taa_band")
SHARDED_MESH = ("sweep", "composite_depth_band", "light_self_scan_sm",
                "light_advect_mul", *LIGHT, "taa_band", "mesh_shade",
                "raster")
# the sharded step's other settings: name -> (config change, with the test
# mesh, the kernels it launches on a mesh with a rows axis; the reference
# light runs none of B3 / B4, the warp and gather composites none of B2)
SETTINGS_SHARDED = {
    "unbucketed tile": (dict(lod_bucket_caps=None), False, SHARDED),
    "unbucketed warp": (dict(lod_bucket_caps=None, composite_mode="warp"),
                        False, ("sweep", "light_self_scan",
                                "light_advect_mul", *LIGHT, "taa_band")),
    "point light": (dict(point_light=True), False,
                    ("sweep", "sweep_prologue", *LOD, "composite_band",
                     "taa_band")),
    "reference": (dict(march_mode="reference", light_mode="reference",
                       composite_mode="gather"), False, ("taa_band",)),
    "unbucketed tile, torus": (dict(lod_bucket_caps=None), True,
                               SHARDED_MESH),
}


def row_kernel(name):
    """Summary row name -> (launch-count key, path): the longest entry of
    ROW_KERNEL that is the name or, followed by "-", begins it (the
    shadow-map rows "light_self_scan@sm-C<n>", the per-shard rows
    "sweep@shard-S<size>-d<shard>"), else the part before "@"."""
    keys = [k for k in ROW_KERNEL if name == k or name.startswith(k + "-")]
    if keys:
        return ROW_KERNEL[max(keys, key=len)]
    base = name.split("@")[0]
    return ROW_KERNEL.get(base, (base, "plain"))

# the kernels one composite call launches (the depth variant's vote first)
COMPOSITE_KERNELS = ("tile_composite_kernel", "mesh_tile_kernel")
# the card's rates for the bound: HBM3 bytes/s and f32 FLOP/s (H100 SXM)
MEM_RATE = 3.35e12
F32_RATE = 67e12
MESH_TRIS = 70_000
# every B1 launch against its plain version, on every element: since its
# sample coordinates are non-contracted (PR 10) each launch of this script
# is within 3.3e-6 of plain, with no ray beyond the earlier limit (atol
# 2e-3 + rtol 2e-2), f32 stacks included (PERF.md section 6)
B1_ATOL = 1e-4
# a light from below the side of the mesh, so that it shadows some volumes
LOW_LIGHT = (75.0, -30.0, -75.0)
# the same from below along y: its light sweep runs along y, not z
LOW_LIGHT_Y = (20.0, -75.0, -20.0)
# the demo's mesh placement (`all64.bat`: -mesh bunny.obj 0 -9 0 1.8) is
# the RenderConfig default mesh_pos_scale

DEMO = dict(width=1280, height=800, grid_size=128, light_grid_size=96,
            max_ray_samples=256, max_light_samples=96, num_volumes=64,
            num_volume_srcs=10, cube_map_size=128)
SMALL = dict(width=320, height=200, grid_size=32, light_grid_size=16,
             max_ray_samples=64, max_light_samples=16, num_volumes=4,
             num_volume_srcs=2, cube_map_size=32)


class Failed(Exception):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


@contextlib.contextmanager
def capture(targets):
    """Record the first call of each (module, function name) in
    `targets` while the block runs, under the name, every call in order
    under the name + "*", and the names of all calls in the order they
    start (a call made inside another comes after it) under "#"."""
    calls, saved = {}, []
    for mod, name in targets:
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def wrapper(*a, _orig=orig, _name=name, **k):
            calls.setdefault("#", []).append(_name)
            out = _orig(*a, **k)
            calls.setdefault(_name, (a, k))
            calls.setdefault(_name + "*", []).append((a, k))
            return out

        setattr(mod, name, wrapper)
    try:
        yield calls
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel, reps: int = 9):
    """Device time (ms) per run of fn() of the kernels whose name contains
    `kernel` (a name or a tuple of names: a call may launch several, each
    once), the median over `reps` runs, from the profiler's kernel events
    (a profile now and then records none: tried three times); None when
    the profiler records no device time."""
    import torch
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
    return None


def compare_kernel(name, fn, args, kwargs, tol, bound_of, reps=(10, 2),
                   device_kernel=None):
    """Run wrapper `fn` with impl kernel and plain on the same operands;
    check the tolerance (`tol=None`: outputs that must be equal, NaN where
    the plain version has NaN);
    return the summary entry (launches filled in later).
    `bound_of(args, kwargs)` -> (bytes, f32 operations). With
    `device_kernel`, the entry also carries `device_ms`, the device time
    of the kernels of that name alone (the event time `ms` includes the
    wrapper's PyTorch operations)."""
    import torch

    got = fn(*args, **dict(kwargs, impl="kernel"))
    want = fn(*args, **dict(kwargs, impl="plain"))
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs, means = [], []
    for g, w in zip(got, want):
        if tol is None:
            differ = g != w
            if g.is_floating_point():
                differ &= ~(g.isnan() & w.isnan())
            check(not bool(differ.any()),
                  f"{name}: {int(differ.sum())} of {g.numel()} elements "
                  f"differ from the plain version")
            errs.append(0.0)
            means.append(0.0)
            continue
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        errs.append(tol(g, w))
        means.append(float((g - w).abs().mean()))
    max_err = max(errs)
    ms = cuda_ms(lambda: fn(*args, **dict(kwargs, impl="kernel")), reps[0])
    plain_ms = cuda_ms(lambda: fn(*args, **dict(kwargs, impl="plain")),
                       reps[1])
    nbytes, flops = bound_of(args, kwargs)
    t_bytes, t_ops = nbytes / MEM_RATE * 1e3, flops / F32_RATE * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[kernel] {name}: max_abs_err {max_err:.3e}  mean_abs_err "
        f"{max(means):.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    src, replaces = KERNELS[row_kernel(name)[0]]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "max_abs_err": max_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None}
    if device_kernel is not None:
        row["device_ms"] = device_ms(
            lambda: fn(*args, **dict(kwargs, impl="kernel")), device_kernel)
        log(f"  {name}: device time of the kernel alone "
            f"{row['device_ms']} ms")
    return row


def _nbytes(*tensors) -> int:
    return sum(int(t.numel()) * t.element_size() for t in tensors)


def bound_sweep(args, kwargs):
    """B1, counted by the plain version's own march on these inputs
    (`sweep_march_plain(sample_counts=True)`): bytes, the distinct texels
    of the source volumes (4 channels) and light stacks (3) that the
    needed samples' taps read, the per-ray parameters and the output;
    operations, the front-to-back update (14 f32 operations) of each
    needed sample: a live sample (density above 0.01 inside the ray's
    window) met while the ray's transmittance is still at least 0.01 (the
    kernel skips transparent slabs and stops a face once all its rays are
    below 0.01; the trilinear taps are not counted)."""
    from multivolumes_tpu_torch.ops import sweep as sweep_ops

    vols, light, tex = args[:3]
    params, size = args[4], args[8]
    _acc, counts = sweep_ops.sweep_march_plain(
        *args, n_eff_b=kwargs.get("n_eff_b"),
        light_ids=kwargs.get("light_ids"),
        sample_counts=True)
    out = 4 * tex.shape[0] * 6 * 4 * size * size
    nbytes = (counts["vol_texels"] * 4 * vols.element_size()
              + counts["light_texels"] * 3 * light.element_size()
              + _nbytes(*params) + out)
    return nbytes, 14.0 * float(counts["needed"].sum())


def bound_prologue(args, kwargs):
    """B7: the ray operands written once (s_in, s_end, ray_len f32 and
    active u8 a ray), the per-volume operands read once and, with the
    depth map, the cube depth written once and the depth map's texels
    under the coarse taps read once (at most the whole map); operations:
    the ray parameters' formula (40 f32 operations a ray) and, with the
    depth map, each coarse texel's occlusion bound (100)."""
    from multivolumes_tpu_torch.ops.sweep_prep import depth_blocks

    ids, size_b = args[3], args[5]
    count = ids.shape[0]
    rays = count * 6 * size_b * size_b
    nbytes = rays * 13 + count * (8 + 4 + 6 * 3 * 4 + 2 * 16 * 4)
    flops = 40.0 * rays
    depth = kwargs.get("depth_map")
    if depth is not None:
        f = 4 if size_b >= 64 else 2 if size_b >= 32 else 1
        coarse = count * 6 * (size_b // f) ** 2
        block = depth_blocks(tuple(depth.shape), size_b)
        nbytes += rays * 4 + min(coarse * block * block, depth.numel()) * 4
        flops += 100.0 * coarse
    return nbytes, flops


def prologue_rows(calls, prefix):
    """B7 against its plain version on the frame's calls, one a LOD bucket
    (S, S/2, S/4): the `<prefix>S<size>` rows, every output within 1e-6
    relative (the cube depth into a buffer of each side's own, filled as
    the sweep fills it)."""
    import torch

    from multivolumes_tpu_torch.config import SharedConsts
    from multivolumes_tpu_torch.ops import sweep_prep

    rows = []
    for a, k in calls:
        k = {key: v for key, v in k.items() if key != "impl"}
        cubes = {}

        def run(*pa, impl, _cubes=cubes, **pk):
            cube = pk.get("cube_depth")
            if cube is not None:
                if impl not in _cubes:
                    _cubes[impl] = torch.full_like(
                        cube, SharedConsts.Z_FAR if pk.get("swap") is not None
                        else 1.0)
                pk = dict(pk, cube_depth=_cubes[impl])
            out = tuple(sweep_prep.sweep_prologue(*pa, impl=impl, **pk))
            return out if cube is None else out + (_cubes[impl],)

        name = f"{prefix}S{a[5]}"
        dm = k.get("depth_map")
        log(f"[kernel] {name}: {a[3].shape[0]} volumes, depth map "
            f"{None if dm is None else tuple(dm.shape)}")
        rows.append(compare_kernel(
            name, run, a, k, allclose_tol(0.0, 1e-6, name), bound_prologue,
            reps=(20, 2), device_kernel="sweep_prologue_kernel"))
    check([r["name"][len(prefix):] for r in rows] == ["S128", "S64", "S32"],
          f"B7 rows {[r['name'] for r in rows]}")
    return rows


def bound_composite(args, kwargs):
    """B2: the listed volumes' faces (their n_eff corners; with the depth
    variant the depth corners of the volumes listed on mesh tiles), the
    scene plane, the lists and the output; operations: the ray / box exit
    and exit-face test of each (pixel, listed volume) pair (60 f32
    operations, a lower bound: the warp of the pairs that pass is not
    counted)."""
    import torch

    color, scene, tlist, counts, vol_flt, face_flt, th, tw = args[:8]
    n = color.shape[0]
    pairs = float(counts.sum()) * th * tw
    listed = torch.zeros(n, dtype=torch.bool, device=color.device)
    for t in range(tlist.shape[0]):
        listed[tlist[t, :int(counts[t])].long()] = True
    n_eff = vol_flt[:, 20]
    corner = float((n_eff[listed] ** 2).sum()) * 6
    nbytes = corner * 4 * color.element_size()
    depth = kwargs.get("depth_sel")
    if depth is not None:
        from multivolumes_tpu_torch.ops.composite import mesh_tiles

        on = mesh_tiles(scene, th, tw).flatten()
        mlisted = torch.zeros_like(listed)
        for t in torch.nonzero(on).flatten().tolist():
            mlisted[tlist[t, :int(counts[t])].long()] = True
        nbytes += float((n_eff[mlisted] ** 2).sum()) * 6 * 4
    nbytes += _nbytes(scene, tlist, counts, vol_flt, face_flt) \
        + 4 * scene.numel() * 4
    return nbytes, 60.0 * pairs


def bound_self_scan(args, kwargs):
    """B3: density in, here out, the footprint out (+ the shadow plane);
    operations per texel and slice: the 2-tap lerp (9) and the
    attenuation (4, counting exp2 and log2 as one each), + the shadow
    plane's lerp and compare (13)."""
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


def bound_taa_band(args, kwargs):
    """B5': the band with its halo rows, the band's history and blur in,
    the band's history out; operations as B5."""
    cur_halo, hist, blur = args[:3]
    pixels = hist.shape[1] * hist.shape[2]
    return _nbytes(cur_halo, hist, blur) + 4 * pixels * 4, 130.0 * pixels


def bound_raster_bin(args, kwargs):
    """B6: the ten coefficient rows, the chunks' tiles and origins in, the
    output words written once; operations: 25 per (pixel, candidate) pair
    (three affines of two multiplies and two adds, the inside test, the
    quantise-and-pack and the minimum)."""
    tile_of_chunk, x0, y0, coef, n_tiles = args
    n_c = tile_of_chunk.shape[0]
    nbytes = 10 * n_c * 128 * 4 + _nbytes(tile_of_chunk, x0, y0) \
        + n_tiles * 8 * 128 * 4
    return nbytes, 25.0 * n_c * 8 * 128 * 128


def allclose_tol(atol, rtol, what):
    """|g - w| <= atol + rtol |w| on every element."""
    def tol(g, w):
        import torch

        err = (g - w).abs()
        bad = err > atol + rtol * w.abs()
        if bool(bad.any()):
            worst = torch.topk(err.flatten(), 5).indices
            for i in worst.tolist():
                idx = list(torch.unravel_index(torch.tensor(i), err.shape))
                log(f"  {what}: at {[int(x) for x in idx]} kernel "
                    f"{float(g.flatten()[i]):.5f} plain "
                    f"{float(w.flatten()[i]):.5f}")
        check(not bool(bad.any()),
              f"{what}: {int(bad.sum())} of {bad.numel()} elements exceed "
              f"atol={atol} rtol={rtol} (max err {float(err.max()):.3e})")
        return float(err.max())
    return tol


def image_tol(mean_max, pct, pct_max, what):
    def tol(g, w):
        import torch

        err = (g - w).abs().flatten()
        mean = float(err.mean())
        q = float(torch.quantile(err, pct / 100.0))
        log(f"  {what}: mean {mean:.3e}  p{pct} {q:.3e}  max "
            f"{float(err.max()):.3e}")
        check(mean < mean_max and q < pct_max,
              f"{what}: mean {mean:.3e} (< {mean_max}), p{pct} {q:.3e} "
              f"(< {pct_max})")
        return float(err.max())
    return tol


def clone_state(state):
    import torch

    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "multivolumes_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "multivolumes_tpu_torch package is not beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"[card] {smi_line}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.ops import build
    from multivolumes_tpu_torch.tools import torus_mesh

    # --- 2. build ---------------------------------------------------------
    t0 = time.time()
    build.library()
    log(f"[build] kernels built and loaded in {time.time() - t0:.1f} s")

    # --- 3. each kernel against its plain version -------------------------
    dev = torch.device("cuda")
    cfg = RenderConfig(**DEMO)
    if sys.argv[1:] == ["--profile-sharded-settings"]:
        # the sharded settings' phase alone, every setting profiled
        phase_sharded_settings(cfg, dev, torus_mesh(MESH_TRIS), smi_line,
                               profile_all=True)
        log(smi_line)
        return 0
    if sys.argv[1:] in (["--mesh-shade"], ["--raster"], ["--light"],
                        ["--partition"]):
        phase = {"--mesh-shade": phase_mesh_shade, "--raster": phase_raster,
                 "--light": phase_light,
                 "--partition": phase_partition}[sys.argv[1]]
        rows, launches = phase(dev, torus_mesh(MESH_TRIS))
        for r in rows:
            key, path = row_kernel(r["name"])
            r["launches"] = launches[path][key]
        log(smi_line)
        print(json.dumps({"kernels": rows}), flush=True)
        return 0
    if sys.argv[1:] == ["--profile-reference"]:
        # the reference phase alone, with a frame of the full reference
        # semantics under the profiler: its device busy time (the profile
        # of half a million kernels takes minutes, too long for every run)
        phase_reference(cfg, dev, profile=True)
        log(smi_line)
        return 0
    mesh_path = torus_mesh(MESH_TRIS)
    engine, results = phase_kernels(cfg, dev)
    launches = {"plain": phase_demo(engine, cfg, dev, NO_MESH, frames=4)}
    del engine
    mesh_engine, mesh_results = phase_mesh_kernels(cfg, dev, mesh_path)
    results += mesh_results
    launches["mesh"] = phase_demo(mesh_engine, cfg, dev, WITH_MESH,
                                  frames=4, closeup=True)
    for phase in (phase_mesh_shade, phase_raster, phase_light,
                  phase_partition):
        phase_results, phase_launches = phase(dev, mesh_path)
        results += phase_results
        launches.update(phase_launches)
    torch.cuda.empty_cache()
    t0 = time.time()
    (sharded_results, launches["sharded"],
     launches["sharded_mesh"]) = phase_sharded(cfg, dev, mesh_engine)
    log(f"[sharded] the sharded phase took {time.time() - t0:.1f} s")
    # freed before the reference phase, whose peak memory it would inflate
    del mesh_engine
    torch.cuda.empty_cache()
    t0 = time.time()
    ref_results, launches["unbucketed"] = phase_reference(cfg, dev)
    results += ref_results
    phase_golden(dev)
    log(f"[reference] the reference phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    settings_results, launches["sharded_settings"] = phase_sharded_settings(
        cfg, dev, mesh_path, smi_line)
    results += settings_results
    log(f"[sharded-settings] the phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    bin_results, launches["raster_bin"] = phase_raster_bin(dev)
    results += sharded_results + bin_results
    for r in results:
        key, path = row_kernel(r["name"])
        r["launches"] = launches[path][key]
    phase_small(RenderConfig(**SMALL), dev)
    phase_small(RenderConfig(**SMALL), dev, mesh_path=mesh_path)
    phase_app()
    phase_app(mesh_path=mesh_path)
    torch.cuda.empty_cache()
    t0 = time.time()
    phase_tools(cfg, dev, mesh_path)
    log(f"[tools] the tools phase took {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.time()
    phase_bench(dev, mesh_path, smi_line)
    log(f"[bench] the bench phase took {time.time() - t0:.1f} s")

    log(smi_line)
    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase_kernels(cfg, dev):
    """Build the demo scene and hold each kernel against its plain version
    on the operands of the scene build and of one frame."""
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import lightsweep as light_ops
    from multivolumes_tpu_torch.ops import sweep as sweep_ops
    from multivolumes_tpu_torch.ops import sweep_prep
    from multivolumes_tpu_torch.ops import taa as taa_ops
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod
    from multivolumes_tpu_torch.render import tilecast as tile_mod
    from multivolumes_tpu_torch.render.sweep import SweepParams

    targets = [(light_ops, "light_self_scan"), (light_ops, "light_advect_mul")]
    t0 = time.time()
    with capture(targets) as init_calls:
        engine = MultiRayCaster(cfg, device=dev)
    torch.cuda.synchronize()
    log(f"[scene] {cfg.num_volumes}-volume scene built in "
        f"{time.time() - t0:.1f} s")
    cams = [cam_lib.orbit_camera(0.25 * i, cfg.aspect_ratio, device=dev)
            for i in range(3)]
    probe = clone_state(engine.state)
    with capture(targets + [(sweep_mod, "sweep_march"),
                            (sweep_prep, "sweep_prologue"),
                            (tile_mod, "tile_composite")]) as frame_calls:
        probe = frame_lib.render_frame(probe, cams[0], engine.config).state
    probe = frame_lib.render_frame(probe, cams[1], engine.config).state
    with capture([(taa_ops, "taa_resolve")]) as taa_calls:
        frame_lib.render_frame(probe, cams[2], engine.config)
    del probe
    torch.cuda.synchronize()

    results = []
    light_tol = allclose_tol(1e-5, 0.0, "light")
    (a, k) = frame_calls["sweep_march"]
    # bucket 0 of the frame (the full-resolution bucket), first 4 volumes
    vols, light, tex, eye_f, params, smp, run, planes, size = a
    q = slice(0, 4)
    a4 = (vols, light, tex[q], eye_f[q], SweepParams(*(x[q] for x in params)),
          smp[q], run[q], planes, size)
    k4 = dict(k, n_eff_b=k["n_eff_b"][q], light_ids=k["light_ids"][q])
    k4.pop("impl", None)
    check(size == cfg.cube_map_size, f"sweep bucket 0 size {size}")
    results.append(compare_kernel("sweep", sweep_mod.sweep_march, a4, k4,
                                  allclose_tol(B1_ATOL, 0.0, "sweep"),
                                  bound_sweep, reps=(10, 2),
                                  device_kernel="sweep_kernel"))
    # the frame's three launches of B1: the whole S, S/2 and S/4 buckets
    for (a, k) in frame_calls["sweep_march*"]:
        k = dict(k)
        k.pop("impl", None)
        info = sweep_ops.sweep_launch_info(
            a[8], a[7], a[0].shape[1], a[1].shape[1],
            a[0].dtype == torch.bfloat16)
        log(f"[kernel] sweep bucket S={a[8]}: {a[2].shape[0]} volumes")
        log(f"[occupancy] sweep@S{a[8]} ({a[0].dtype}): {info}")
        results.append(compare_kernel(
            f"sweep@S{a[8]}", sweep_mod.sweep_march, a, k,
            allclose_tol(B1_ATOL, 0.0, f"sweep@S{a[8]}"),
            bound_sweep, reps=(10, 1), device_kernel="sweep_kernel"))
    check([r["name"] for r in results]
          == ["sweep", f"sweep@S{size}", f"sweep@S{size // 2}",
              f"sweep@S{size // 4}"],
          f"sweep buckets {[r['name'] for r in results]}")
    # B7, the prologue of each of the three buckets (no depth map)
    results += prologue_rows(frame_calls["sweep_prologue*"],
                             "sweep_prologue@")
    (a, k) = frame_calls["tile_composite"]
    k = dict(k)
    k.pop("impl", None)
    results.append(compare_kernel(
        "composite", tile_mod.tile_composite, a, k,
        image_tol(3e-3, 99.5, 3e-2, "composite"), bound_composite,
        reps=(10, 1), device_kernel=COMPOSITE_KERNELS))
    composite_numbers(a, k, "composite")
    # B3 on the frame's cohort of one, on 8 volumes and on all 64 of the
    # full refresh that the engine's start and set_light launch
    for cname, calls in (("C1", frame_calls), ("C8", init_calls),
                         ("C64", init_calls)):
        (a, k) = calls["light_self_scan"]
        k = dict(k)
        k.pop("impl", None)
        if cname == "C8":
            a = tuple(x[:8] for x in a)
        c, l = a[0].shape[0], a[0].shape[1]
        check(c == int(cname[1:]), f"cohort {a[0].shape}")
        results.append(compare_kernel(f"light_self_scan@{cname}",
                                      light_ops.light_self_scan, a, k,
                                      light_tol, bound_self_scan,
                                      reps=(10, 2)))
        scan_numbers(light_ops, f"light_self_scan@{cname}", c, l, False,
                     dev)
        (a, k) = calls["light_advect_mul"]
        k = dict(k)
        k.pop("impl", None)
        if cname == "C8":
            # the 8 volumes of the full refresh that lie most in the
            # others' shadow: a t_in that is constant (1 for the volumes
            # nothing lies in front of) would not tell a kernel whose
            # carry starts from 1, or from another band's rows
            sel = torch.argsort(a[1].amin(dim=(1, 2)))[:8]
            a = tuple(x[sel] for x in a)
        check(a[0].shape[0] == c, f"advect cohort {a[0].shape}")
        log(f"  light_advect_mul@{cname}: t_in in [{float(a[1].min()):.4f},"
            f" {float(a[1].max()):.4f}]")
        check(cname == "C1" or float(a[1].min()) < 0.9,
              f"{cname}: t_in is (nearly) constant")
        results.append(compare_kernel(f"light_advect_mul@{cname}",
                                      light_ops.light_advect_mul, a, k,
                                      light_tol, bound_advect,
                                      reps=(10, 2),
                                      device_kernel="self_scan_kernel"))
        scan_numbers(light_ops, f"light_advect_mul@{cname}", c, l, False,
                     dev, advect=True)
    # B5 bit for bit: the frame's operands, and seeded ones that are
    # independent per pixel (so a wrong halo or edge clamp shows), at the
    # frame's size, with NaN colours, and at sizes no tile divides
    (a, _k) = taa_calls["taa_resolve"]
    check(float(a[1][3].min()) > 0.0, "frame 3's TAA history is still zero")
    for name, kw in (("taa@frame3", {}), ("taa@frame3+tonemap",
                                           dict(tonemap=True))):
        results.append(compare_kernel(name, taa_ops.taa_resolve, a, kw,
                                      None, bound_taa, reps=(20, 3),
                                      device_kernel="taa_resolve_kernel"))
    for name, (h, w), nan in (("taa@synthetic", (cfg.height, cfg.width),
                               False),
                              ("taa@synthetic+nan", (cfg.height, cfg.width),
                               True),
                              ("taa@1283x803", (803, 1283), False),
                              ("taa@7x5", (5, 7), False)):
        ops_in = taa_synthetic(dev, h, w, with_nan=nan)
        results.append(compare_kernel(
            name, taa_ops.taa_resolve, ops_in, dict(tonemap=True), None,
            bound_taa, reps=(20, 3), device_kernel="taa_resolve_kernel"))
        if nan:
            taa_nan_check(taa_ops.taa_resolve(*ops_in, impl="kernel"))
    results += taa_band_edges(taa_ops, dev)
    del frame_calls, init_calls, taa_calls
    return engine, results


def phase_mesh_kernels(cfg, dev, mesh_path):
    """Build the demo scene with the test mesh and hold the mesh variants
    of B2 (depth weights) and B3 (shadow map) against their plain
    versions on the operands of one demo frame with the mesh, and B3's
    also on the shadowed volumes of a full light refresh."""
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import lightsweep as light_ops
    from multivolumes_tpu_torch.ops import sweep_prep
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import tilecast as tile_mod

    t0 = time.time()
    engine = MultiRayCaster(cfg, device=dev)
    # the full light refresh of set_mesh: every volume with the shadow map
    with capture([(light_ops, "light_self_scan")]) as mesh_calls:
        engine.set_mesh(mesh_path)
    torch.cuda.synchronize()
    log(f"[mesh] {int(engine.state.mesh_indices.shape[0])} triangles; "
        f"scene with the mesh built in {time.time() - t0:.1f} s; far "
        f"ladder {engine.config.raster_far_tiers} small "
        f"{engine.config.raster_far_small}")
    check(engine.config.raster_far_tiers is not None,
          "the test mesh has no far ladder")
    (a, k) = mesh_calls["light_self_scan"]
    k = {name: x for name, x in k.items() if name != "impl"}
    check(k.get("sm_vol") is not None, "no shadow map in set_mesh's refresh")
    log(f"[mesh] set_mesh's refresh under the demo's light: "
        f"{int((penumbra(a, k) > 0).sum())} of {a[0].shape[0]} volumes "
        f"hold a penumbra")
    # Under the demo's light, from above, the mesh (below the volumes'
    # mid-plane) may shadow no volume texel. A light from below its side
    # puts it between the light and some volumes: hold B3' on the full
    # refresh of set_light there, on the volumes that hold a penumbra,
    # then restore the demo's light (the same refresh, the same maps).
    pos0 = engine.state.light_pos[:3].tolist()
    col0 = engine.state.light_color.tolist()
    with capture([(light_ops, "light_self_scan")]) as low_calls:
        engine.set_light(LOW_LIGHT, col0[:3], col0[3])
    with capture([(light_ops, "light_self_scan")]) as y_calls:
        engine.set_light(LOW_LIGHT_Y, col0[:3], col0[3])
    from multivolumes_tpu_torch.render.lightsweep import light_axis

    check(light_axis(engine.state.light_pos) == 1,
          f"the light {LOW_LIGHT_Y} does not sweep along y")
    engine.set_light(pos0, col0[:3], col0[3])
    del mesh_calls
    eye = (0.0, 6.0, 60.0)              # the orbit's first pose
    preset = engine.select_raster_preset(eye)
    cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
    probe = clone_state(engine.state)
    with capture([(light_ops, "light_self_scan"),
                  (sweep_prep, "sweep_prologue"),
                  (tile_mod, "tile_composite")]) as calls:
        frame_lib.render_frame(probe, cam, engine.config)
    del probe
    torch.cuda.synchronize()
    # B7 with the depth bound and the tile composite's cube depth
    results = prologue_rows(calls["sweep_prologue*"], "sweep_prologue@depth-")
    (a, k) = calls["tile_composite"]
    k = dict(k)
    k.pop("impl", None)
    check(k.get("depth_sel") is not None, "no cube depth in the mesh frame")
    from multivolumes_tpu_torch.ops.composite import mesh_tiles

    on = mesh_tiles(a[1], a[6], a[7])
    log(f"[mesh] preset {preset}; {int(on.sum())} of {on.numel()} "
        f"composite tiles hold a mesh pixel")
    check(bool(on.any()), "no composite tile holds a mesh pixel")
    # the depth weights must change the colour somewhere (seam pixels),
    # or the comparison below could not tell a kernel that skips them
    seam = (tile_mod.tile_composite(*a, **k, impl="kernel")
            - tile_mod.tile_composite(*a, **dict(k, depth_sel=None),
                                      impl="kernel")).abs().amax(0)
    n_seam = int((seam > 1e-3).sum())
    log(f"[mesh] the depth weights move {n_seam} pixels by more than 1e-3 "
        f"(max {float(seam.max()):.3e})")
    check(n_seam > 0, "the depth weights change no pixel of the mesh frame")
    results.append(compare_kernel(
        "composite@depth", tile_mod.tile_composite, a, k,
        allclose_tol(1e-4, 1e-4, "composite@depth"), bound_composite,
        reps=(10, 1), device_kernel=COMPOSITE_KERNELS))
    composite_numbers(a, k, "composite@depth")
    light_tol = allclose_tol(1e-5, 0.0, "light_self_scan@sm")
    (a, k) = calls["light_self_scan"]
    k = dict(k)
    k.pop("impl", None)
    check(k.get("sm_vol") is not None, "no shadow map in the light cohort")
    log(f"[mesh] the frame's light cohort: {a[0].shape[0]} volume(s), "
        f"{int((penumbra(a, k) > 0).sum())} with a penumbra")
    results.append(compare_kernel(
        "light_self_scan@sm-C1", light_ops.light_self_scan, a, k, light_tol,
        bound_self_scan, reps=(10, 2)))
    scan_numbers(light_ops, "light_self_scan@sm-C1", 1, a[0].shape[1], True,
                 dev)
    (a, k) = low_calls["light_self_scan"]
    k = {name: x for name, x in k.items() if name != "impl"}
    pen = penumbra(a, k)
    shaded = torch.nonzero(pen).flatten()
    log(f"[mesh] set_light{LOW_LIGHT}'s refresh: {shaded.numel()} of "
        f"{a[0].shape[0]} volumes hold a penumbra (texels: "
        f"{dict(zip(shaded.tolist(), pen[shaded].tolist()))})")
    check(shaded.numel() > 0, "the mesh shadows no volume")
    sel = shaded[:8]
    results.append(compare_kernel(
        f"light_self_scan@sm-C{sel.numel()}", light_ops.light_self_scan,
        tuple(x[sel] for x in a), {name: x[sel] for name, x in k.items()},
        light_tol, bound_self_scan, reps=(10, 2)))
    # the refresh's full cohort, every volume of the scene
    results.append(compare_kernel(
        f"light_self_scan@sm-C{a[0].shape[0]}", light_ops.light_self_scan,
        a, k, light_tol, bound_self_scan, reps=(5, 1)))
    scan_numbers(light_ops, f"light_self_scan@sm-C{a[0].shape[0]}",
                 a[0].shape[0], a[0].shape[1], True, dev)
    # a refresh whose light sweep runs along y (the lateral planes permute)
    (a, k) = y_calls["light_self_scan"]
    k = {name: x for name, x in k.items() if name != "impl"}
    pen = penumbra(a, k)
    shaded = torch.nonzero(pen).flatten()
    log(f"[mesh] set_light{LOW_LIGHT_Y}'s refresh (sweep along y): "
        f"{shaded.numel()} of {a[0].shape[0]} volumes hold a penumbra")
    check(shaded.numel() > 0, "the mesh shadows no volume along y")
    sel = shaded[:8]
    results.append(compare_kernel(
        f"light_self_scan@sm-C{sel.numel()}-ysweep",
        light_ops.light_self_scan, tuple(x[sel] for x in a),
        {name: x[sel] for name, x in k.items()}, light_tol, bound_self_scan,
        reps=(10, 2)))
    del calls, low_calls, y_calls
    return engine, results


def bound_mesh_shade(args, kwargs):
    """B8: bytes, the per-triangle inputs read once (indices, clip
    positions and the vertices' position and normal), the plane rows
    written once and those of the distinct winning triangles read once,
    the ids of the rectangle, the distinct shadow-map texels under the
    shaded pixels' 2 x 2 taps (at most the map), the five fields and
    validity written; operations, a plane row's 105 f32 operations a
    triangle and a shaded pixel's 380 (planes, five transforms, PCF, SH
    and the BRDF, transcendental functions as one)."""
    import torch

    from multivolumes_tpu_torch.render import mesh as mesh_lib

    state, _cam, _cfg, op, tri, rows, cols = args
    n_tris, n_verts = state.mesh_indices.shape[0], state.mesh_verts.shape[0]
    fields, valid = mesh_lib.deferred_shade(*args, **dict(kwargs,
                                                          impl="kernel"))
    shaded = int(valid.sum())
    ids = tri[tri >= 0].unique().numel() if shaded else 0
    taps = min(4 * shaded, state.mesh_shadow_map.numel())
    nbytes = (n_tris * (24 + 96) + n_verts * (16 + 24) + ids * 96
              + rows.size * cols.size * 8 + taps * 4
              + valid.numel() * 21)
    del fields
    torch.cuda.synchronize()
    return nbytes, 105.0 * n_tris + 380.0 * shaded


def phase_mesh_shade(dev, mesh_path):
    """B8 against its plain version on the shade of a frame with the test
    torus (the demo's placement, 4 volumes: the shade reads none) at
    1280x800 from the orbit's first pose (the far preset, the 384 window
    pasted into the screen) and at 2560x1440 from the same pose (the near
    preset, the full screen): the `mesh_shade@<size>` rows, the kernels
    one call launches (profiler), and -> (rows, {path: launches}), the
    launch counts of the captured frame at each size under "mesh_800p"
    and "mesh_1440p"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import mesh as mesh_lib

    rows, launches = [], {}
    for (w, h), name, path in (((1280, 800), "1280x800-window", "mesh_800p"),
                               ((2560, 1440), "2560x1440-full",
                                "mesh_1440p")):
        cfg = RenderConfig(**dict(DEMO, width=w, height=h, num_volumes=4,
                                  num_volume_srcs=2))
        engine = MultiRayCaster(cfg, device=dev)
        engine.set_mesh(mesh_path)
        preset = engine.select_raster_preset((0.0, 6.0, 60.0))
        win = mesh_lib._shade_window(engine.config)
        log(f"[mesh_shade] {name}: preset {preset}, shade window {win}")
        check((preset, bool(win)) == (("far", True) if w == 1280
                                      else ("near", False)),
              f"{name}: preset {preset}, window {win}")
        cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
        probe = clone_state(engine.state)
        ops.reset_launches()
        with capture([(mesh_lib, "deferred_shade")]) as calls:
            frame_lib.render_frame(probe, cam, engine.config)
        torch.cuda.synchronize()
        launches[path] = dict(ops.LAUNCHES)
        log(f"[mesh_shade] {name}: the frame launched mesh_shade "
            f"{launches[path]['mesh_shade']} times")
        check(0 < launches[path]["mesh_shade"] <= 3,
              f"{name}: {launches[path]['mesh_shade']} mesh_shade launches "
              f"in the frame")
        a, k = calls["deferred_shade"]
        k = {key: v for key, v in k.items() if key != "impl"}
        row = compare_kernel(f"mesh_shade@{name}", mesh_lib.deferred_shade,
                             a, k,
                             allclose_tol(1e-4, 1e-4, f"mesh_shade@{name}"),
                             bound_mesh_shade, reps=(20, 2),
                             device_kernel=("mesh_planes_kernel",
                                            "mesh_shade_kernel"))
        fields, valid = mesh_lib.deferred_shade(*a, **k, impl="kernel")
        want, _ = mesh_lib.deferred_shade(*a, **k, impl="plain")
        torch.cuda.synchronize()
        n_diff = int(((fields - want) != 0).sum())
        log(f"[mesh_shade] {name}: {int(valid.sum())} of {valid.numel()} "
            f"pixels shaded; {n_diff} of {fields.numel()} elements differ "
            f"from plain at all")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mesh_lib.deferred_shade(*a, **k, impl="kernel")
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        log(f"[mesh_shade] {name}: one call launches {len(kernels)} "
            f"kernels: {kernels}")
        check(0 < len(kernels) <= 3, f"{name}: {len(kernels)} kernels a call")
        rows.append(row)
        del engine, probe, calls, a, fields, valid, want
        torch.cuda.empty_cache()
    return rows, launches


def bound_raster(args, kwargs):
    """B9: bytes, the clip positions and indices read once, the (T, 16)
    table and the sort key written once, the z-buffer (4 bytes a pixel)
    filled, its words read back once, the depth and ids (12 bytes a
    pixel) written; operations, a table row's 40 f32 operations a
    triangle, each coverage sample's 30 (stride, snap, barycentrics,
    depth, quantise) and each dense triangle's 25 a pixel it z-tests."""
    from multivolumes_tpu_torch.render import mesh as mesh_lib

    clip, idx, width, height = args[:4]
    n_tris = idx.shape[0]
    band = kwargs.get("band")
    rows = height // band[1] if band else height
    levers = {key: v for key, v in kwargs.items() if key != "impl"}
    _ordered, segments = mesh_lib.emit_segments(
        n_tris, levers.get("k", 4),
        levers.get("big_tiers", mesh_lib._BIG_TIERS),
        levers.get("capacity"), levers.get("dense_top", 0),
        levers.get("tail"), levers.get("small_tiers"))
    _lo, count, kk, _by_rank, start = segments[-1]
    emitted = start + count * kk * kk
    dense = mesh_lib.raster_samples(n_tris, width, height,
                                    **levers) - emitted
    nbytes = (_nbytes(clip, idx) + n_tris * (64 + 4)
              + rows * width * (4 + 4 + 12))
    return nbytes, 40.0 * n_tris + 30.0 * emitted + 25.0 * dense


def phase_raster(dev, mesh_path):
    """B9 against its plain version on the raster of a frame with the test
    torus (the demo's placement, 4 volumes) at 1280x800 from the orbit's
    first pose (the far preset, the 384 dense window) and at 2560x1440
    from the same pose (the near preset, the full screen): the
    `raster@<size>` rows (depth and ids equal), the kernels one call
    launches (profiler), and -> (rows, {path: launches}), the launch
    counts of the captured frame at each size under "raster_800p" and
    "raster_1440p"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import mesh as mesh_lib

    rows, launches = [], {}
    for (w, h), name, path in (((1280, 800), "1280x800-far", "raster_800p"),
                               ((2560, 1440), "2560x1440-near",
                                "raster_1440p")):
        cfg = RenderConfig(**dict(DEMO, width=w, height=h, num_volumes=4,
                                  num_volume_srcs=2))
        engine = MultiRayCaster(cfg, device=dev)
        engine.set_mesh(mesh_path)
        preset = engine.select_raster_preset((0.0, 6.0, 60.0))
        log(f"[raster] {name}: preset {preset}")
        check(preset == ("far" if w == 1280 else "near"),
              f"{name}: preset {preset}")
        cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
        probe = clone_state(engine.state)
        ops.reset_launches()
        with capture([(mesh_lib, "rasterize")]) as calls:
            frame_lib.render_frame(probe, cam, engine.config)
        torch.cuda.synchronize()
        launches[path] = dict(ops.LAUNCHES)
        log(f"[raster] {name}: the frame launched raster "
            f"{launches[path]['raster']} times")
        check(launches[path]["raster"] == 1,
              f"{name}: {launches[path]['raster']} raster launches in the "
              f"frame")
        a, k = calls["rasterize"]
        k = {key: v for key, v in k.items() if key != "impl"}
        row = compare_kernel(f"raster@{name}", mesh_lib.rasterize, a, k,
                             None, bound_raster, reps=(20, 2),
                             device_kernel=("raster_setup_kernel",
                                            "raster_emit_kernel",
                                            "raster_resolve_kernel"))
        depth, tri = mesh_lib.rasterize(*a, **k, impl="kernel")
        torch.cuda.synchronize()
        log(f"[raster] {name}: {int((tri >= 0).sum())} of {tri.numel()} "
            f"pixels covered; levers {k}")
        # three calls: a profile now and then drops its first event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                mesh_lib.rasterize(*a, **k, impl="kernel")
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        own = {b9: sum(1 for e in kernels if b9 in e)
               for b9 in ("raster_setup_kernel", "raster_emit_kernel",
                          "raster_resolve_kernel")}
        log(f"[raster] {name}: 3 calls launched {len(kernels)} device "
            f"operations, B9's {own} (the rest the argsort's): "
            f"{sorted(set(kernels))}")
        check(all(0 < n <= 3 for n in own.values()),
              f"{name}: B9 launched {own} in 3 calls")
        rows.append(row)
        del engine, probe, calls, a, depth, tri
        torch.cuda.empty_cache()
    return rows, launches


def _rel_err(g, w):
    """The largest |g - w|; fails beyond 1e-4 + 1e-4 |w| (B10's limit
    where the plain version is a matrix product)."""
    err = (g - w).abs()
    beyond = int((err > 1e-4 + 1e-4 * w.abs()).sum())
    check(beyond == 0, f"{beyond} of {g.numel()} elements beyond 1e-4 + "
          f"1e-4 rel (max {float(err.max()):.3e})")
    return float(err.max())


def light_b10(rho_light, tex_ids, ids, per_object, light_dir, step, axis,
              s_out_c, sout_cache, shadow_map=None, shadow_vp=None,
              impl=None):
    """B10 (prologue and occlusion launches) or its plain version on the
    same operands, B3's footprints `s_out_c` given -> (rho_o, du, dv,
    f_corr, t_ins[, sm_vol, z_entry, dz_slice, soft])."""
    from multivolumes_tpu_torch.ops import lightsweep_prep as prep_ops
    from multivolumes_tpu_torch.render import lightsweep as ls

    if impl == "kernel":
        prep = prep_ops.light_prologue(
            rho_light, tex_ids, ids, per_object, light_dir, step, axis,
            shadow_map=shadow_map, shadow_vp=shadow_vp)
        t_ins = prep_ops.light_occlusion(prep, s_out_c, sout_cache)
        return (prep.rho_o, prep.du, prep.dv, prep.f_corr, t_ins,
                *prep.sm.values())
    geo, rho_o, mv_in, mu_in, sm = ls.prologue_plain(
        rho_light[tex_ids[ids]], per_object, light_dir, step, axis, ids,
        shadow_map, shadow_vp)
    sout_cache[ids] = s_out_c
    t_ins = ls.occlusion_entry(geo, sout_cache, ids, mv_in, mu_in)
    return (rho_o, geo.du[ids], geo.dv[ids], geo.f_corr[ids], t_ins,
            *sm.values())


def light_b11(fields, prep, state, axis, ids, store, impl=None):
    """B11 with the stores into `store`'s (light maps, sweep stack), or
    its plain version on the same oriented fields -> the two stacks' rows
    at `ids`."""
    from multivolumes_tpu_torch.ops import lightsweep_prep as prep_ops
    from multivolumes_tpu_torch.render import lightsweep as ls
    from multivolumes_tpu_torch.scene.state import to_light_sweep

    maps, sweep = store
    st = state
    if impl == "kernel":
        prep_ops.light_epilogue(fields, prep, st.rho_light, st.ao_static,
                                st.grad_dir, st.vol_tex_ids, st.sh_coeffs,
                                st.ambient, st.light_color, True,
                                store=(maps, sweep, ids))
    else:
        tex = st.vol_tex_ids[ids]
        shadow = ls.orient_back(fields, prep.scal[5] != 0.0, axis)
        out = ls._shade_light_fields(shadow, st.rho_light[tex], tex,
                                     st.ao_static, st.grad_dir, st.sh_coeffs,
                                     st.ambient, st.light_color, True)
        maps[ids] = out
        sweep[ids] = to_light_sweep(out, sweep.dtype)
    return maps[ids], sweep[ids]


def bound_light_b10(args, kwargs):
    """B10: bytes, the cohort's density read and its oriented copy
    written, the footprints of every volume read once (B3's of the
    cohort, the cache's of the rest), t_ins written and, with the shadow
    map, the map's texels that the (2L)^2 grid's 4 taps read and the two
    entry planes written; operations: none counted (a few hundred per
    texel of t_ins, far under the bytes' time)."""
    rho_light, _tex, ids = args[:3]
    cache = args[8]
    c, l = ids.shape[0], rho_light.shape[1]
    nbytes = 2 * c * l ** 3 * 4 + _nbytes(cache) + c * l * l * 4
    sm = kwargs.get("shadow_map")
    if sm is not None:
        nbytes += min(sm.numel(), 4 * (2 * l) ** 2) * 4 + 2 * c * l * l * 4
    return nbytes, 0.0


def bound_light_b11(args, kwargs):
    """B11: bytes, B4's fields, the density, the AO and the three normal
    planes read, the f32 map rows (3 channels) and the sweep rows (4
    channels) written; operations, the SH irradiance and the shade (about
    45 a channel, 135 a voxel)."""
    fields, _prep, _st, _axis, _ids, store = args[:6]
    vox = fields.numel()
    sweep = store[1]
    return vox * 4 * 6 + vox * 3 * 4 + vox * 4 * sweep.element_size(), \
        135.0 * vox


def phase_light(dev, mesh_path):
    """B10 and B11 against their plain versions on the demo's cohort of
    one (frame 0's volume, N = 64, L = 96, the default light along z),
    without and with the test torus's 1024^2 shadow map: the
    `light_prologue@C1[-sm]` rows (B10's two launches: the geometry
    scalars and the density equal, t_ins and the entry planes within
    1e-4 + 1e-4 rel) and the `light_epilogue@C1[-sm]` rows (B11 on the
    same fields with its stores: equal), each with its kernels' device
    time; then the whole cohort update's host dispatch and device time
    through B10 / B11 against the plain glue around the same B3 / B4,
    and the demo frame's launches -> (rows, {"light": launches})."""
    import torch

    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.config import RenderConfig, SharedConsts
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import lightsweep as light_ops
    from multivolumes_tpu_torch.ops import lightsweep_prep as prep_ops
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import lightsweep as ls
    from multivolumes_tpu_torch.render import mesh as mesh_lib
    from multivolumes_tpu_torch.render.perframe import build_per_object
    from multivolumes_tpu_torch.scene.state import to_light_sweep

    cfg = RenderConfig(**dict(DEMO, shadow_map_size=1024))
    engine = MultiRayCaster(cfg, device=dev)
    engine.set_mesh(mesh_path)
    st = engine.state
    axis = ls.light_axis(st.light_pos)
    po = build_per_object(st.volume_worlds,
                          torch.eye(4, dtype=torch.float32, device=dev))
    ld = st.light_pos[:3] / torch.linalg.norm(st.light_pos[:3])
    step = SharedConsts.MAX_DIST / cfg.max_light_samples
    ids = frame_lib._cohort(cfg, 0, dev)
    vp = mesh_lib.shadow_view_proj(st)
    rows = []
    for tag, sm in (("", None), ("-sm", st.mesh_shadow_map)):
        smk = {} if sm is None else dict(shadow_map=sm, shadow_vp=vp)
        prep = prep_ops.light_prologue(st.rho_light, st.vol_tex_ids, ids,
                                       po, ld, step, axis, **smk)
        here, s_out_c = light_ops.light_self_scan(
            prep.rho_o, prep.du, prep.dv, prep.f_corr, **prep.sm)
        cache = st.light_sout.clone()
        a = (st.rho_light, st.vol_tex_ids, ids, po, ld, step, axis, s_out_c,
             cache)
        got = light_b10(*a, impl="kernel", **smk)
        want = light_b10(*a, impl="plain", **smk)
        torch.cuda.synchronize()
        for i in (0, 1, 2, 3) + ((7, 8) if sm is not None else ()):
            check(torch.equal(got[i], want[i]),
                  f"light_prologue{tag}: output {i} differs from plain")
        rows.append(compare_kernel(
            f"light_prologue@C1{tag}", light_b10, a, smk, _rel_err,
            bound_light_b10, reps=(50, 5),
            device_kernel=("light_prologue_kernel", "light_occlusion_kernel")))
        t_ins = prep_ops.light_occlusion(prep, s_out_c, cache)
        fields = light_ops.light_advect_mul(here, t_ins, prep.du, prep.dv)
        store = (st.light_maps.clone(), st.light_sweep.clone())
        rows.append(compare_kernel(
            f"light_epilogue@C1{tag}", light_b11,
            (fields, prep, st, axis, ids, store), {}, None, bound_light_b11,
            reps=(50, 5), device_kernel="light_epilogue_kernel"))

        # the whole cohort update: host dispatch (no sync) and device time
        def update(kernels, sm=sm):
            kw = {} if sm is None else dict(shadow_map=sm, shadow_vp=vp)
            if kernels:
                return ls.ray_march_light_sweep_update(
                    st.rho_light, st.ao_static, st.grad_dir, st.vol_tex_ids,
                    po, st.light_pos, st.light_color, st.ambient,
                    st.sh_coeffs, cfg.max_light_samples, axis, sub_ids=ids,
                    sout_cache=cache, store=(*store, ids), **kw)
            # the parent's path: the plain glue, shade and stores
            rho = st.rho_light[st.vol_tex_ids[ids]]
            shadow, _ = ls.light_transmittance(
                rho, po, ld, step, axis, sub_ids=ids, sout_cache=cache,
                **kw)
            maps = ls._shade_light_fields(
                shadow, rho, st.vol_tex_ids[ids], st.ao_static, st.grad_dir,
                st.sh_coeffs, st.ambient, st.light_color, True)
            store[0][ids] = maps
            store[1][ids] = to_light_sweep(maps, store[1].dtype)
            return maps

        for kernels in (False, True, True, False):
            host = []
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                update(kernels)
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            dev_ms = cuda_ms(lambda k=kernels: update(k), 20)
            log(f"[light] cohort update{tag} "
                f"{'B10/B11' if kernels else 'plain glue'}: host dispatch "
                f"median {sorted(host)[10]:.3f} ms, call {dev_ms:.3f} ms "
                f"(events)")
    cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
    probe = clone_state(st)
    ops.reset_launches()
    frame_lib.render_frame(probe, cam, engine.config)
    torch.cuda.synchronize()
    launches = {"light": dict(ops.LAUNCHES)}
    check(all(launches["light"][k] == 1 for k in (
        "light_prologue", "light_occlusion", "light_epilogue")),
        f"the mesh frame's light launches {launches['light']}")
    del engine, probe
    torch.cuda.empty_cache()
    return rows, launches


def bound_partition(args, kwargs):
    """B12: bytes, the cull rows, source ids, matrices, eye and basis read
    once and its 196 bytes a volume of outputs written once; operations,
    about 300 f32 operations a volume (the eye, its local basis, six
    faces' homography rows and their flags), the rank's compares not
    counted."""
    cull, po, eye, tex = args[:4]
    n = tex.shape[0]
    nbytes = (_nbytes(*cull, tex, po.world_i, po.world_view_proj, eye)
              + 36 + 196 * n)
    return nbytes, 300.0 * n


def bound_store(args, kwargs):
    """B13: bytes, B1's f32 output of the bucket read once, its run mask
    and flags, the rows written once in the colour's dtype; operations,
    two products a texel and channel."""
    scatter, run, swap, color = args[:4]
    return (_nbytes(scatter, run, swap) + scatter.numel()
            * color.element_size(), 2.0 * scatter.numel())


def phase_partition(dev, mesh_path):
    """B12 and B13 against their plain versions on the demo's frame (N =
    64, 1280x800, the orbit's first pose, the tile composite's contract):
    the `lod_partition@N64` row (every output equal) and the
    `lod_store@S<size>` rows, one a LOD bucket on B1's output of that
    bucket (the colour stack equal), each with its kernel's device time;
    then the LOD sweep's host dispatch and device time through B12 / B13
    against their plain versions around the same B7 / B1, without and
    with the torus's depth map, and the frame's launches -> (rows,
    {"partition": launches})."""
    import torch

    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import lod_partition as lod_ops
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_lib

    cfg = RenderConfig(**DEMO)
    engine = MultiRayCaster(cfg, device=dev)
    engine.set_mesh(mesh_path)
    cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
    probe = clone_state(engine.state)
    ops.reset_launches()
    with capture([(sweep_lib, "ray_march_view_sweep_lod"),
                  (sweep_lib, "sweep_march")]) as calls:
        frame_lib.render_frame(probe, cam, engine.config)
    torch.cuda.synchronize()
    launches = {"partition": dict(ops.LAUNCHES)}
    n_buckets = len(calls["sweep_march*"])
    log(f"[partition] the mesh frame launched {launches['partition']}")
    check(launches["partition"]["lod_partition"] == 1
          and launches["partition"]["lod_store"] == n_buckets == 3,
          f"the frame's partition launches {launches['partition']}")
    a, k = calls["ray_march_view_sweep_lod"]
    (_vols, tex, _light, po, cull, eye, s, basis) = a[:8]
    buckets = sweep_lib.lod_buckets(tex.shape[0], s, k["bucket_caps"])
    rows = [compare_kernel(
        "lod_partition@N64", lod_ops.partition,
        (cull, po, eye, tex, s, buckets, basis), {}, None, bound_partition,
        reps=(50, 5), device_kernel="lod_partition_kernel")]

    part = lod_ops.partition(cull, po, eye, tex, s, buckets, basis)
    color = torch.zeros((tex.shape[0], 6, 4, s, s),
                        dtype=engine.state.volumes_sweep.dtype, device=dev)
    for (b0, count, size_b, _mip_b), (ba, _bk) in zip(
            buckets, calls["sweep_march*"]):
        name = f"lod_store@S{size_b}"
        scatter = sweep_lib.sweep_march(*ba, **dict(_bk))
        sl = slice(b0, b0 + count)
        store = (scatter, part.run[sl], part.swap[sl], color, sl)
        got, want = color.clone(), color.clone()
        lod_ops.bucket_store(scatter.clone(), *store[1:3], got, sl,
                             impl="kernel")
        lod_ops.bucket_store(scatter.clone(), *store[1:3], want, sl,
                             impl="plain")
        torch.cuda.synchronize()
        differ = (got != want) & ~(got.isnan() & want.isnan())
        check(not bool(differ.any()), f"{name}: {int(differ.sum())} "
              f"elements differ from the plain version")
        ms = cuda_ms(lambda: lod_ops.bucket_store(*store, impl="kernel"), 50)
        plain_ms = cuda_ms(lambda: lod_ops.bucket_store(
            scatter.clone(), *store[1:], impl="plain"), 5)
        nbytes, flops = bound_store(store, {})
        bound_ms = max(nbytes / MEM_RATE, flops / F32_RATE) * 1e3
        row = {"name": name, "route": "cuda",
               "source": KERNELS["lod_store"][0],
               "replaces": KERNELS["lod_store"][1], "max_abs_err": 0.0,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "library_ms": None,
               "device_ms": device_ms(lambda: lod_ops.bucket_store(
                   *store, impl="kernel"), "lod_store_kernel")}
        log(f"[kernel] {name}: equal to plain; kernel {ms:.3f} ms (dev "
            f"{row['device_ms']}), plain {plain_ms:.3f} ms (with the "
            f"scatter's copy), bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB)")
        rows.append(row)

    # the whole LOD sweep: host dispatch (no sync) and device time, B12 /
    # B13 against their plain versions around the same B7 / B1
    kernels = (lod_ops.partition, lod_ops.bucket_store)

    def plain_glue():
        lod_ops.partition = lambda *pa, **pk: kernels[0](
            *pa, **dict(pk, impl="plain"))
        lod_ops.bucket_store = lambda *pa, **pk: kernels[1](
            *pa, **dict(pk, impl="plain"))

    for tag, kw in (("", dict(k, depth_map=None)), ("-depth", k)):
        for glue in ("plain", "B12/B13", "B12/B13", "plain"):
            if glue == "plain":
                plain_glue()
            try:
                host = []
                for _ in range(21):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    sweep_lib.ray_march_view_sweep_lod(*a, **kw)
                    host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                call_ms = cuda_ms(
                    lambda: sweep_lib.ray_march_view_sweep_lod(*a, **kw), 20)
            finally:
                lod_ops.partition, lod_ops.bucket_store = kernels
            log(f"[partition] LOD sweep{tag} with the {glue} glue: host "
                f"dispatch median {sorted(host)[10]:.3f} ms, call "
                f"{call_ms:.3f} ms (events)")
    del engine, probe, calls, a, color, part
    torch.cuda.empty_cache()
    return rows, launches


def scan_numbers(light_ops, name, c, l, has_sm, dev, advect=False):
    """Log how the self scan (`advect`: the advect-multiply, B4) of (c, l)
    launches (cluster size, band, threads, shared memory, registers, CTAs
    per SM) and the floor of its dependent chain: the device time of the
    same launch with an empty body (l cluster barriers), at the planned
    cluster size and, for one volume's self scan, at the smaller ones."""
    info = light_ops.scan_launch_info(c, l, has_sm, advect=advect)
    log(f"[occupancy] {name} (C={c}, L={l}): {info}")
    sizes = [0] + ([s for s in (2, 4) if s < info["cluster"]]
                   if c == 1 and not advect else [])
    floors = {s or info["cluster"]: device_ms(
        lambda s=s: light_ops.scan_chain_floor(c, l, has_sm, dev, s,
                                               advect=advect),
        "self_scan_kernel", reps=10) for s in sizes}
    log(f"[floor] {name}: {l} barriers and an empty body, device ms by "
        f"cluster size: {floors}")
    return floors


def composite_numbers(args, kwargs, name):
    """Log how the composite launches (registers, CTAs per SM, shared
    memory, spills), its (pixel, listed volume) pairs and, for the depth
    variant, the device time of its per-tile mesh vote alone."""
    import torch

    from multivolumes_tpu_torch.ops import composite as composite_ops

    color, _scene, tlist, counts, _vf, _ff, th, tw = args[:8]
    depth = kwargs.get("depth_sel") is not None
    info = composite_ops.composite_launch_info(
        color.dtype == torch.bfloat16, depth)
    log(f"[occupancy] {name} ({color.dtype}): {info}")
    log(f"  {name}: {tlist.shape[0]} tiles, list length mean "
        f"{float(counts.float().mean()):.2f} max {int(counts.max())}, "
        f"{int(counts.sum()) * th * tw} (pixel, listed volume) pairs")
    if depth:
        vote = device_ms(lambda: composite_ops.tile_composite(
            *args, **dict(kwargs, impl="kernel")), "mesh_tile_kernel")
        log(f"  {name}: the mesh vote alone, device ms {vote}")


def penumbra(args, kwargs):
    """(C,) int: per cohort volume, the texels the light reaches where the
    shadow map's lit (here with the map over here without it, plain
    versions) lies strictly between 0.01 and 0.99."""
    from multivolumes_tpu_torch.ops import lightsweep as light_ops

    with_sm = light_ops.light_self_scan(*args, **kwargs, impl="plain")[0]
    without = light_ops.light_self_scan(*args, impl="plain")[0]
    lit = with_sm / without.clamp(min=1e-30)
    return ((without > 1e-4) & (lit > 0.01) & (lit < 0.99)).flatten(1).sum(1)


# (channel, row, column) of the NaN colours of `taa_synthetic(with_nan=True)`
# in cur (each spreads to its 3 x 3 neighbourhood, one through the corner's
# edge clamp) and in hist (the NaN guard takes the filtered colour there);
# negative rows and columns count from the end
CUR_NAN = ((0, 100, 100), (2, -1, -1), (1, 400, 0))
HIST_NAN = ((1, 200, 300), (0, 0, 0), (2, -1, 640))


def taa_synthetic(dev, h, w, seed=0, with_nan=False):
    """Seeded B5 operands that reach the history blend, independent per
    pixel (`tools.kernel_variants.taa_synthetic`: half the alpha at 1, a
    random history with some full counts, a non-zero blur on half the
    pixels); with `with_nan`, NaN colours at CUR_NAN and HIST_NAN."""
    from multivolumes_tpu_torch.tools import kernel_variants

    cur, hist, blur = kernel_variants.taa_synthetic(dev, h, w, seed)
    if with_nan:
        for c, y, x in CUR_NAN:
            cur[c, y, x] = float("nan")
        for c, y, x in HIST_NAN:
            hist[c, y, x] = float("nan")
    return cur, hist, blur


def taa_nan_check(out):
    """B5's new history on `taa_synthetic(with_nan=True)`: NaN on the 3 x 3
    neighbourhood of each NaN colour of cur and nowhere else, finite at
    the NaN histories (the NaN guard fired)."""
    import torch

    _, h, w = out.shape
    want = torch.zeros((h, w), dtype=torch.bool, device=out.device)
    for _c, y, x in CUR_NAN:
        y, x = y % h, x % w
        want[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2] = True
    got = out[:3].isnan().any(0)
    log(f"  taa@synthetic+nan: {int(got.sum())} pixels NaN (expected "
        f"{int(want.sum())}); at the NaN histories "
        f"{[out[:3, y % h, x % w].tolist() for _c, y, x in HIST_NAN]}")
    check(torch.equal(got, want), "B5: NaN outside the NaN colours' taps")
    check(all(bool(torch.isfinite(out[:3, y % h, x % w]).all())
              for _c, y, x in HIST_NAN), "B5: the NaN guard did not fire")


def taa_band_edges(taa_ops, dev):
    """B5' bit for bit on the two bands of a 1283 x 803 image (402 and 401
    rows: no tile height divides either), as the first and as the last
    band, and the two together against B5 on the whole image."""
    import torch

    from multivolumes_tpu_torch.tools.kernel_variants import band_operands

    ops_in = taa_synthetic(dev, 803, 1283, seed=1)
    whole = taa_ops.taa_resolve(*ops_in, impl="kernel")
    rows, parts = [], []
    for what, (y0, y1) in zip(("first", "last"), taa_ops.row_bands(803, 2)):
        band = band_operands(*ops_in, y0, y1)
        rows.append(compare_kernel(
            f"taa_band@{what}-{y1 - y0}", taa_ops.taa_resolve_band, band, {},
            None, bound_taa_band, reps=(20, 3),
            device_kernel="taa_resolve_kernel"))
        parts.append(taa_ops.taa_resolve_band(*band, impl="kernel"))
    check(torch.equal(torch.cat(parts, 1), whole),
          "the 402- and 401-row bands differ from B5 on the whole image")
    log("  taa_band: the 402- and 401-row bands equal B5 on the whole "
        "1283x803 image")
    return rows


def drive(what, fn, frames, kernels):
    """Run fn() (which renders `frames` frames and returns the images) with
    the launch counts set to 0 just before and read just after; every
    kernel of the path must have launched."""
    import torch

    from multivolumes_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / frames
    launches = dict(ops.LAUNCHES)
    log(f"[demo] {what}: {ms:.3f} ms/frame, mean of {frames} frames (host "
        f"clock); launches {launches}")
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the {what} frames")
    return out, launches


def phase_demo(engine, cfg, dev, kernels, frames: int = 8,
               closeup: bool = False, what=None):
    """Drive the main path through the engine, frame by frame and as one
    block from the same starting state; return the launch counts of the
    frame-by-frame run. With a mesh, the raster preset is picked before
    each frame from the host-side orbit eye, as the app does, and with
    `closeup` one more frame is rendered close enough for the near
    preset."""
    import numpy as np
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.utils.timing import profile_frame

    what = what or ("mesh demo" if engine.has_mesh else "demo")
    times_s = [0.25 * i for i in range(frames)]
    cams = [cam_lib.orbit_camera(tm, cfg.aspect_ratio, device=dev)
            for tm in times_s]
    eyes = [(np.sin(tm * 0.5) * 60.0, 6.0, np.cos(tm * 0.5) * 60.0)
            for tm in times_s]
    start = clone_state(engine.state)
    start_config = engine.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, presets = [], []

    def render_each():
        imgs = []
        for cam, eye in zip(cams, eyes):
            t0 = time.perf_counter()
            if engine.has_mesh:
                presets.append(engine.select_raster_preset(eye))
            imgs.append(engine.render(cam))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return imgs

    seq, launches = drive(f"{what} render", render_each, frames, kernels)
    # the copy of the starting state kept for render_block is not the
    # path's own memory
    copy_bytes = sum(getattr(start, f.name).nbytes
                     for f in dataclasses.fields(start)
                     if isinstance(getattr(start, f.name), torch.Tensor))
    peak = torch.cuda.max_memory_allocated() - copy_bytes
    log(f"[demo] {what} render ms/frame (host clock, sync per frame): "
        + " ".join(f"{t:.2f}" for t in times))
    steady = sorted(times[1:])
    log(f"[demo] {what} render median {steady[len(steady) // 2]:.3f} "
        f"ms/frame over frames 2-{frames}; peak memory "
        f"{peak / 2**30:.3f} GiB (without the {copy_bytes / 2**30:.3f} GiB "
        f"copy of the starting state)")
    img = seq[-1]
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"non-finite {what} image")
    if presets:
        log(f"[demo] {what} raster presets {presets}")
        check(len(set(presets)) == 1, "the orbit changed the raster preset")
    end_state = engine.state

    # the block renders every camera at one config: the orbit's preset
    engine.state = clone_state(start)
    engine.config = start_config
    if engine.has_mesh:
        engine.select_raster_preset(eyes[0])
    del start
    block, _ = drive(f"{what} render_block",
                     lambda: engine.render_block(cams), frames, kernels)
    check(tuple(block.shape) == (frames, 3, cfg.height, cfg.width),
          f"block shape {tuple(block.shape)}")
    check(engine.state.frame_idx == end_state.frame_idx,
          "render_block advanced the state by another frame count")
    for f in range(frames):
        allclose_tol(2e-5, 0.0, f"{what} render_block frame {f} vs render")(
            block[f].permute(1, 2, 0), seq[f])
    del block, seq

    # per-pass host ms of one more frame (its spans), then a frame for
    # the image checks
    passes = profile_frame(engine.state, cams[-1], engine.config, iters=1)
    log(f"[demo] {what} per pass (ms): " + " ".join(
        f"{n} {t:.3f}" for n, t in passes.items()))
    out = frame_lib.render_frame(engine.state, cams[-1], engine.config)
    engine.state = out.state
    alpha = out.hdr[..., 3]
    if engine.has_mesh:
        check("mesh" in passes, "the frame did not run the mesh pass")
        # mesh pixels are opaque (alpha 1 to rounding); the volumes' OIT
        # alpha is capped at 0.9997
        mesh_cover = float((alpha > 0.9998).float().mean())
        log(f"[demo] the mesh covers {mesh_cover:.4f} of the pixels")
        check(mesh_cover > 0.0, "the mesh covers no pixel")
    cover = float(((alpha > 0.05) & (alpha <= 0.9998)).float().mean())
    log(f"[demo] {what} volume alpha > 0.05 on {cover:.3f} of pixels")
    check(cover > 0.02, f"volume coverage {cover:.4f} too small")

    profile_frames(engine, cams, eyes, what)

    if closeup:
        # a close-up along the demo's orbit direction, for the near preset
        eye = (0.0, 6.0, 30.0)
        preset = engine.select_raster_preset(eye)
        cam = cam_lib.make_camera(list(eye), [0.0, 0.0, 0.0],
                                  cfg.aspect_ratio, device=dev)
        t0 = time.perf_counter()
        img = engine.render(cam)
        torch.cuda.synchronize()
        log(f"[demo] {what} close-up: preset {preset}, "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
        check(preset == "near", f"the close-up picked {preset}")
        check(bool(torch.isfinite(img).all()), "non-finite close-up image")
    return launches


def profile_frames(engine, cams, eyes, what, frames: int = 2, mesh=None):
    """Two more frames under `torch.profiler`: the device's busy time and
    kernels per frame, and for each pass its host time and the device time
    of the kernels launched inside it (the profiler ties each kernel to
    the host op that launched it, so the hand kernels, launched through
    ctypes under no op, are left out: `tools/trace_ops.py` ties them by
    their launch calls), and the kernels that take the most
    device time. With a device `mesh`, `engine.state` is a sharded state
    and the frames are the sharded step's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.utils.timing import SPAN_PREFIX

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for cam, eye in list(zip(cams, eyes))[:frames]:
            if engine.has_mesh:
                engine.select_raster_preset(eye)
            out = frame_lib.render_frame(engine.state, cam, engine.config,
                                         mesh=mesh)
            engine.state = out.state
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    events = list(prof.events())
    kernels = sorted(
        (e for e in events if e.device_type == DeviceType.CUDA
         and not e.name.startswith(SPAN_PREFIX)
         and not e.name.startswith(("Memcpy", "Memset"))),
        key=lambda e: e.time_range.start)
    # the passes: the frame spans' ranges (the frame's recorder opens them
    # while a profiler records)
    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(SPAN_PREFIX) and e.cpu_parent is not None
              and e.cpu_parent.name == SPAN_PREFIX + "frame"]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / frames
    if busy <= 0.0:
        log(f"[profile] {what}: the profiler recorded no device time "
            f"(device busy share not measured)")
        return
    log(f"[profile] {what}: {wall:.3f} ms/frame on the host clock "
        f"(profiled), device busy {busy:.3f} ms/frame in "
        f"{len(kernels) / frames:.0f} kernels/frame "
        f"({busy / wall:.3f} of the frame)")
    per = {}
    for r in ranges:
        p = per.setdefault(r.name[len(SPAN_PREFIX):], [0.0, 0.0])
        p[0] += r.time_range.elapsed_us() / 1e3 / frames
        p[1] += r.device_time_total / 1e3 / frames
    log(f"[profile] {what} per pass (host ms / device ms per frame; device "
        f"ms of the passes {sum(d for _h, d in per.values()):.3f}): "
        + "; ".join(f"{n} {h:.3f} / {d:.3f}" for n, (h, d) in per.items()))
    by_name = {}
    for e in kernels:
        b = by_name.setdefault(e.name, [0.0, 0])
        b[0] += e.time_range.elapsed_us() / 1e3 / frames
        b[1] += 1
    sweeps = [e.time_range.elapsed_us() / 1e3 for e in kernels
              if "sweep_kernel" in e.name]
    log(f"[profile] {what} B1 launches in order (device ms, "
        f"{len(sweeps) // frames} per frame, one per LOD bucket): "
        + " ".join(f"{t:.3f}" for t in sweeps))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"[profile] {what} top kernels (device ms per frame, launches per "
        f"frame): " + "; ".join(f"{n[:60]} {t:.3f} x{c / frames:.0f}"
                                for n, (t, c) in top))


def phase_reference(cfg, dev, frames: int = 2, profile: bool = False):
    """The demo cell outside the main path's settings: (1) un-bucketed
    (`lod_bucket_caps=None`) with the warp composite, through `render` and
    `render_block` like the main path, its one B1 launch of every volume
    at the full resolution held against the plain version; (2) in full
    reference semantics (reference march and light, gather composite),
    two frames with per-pass times and peak memory; (3) the same with
    rotated volume worlds set through the engine, which the sweep light
    path refuses. With `profile`, one more frame of (2) under the
    profiler. Returns (the B1 row, the launch counts of (1))."""
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import sweep as sweep_ops
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod

    cfg_u = cfg.with_(composite_mode="warp", lod_bucket_caps=None)
    t0 = time.time()
    engine = MultiRayCaster(cfg_u, device=dev)
    torch.cuda.synchronize()
    log(f"[reference] un-bucketed warp scene built in {time.time() - t0:.1f}"
        f" s")
    cam0 = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
    with capture([(sweep_mod, "sweep_march")]) as calls:
        frame_lib.render_frame(clone_state(engine.state), cam0,
                               engine.config)
    (a, k) = calls["sweep_march"]
    check(len(calls["sweep_march*"]) == 1, "the un-bucketed frame launched "
          f"B1 {len(calls['sweep_march*'])} times")
    k = dict(k)
    k.pop("impl", None)
    check(a[2].shape[0] == cfg.num_volumes and a[8] == cfg.cube_map_size
          and a[7] == (cfg.sweep_planes or cfg.cube_map_size),
          f"un-bucketed B1 launch: {a[2].shape[0]} volumes, S={a[8]}, "
          f"{a[7]} planes")
    info = sweep_ops.sweep_launch_info(a[8], a[7], a[0].shape[1],
                                       a[1].shape[1],
                                       a[0].dtype == torch.bfloat16)
    log(f"[occupancy] sweep@unbucketed ({a[0].dtype}): {info}")
    results = [compare_kernel(
        "sweep@unbucketed", sweep_mod.sweep_march, a, k,
        allclose_tol(B1_ATOL, 0.0, "sweep@unbucketed"),
        bound_sweep, reps=(5, 1), device_kernel="sweep_kernel")]
    del calls, a, k
    launches = phase_demo(engine, cfg_u, dev, UNBUCKETED, frames=frames,
                          what="un-bucketed warp demo")
    worlds = engine.state.volume_worlds.cpu().numpy()
    try:
        engine.set_volume_world(0, float(worlds[0, 0, 0]) * 2.0,
                                worlds[0, 3, :3], rotation_y=0.5)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the sweep light path took a rotated volume world")
    del engine
    torch.cuda.empty_cache()

    cfg_r = cfg.with_(march_mode="reference", light_mode="reference",
                      composite_mode="gather")
    engine = MultiRayCaster(cfg_r, device=dev)
    for rotated in (False, True):
        what = "reference" + (", rotated" if rotated else "")
        if rotated:
            for i in range(cfg.num_volumes):
                engine.set_volume_world(i, float(worlds[i, 0, 0]) * 2.0,
                                        worlds[i, 3, :3],
                                        rotation_y=0.35 + 0.1 * i)
            check(abs(float(engine.state.volume_worlds[5, 0, 2])) > 0.1,
                  "the volume worlds are not rotated")
        cams = [cam_lib.orbit_camera(0.25 * f, cfg.aspect_ratio, device=dev)
                for f in range(frames)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        passes, imgs = [], []

        def render_each():
            for cam in cams:
                events = []

                def mark(name):
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    events.append((name, ev))

                out = frame_lib.render_frame(engine.state, cam,
                                             engine.config, timer=mark)
                engine.state = out.state
                torch.cuda.synchronize()
                passes.append({events[i][0]: events[i][1].elapsed_time(
                    events[i + 1][1]) for i in range(len(events) - 1)})
                imgs.append(out)
            return imgs

        outs, ref_launches = drive(what, render_each, frames, REFERENCE)
        others = {n: c for n, c in ref_launches.items()
                  if c and n not in REFERENCE}
        check(not others, f"the {what} frames launched {others}")
        for f, p in enumerate(passes):
            log(f"[reference] {what} frame {f} per pass (ms, CUDA events): "
                + " ".join(f"{nm} {tm:.3f}" for nm, tm in p.items())
                + f"; total {sum(p.values()):.3f}")
        log(f"[reference] {what} peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        img, alpha = outs[-1].image, outs[-1].hdr[..., 3]
        check(tuple(img.shape) == (cfg.height, cfg.width, 3),
              f"{what} image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"non-finite {what} image")
        cover = float(((alpha > 0.05) & (alpha <= 0.9998)).float().mean())
        log(f"[reference] {what}: volume alpha > 0.05 on {cover:.3f} of "
            f"pixels")
        check(cover > 0.02, f"{what}: volume coverage {cover:.4f} too small")
        if profile and not rotated:
            profile_frames(engine, cams, [None] * frames, what, frames=1)
    del engine
    torch.cuda.empty_cache()
    return results, launches


def phase_golden(dev, frames: int = 2):
    """The pinned `reference_4vol` golden (tests/goldens/, the JAX
    package's reference-semantics render on the CPU) rendered on the card:
    its config as tools/make_goldens.py states it, the orbit camera at
    f/60 with TAA, mean < 2e-3 and p99.9 < 3e-2
    (tests/test_goldens.py:37-41)."""
    import numpy as np
    import torch

    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.scene import state as state_lib

    cfg = RenderConfig(
        width=160, height=96, grid_size=16, light_grid_size=8,
        max_ray_samples=24, max_light_samples=8, num_volumes=4,
        num_volume_srcs=2, cube_map_size=16, shadow_map_size=64,
        use_bf16=False, march_mode="reference", light_mode="reference",
        composite_mode="gather", packed_composite=False)
    state = state_lib.create_scene(cfg, device=dev)
    for f in range(frames):
        out = frame_lib.render_frame(
            state, cam_lib.orbit_camera(f / 60.0, cfg.aspect_ratio,
                                        device=dev), cfg, use_taa=True)
        state = out.state
    got = out.image.float().cpu().numpy()
    path = os.path.join(HERE, "tests", "goldens", "reference_4vol.npz")
    want = np.load(path)["image"].astype(np.float32)
    check(got.shape == want.shape, f"golden shape {got.shape}")
    diff = np.abs(got - want)
    mean, p999 = float(diff.mean()), float(np.percentile(diff, 99.9))
    log(f"[golden] reference_4vol on the card: mean {mean:.3e}  p99.9 "
        f"{p999:.3e}  max {float(diff.max()):.3e}")
    check(mean < 2e-3 and p999 < 3e-2,
          f"reference_4vol: mean {mean:.3e} (< 2e-3), p99.9 {p999:.3e} "
          f"(< 3e-2)")


def phase_small(small, dev, frames: int = 3, mesh_path=None):
    """Three frames with TAA rendered with impl="kernel" and with
    impl="plain" from the same state, each held to the golden-image
    tolerance; with `mesh_path`, with the mesh."""
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib

    what = "small frame" + (" with the mesh" if mesh_path else "")
    eng_s = MultiRayCaster(small, device=dev)
    if mesh_path:
        eng_s.set_mesh(mesh_path)
    st_k, st_p = clone_state(eng_s.state), clone_state(eng_s.state)
    for f in range(frames):
        cam = cam_lib.orbit_camera(0.7 + f / 60.0, small.aspect_ratio,
                                   device=dev)
        out_k = frame_lib.render_frame(st_k, cam, eng_s.config,
                                       impl="kernel")
        out_p = frame_lib.render_frame(st_p, cam, eng_s.config, impl="plain")
        st_k, st_p = out_k.state, out_p.state
        image_tol(2e-3, 99.9, 3e-2, f"{what} {f} kernel vs plain")(
            out_k.image, out_p.image)
        check(bool(torch.isfinite(out_k.image).all()), f"non-finite {what}")
    if mesh_path:
        check(bool((out_k.hdr[..., 3] > 0.9998).any()),
              "the mesh is not in the small frames")


def phase_sharded(cfg, dev, mesh_engine, frames: int = 3):
    """The sharded frame step at the demo scale on logical shards of the
    card (2 rows x 4 volume shards), and on the machine's cards when it
    has several; then, on `mesh_engine` (the demo scene with the test
    mesh), the same with the opaque mesh (`sharded_mesh_frames`). Returns
    (the summary rows of B5', the band composite and its depth variant,
    the launch counts of the sharded frames, those of the sharded frames
    with the mesh)."""
    import torch

    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import taa as taa_ops
    from multivolumes_tpu_torch.parallel import sharding
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import tilecast as tile_mod

    engine = MultiRayCaster(cfg, device=dev)
    config = engine.config
    cams = [cam_lib.orbit_camera(0.25 * i, cfg.aspect_ratio, device=dev)
            for i in range(frames)]
    single, state = [], clone_state(engine.state)
    for cam in cams:
        out = frame_lib.render_frame(state, cam, config)
        state = out.state
        single.append(out.image)
    del state
    torch.cuda.synchronize()

    card = torch.device("cuda", 0)
    meshes = [("2 rows x 1 volume shard of one card",
               sharding.make_mesh([card] * 2, rows=2)),
              ("2 rows x 4 volume shards of one card",
               sharding.make_mesh([card] * 8, rows=2))]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, 4) // 2
                                                        * 2)]
        meshes.append((f"{len(cards)} cards, one volume shard each",
                       sharding.make_mesh(cards)))
    results, launches = [], None
    for what, mesh in meshes:
        step = sharding.make_sharded_step(config, mesh)
        state = sharding.shard_state(clone_state(engine.state), mesh)
        has_rows = "rows" in mesh.axis_names
        targets = [(taa_ops, "taa_resolve_band"),
                   (tile_mod, "tile_composite")]
        images = []

        def run():
            nonlocal state
            for cam in cams:
                mesh.log.clear()
                img, state = step(state, cam)
                images.append(img)
            return images

        with capture(targets) as calls:
            _, counted = drive(f"sharded step ({what})", run, frames,
                               SHARDED if has_rows else NO_MESH)
        check(state.frame_idx == frames, f"frame_idx {state.frame_idx}")
        moved = " ".join(f"{n} {e} ({b} B)" for n, e, b in mesh.log)
        log(f"[sharded] movements of the last frame (name elements "
            f"(bytes)): {moved}")
        n_vol_shards = mesh.n_volumes_axis
        check(counted["sweep"] >= n_vol_shards * frames,
              f"{counted['sweep']} sweeps for {n_vol_shards} volume shards")
        for f, (img, want) in enumerate(zip(images, single)):
            check(img.device == mesh.root, f"image on {img.device}")
            if n_vol_shards == 1:
                # the bands alone: the same LOD buckets, the same frame
                err = allclose_tol(2e-5, 0.0, f"{what}, frame {f} vs "
                                   f"unsharded")(img, want)
                log(f"  {what}, frame {f} vs unsharded: max {err:.3e}")
            else:
                # each volume shard fills its own LOD buckets (the caps
                # divided by the shards), so some volumes march at another
                # resolution than in the unsharded frame: the golden mean,
                # and a p99.9 that allows their edges
                image_tol(2e-3, 99.9, 1e-1, f"{what}, frame {f} vs "
                          f"unsharded")(img, want.to(img.device))
        if not has_rows or n_vol_shards == 1:
            continue
        launches = counted
        check(counted["taa_band"] == mesh.rows * frames
              and counted["composite_band"] == mesh.rows * frames,
              f"band launches {counted}")
        # B5' on the last frame's lower band (its history is not zero)
        (a, _k) = calls["taa_resolve_band*"][-1]
        check(float(a[1][3].min()) > 0.0, "the band's history is still zero")
        results.append(compare_kernel(
            "taa_band", taa_ops.taa_resolve_band, a, {}, None,
            bound_taa_band, reps=(20, 3),
            device_kernel="taa_resolve_kernel"))
        # the band composite on the last frame's lower band of tile rows
        (a, k) = calls["tile_composite*"][-1]
        k = {name: x for name, x in k.items() if name != "impl"}
        check(k["tile_row0"] > 0, f"tile_row0 {k['tile_row0']}")
        results.append(compare_kernel(
            "composite@band", tile_mod.tile_composite, a, k,
            allclose_tol(1e-4, 1e-4, "composite@band"), bound_composite,
            reps=(10, 1), device_kernel=COMPOSITE_KERNELS))
        # the bands assemble the unbanded results bit for bit
        (a, _k) = calls["taa_resolve_band*"][-2]
        (b, _k) = calls["taa_resolve_band*"][-1]
        cur = torch.cat([a[0][:, 1:-1], b[0][:, 1:-1]], 1)
        hist, blur = torch.cat([a[1], b[1]], 1), torch.cat([a[2], b[2]], 0)
        whole = taa_ops.taa_resolve(cur, hist, blur, impl="kernel")
        banded = taa_ops.taa_resolve_sharded(mesh, cur, hist, blur,
                                             impl="kernel")
        check(torch.equal(whole, banded),
              "the band resolves differ from B5 on the whole image")
        del calls
    del engine, state, images, single

    mesh_results, mesh_launches = sharded_mesh_frames(
        mesh_engine, dev, [m for m in meshes if "rows" in m[1].axis_names],
        frames)
    results += mesh_results
    for shard_light in (False, True):
        r = sharding.placement_check(8, shard_light=shard_light, device=dev)
        log(f"[sharded] placement_check(8, shard_light={shard_light}): cube "
            f"gather {r['cube_gather_elems']} elements, largest movement "
            f"{r['largest_elems']}; {[c[:2] for c in r['collectives']]}")
    sharding.dryrun(8, device=dev)
    log("[sharded] dryrun(8) on the card: ok")
    check(launches is not None, "no mesh with a rows axis was driven")
    return results, launches, mesh_launches


def shard_sweep_rows(what, calls, n_vol_shards, sweep_mod, sweep_ops):
    """Each B1 launch in `calls` (one sharded frame's sweeps, captured in
    order) against its plain version (`B1_ATOL`): the rows
    `sweep@shard-S<size>-d<shard>`."""
    import torch

    lods = calls["ray_march_view_sweep_lod*"]
    check(len(lods) == n_vol_shards
          and all(k.get("depth_map") is not None for _a, k in lods),
          f"{what}: {len(lods)} shard sweeps, depth maps "
          f"{[k.get('depth_map') is not None for _a, k in lods]}")
    rows, shard, marches = [], -1, iter(calls["sweep_march*"])
    for name in calls["#"]:
        if name == "ray_march_view_sweep_lod":
            shard += 1
            continue
        a, k = next(marches)
        k = {n: x for n, x in k.items() if n != "impl"}
        info = sweep_ops.sweep_launch_info(
            a[8], a[7], a[0].shape[1], a[1].shape[1],
            a[0].dtype == torch.bfloat16)
        log(f"[kernel] {what}: shard {shard} bucket S={a[8]}: "
            f"{a[2].shape[0]} volumes; {info}")
        name = f"sweep@shard-S{a[8]}-d{shard}"
        rows.append(compare_kernel(
            name, sweep_mod.sweep_march, a, k,
            allclose_tol(B1_ATOL, 0.0, name),
            bound_sweep, reps=(10, 1), device_kernel="sweep_kernel"))
    check(len(rows) >= n_vol_shards
          and {int(r["name"].rsplit("-d", 1)[1]) for r in rows}
          == set(range(n_vol_shards)),
          f"{what}: B1 rows {[r['name'] for r in rows]}")
    return rows


def sharded_mesh_frames(engine, dev, meshes, frames: int):
    """The demo with the test mesh through the sharded step on each device
    mesh of `meshes` (all with a rows axis): `frames` orbit frames on the
    far preset the engine's pick gives them, then a close-up on the near
    preset, each held against the unsharded mesh frame from the same
    state (2 rows x 1 volume shard at atol 2e-5; more volume shards at the
    limits of the no-mesh rows), with B1, B2' in bands, B3', B4 and B5'
    launched; their host times, peak memory, device busy time (profiled)
    and the movements of the mesh pass. On more than one volume shard:
    each B1 launch of the last orbit frame (each shard's buckets, its rays
    bounded by the scene depth) against its plain version (the
    `sweep@shard-S<size>-d<shard>` rows), and the orbit frames again with
    B1's plain version on both sides, which tells whether the largest
    pixel difference from the unsharded frame comes from B1 or from the
    per-shard LOD buckets; B2' band held against its plain version on a
    band whose depth weights change pixels (the `composite@depth-band`
    row) and the two bands against the unbanded B2' launch, bit for bit.
    Returns (the summary rows, the launch counts of the orbit frames on
    the last mesh with more than one volume shard)."""
    import types

    import numpy as np
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.ops import lightsweep as light_ops
    from multivolumes_tpu_torch.ops import sweep as sweep_ops
    from multivolumes_tpu_torch.parallel import sharding
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod
    from multivolumes_tpu_torch.render import tilecast as tile_mod

    aspect = engine.config.aspect_ratio
    times_s = [0.25 * i for i in range(frames)]
    cams = [cam_lib.orbit_camera(tm, aspect, device=dev) for tm in times_s]
    eyes = [(np.sin(tm * 0.5) * 60.0, 6.0, np.cos(tm * 0.5) * 60.0)
            for tm in times_s]
    presets = {engine.select_raster_preset(eye) for eye in eyes}
    check(presets == {"far"}, f"the orbit picked the presets {presets}")
    far_cfg = engine.config
    close_eye = (0.0, 6.0, 30.0)
    check(engine.select_raster_preset(close_eye) == "near",
          "the close-up did not pick the near preset")
    near_cfg = engine.config
    close_cam = cam_lib.make_camera(list(close_eye), [0.0, 0.0, 0.0],
                                    aspect, device=dev)
    start = clone_state(engine.state)
    single, state = [], clone_state(start)
    for cam in cams:
        out = frame_lib.render_frame(state, cam, far_cfg)
        state = out.state
        single.append(out.image)
    single.append(frame_lib.render_frame(state, close_cam, near_cfg).image)
    del state
    torch.cuda.synchronize()

    def pixel_err(img, want):
        err = (img.float() - want.to(img.device).float()).abs()
        return err.amax(0) if err.shape[0] == 3 else err.amax(-1)

    results, launches = [], None
    for what, mesh in meshes:
        what = f"sharded mesh step ({what})"
        step = sharding.make_sharded_step(far_cfg, mesh)
        state = sharding.shard_state(clone_state(start), mesh)
        n_vol_shards = mesh.n_volumes_axis
        images, times, last = [], [], {}

        def run():
            nonlocal state
            for f, cam in enumerate(cams):
                mesh.log.clear()
                t0 = time.perf_counter()
                # the last frame's sweeps, in order, with the B1 launches
                with (capture([(sweep_mod, "ray_march_view_sweep_lod"),
                               (sweep_mod, "sweep_march")])
                      if f == frames - 1 else contextlib.nullcontext({})) \
                        as sweeps:
                    img, state = step(state, cam)
                last.update(sweeps)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                images.append(img)
            return images

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with capture([(tile_mod, "tile_composite"),
                      (light_ops, "light_self_scan")]) as calls:
            _, counted = drive(what, run, frames, SHARDED_MESH)
        peak = torch.cuda.max_memory_allocated() - base
        steady = sorted(times[1:])
        log(f"[sharded] {what} ms/frame (host clock, sync per frame): "
            + " ".join(f"{t:.2f}" for t in times) + f"; median "
            f"{steady[len(steady) // 2]:.3f} over frames 2-{frames}; peak "
            f"memory {peak / 2**30:.3f} GiB above the "
            f"{base / 2**30:.3f} GiB held before the run")
        moved = [c for c in mesh.log if c[0].startswith("mesh_")]
        log(f"[sharded] {what} the mesh pass moved (name elements "
            f"(bytes)): " + " ".join(f"{n} {e} ({b} B)" for n, e, b in moved)
            + f"; {sum(b for _n, _e, b in moved)} B in all; every movement "
            f"of the frame: {sum(b for _n, _e, b in mesh.log)} B")
        check([c[0] for c in moved][:2] == ["mesh_depth", "mesh_tri_id"],
              f"the far frame's mesh movements {moved}")
        check(counted["sweep"] >= n_vol_shards * frames,
              f"{counted['sweep']} sweeps for {n_vol_shards} volume shards")
        check(counted["composite_depth_band"] == mesh.rows * frames
              and counted["taa_band"] == mesh.rows * frames,
              f"band launches {counted}")
        check(counted["composite"] + counted["composite_depth"]
              + counted["composite_band"] + counted["taa"] == 0,
              f"an unbanded or mesh-less screen kernel ran: {counted}")
        (a, k) = calls["light_self_scan"]
        check(k.get("sm_vol") is not None, "no shadow map in the refresh")
        for f, (img, want) in enumerate(zip(images, single)):
            check(img.device == mesh.root, f"image on {img.device}")
            check(bool(torch.isfinite(img).all()), f"non-finite {what}")
            if n_vol_shards == 1:
                err = allclose_tol(2e-5, 0.0, f"{what}, frame {f} vs "
                                   f"unsharded")(img, want)
                log(f"  {what}, frame {f} vs unsharded: max {err:.3e}")
            else:
                image_tol(2e-3, 99.9, 1e-1, f"{what}, frame {f} vs "
                          f"unsharded")(img, want.to(img.device))
        if n_vol_shards > 1:
            results += shard_sweep_rows(what, last, n_vol_shards, sweep_mod,
                                        sweep_ops)
            # the orbit frames again with B1's plain version on both sides:
            # a pixel that differs as much there comes from the per-shard
            # LOD buckets, not from the kernel
            kernel_march = sweep_mod.sweep_march
            sweep_mod.sweep_march = lambda *a, **k: kernel_march(
                *a, **dict(k, impl="plain"))
            try:
                p_state = sharding.shard_state(clone_state(start), mesh)
                s_state = clone_state(start)
                for f, cam in enumerate(cams):
                    img_p, p_state = step(p_state, cam)
                    out = frame_lib.render_frame(s_state, cam, far_cfg)
                    s_state = out.state
                    err_k = pixel_err(images[f], single[f])
                    at = divmod(int(err_k.argmax()), err_k.shape[1])
                    err_p = pixel_err(img_p, out.image)
                    log(f"[sharded] {what}, frame {f}, the largest pixel "
                        f"difference from the unsharded frame: B1 kernel "
                        f"{float(err_k.max()):.3e} at (y, x) {at}; B1 plain "
                        f"on both sides {float(err_p[at]):.3e} there, "
                        f"{float(err_p.max()):.3e} at most; at that pixel "
                        f"kernel vs plain: sharded "
                        f"{float(pixel_err(images[f], img_p)[at]):.3e}, "
                        f"unsharded "
                        f"{float(pixel_err(single[f], out.image)[at]):.3e}")
            finally:
                sweep_mod.sweep_march = kernel_march
            del p_state, s_state, img_p, out
        # the close-up on the near preset: the shade per raster band and
        # the full-screen reprojection
        mesh.log.clear()
        img, state = sharding.make_sharded_step(near_cfg, mesh)(state,
                                                                close_cam)
        torch.cuda.synchronize()
        log(f"[sharded] {what} close-up (near preset): the mesh pass moved "
            + " ".join(f"{n} {e} ({b} B)" for n, e, b in mesh.log
                       if n.startswith("mesh_")))
        if n_vol_shards == 1:
            allclose_tol(2e-5, 0.0, f"{what}, close-up vs unsharded")(
                img, single[-1])
        else:
            image_tol(2e-3, 99.9, 1e-1, f"{what}, close-up vs unsharded")(
                img, single[-1].to(img.device))
        holder = types.SimpleNamespace(has_mesh=False, state=state,
                                       config=far_cfg)
        profile_frames(holder, cams, eyes, what, mesh=mesh)
        state = holder.state
        if n_vol_shards == 1:
            del calls
            continue
        launches = counted
        # B2' band on the last orbit frame's lower band of tile rows
        (a1, k1) = calls["tile_composite*"][-1]
        (a0, k0) = calls["tile_composite*"][-2]
        k0, k1 = ({n: x for n, x in k.items() if n != "impl"}
                  for k in (k0, k1))
        check(k1.get("depth_sel") is not None and k1["tile_row0"] > 0
              and k0["tile_row0"] == 0, "the last frame's band calls")
        # the depth weights must change pixels of the band compared, or
        # the comparison could not tell a kernel that skips them: the
        # lower band, else the upper one
        n_seam = []
        for a, k in ((a0, k0), (a1, k1)):
            seam = (tile_mod.tile_composite(*a, **k, impl="kernel")
                    - tile_mod.tile_composite(*a, **dict(k, depth_sel=None),
                                              impl="kernel")).abs().amax(0)
            n_seam.append(int((seam > 1e-3).sum()))
            log(f"[sharded] {what}: in the band from tile row "
                f"{k['tile_row0']} the depth weights move {n_seam[-1]} "
                f"pixels by more than 1e-3 (max {float(seam.max()):.3e})")
        check(max(n_seam) > 0, "the depth weights change no pixel of "
              "either band of the sharded mesh frame")
        (ab, kb) = (a1, k1) if n_seam[1] > 0 else (a0, k0)
        results.append(compare_kernel(
            "composite@depth-band", tile_mod.tile_composite, ab, kb,
            allclose_tol(1e-4, 1e-4, "composite@depth-band"),
            bound_composite, reps=(10, 1), device_kernel=COMPOSITE_KERNELS))
        # the two bands assemble the unbanded B2' launch bit for bit
        banded = torch.cat([tile_mod.tile_composite(*a, **k, impl="kernel")
                            for a, k in ((a0, k0), (a1, k1))], 1)
        whole = tile_mod.tile_composite(
            a0[0], *(torch.cat([x, y]) for x, y in zip(a0[1:4], a1[1:4])),
            *a0[4:], depth_sel=k0["depth_sel"], impl="kernel")
        check(tuple(banded.shape) == tuple(whole.shape)
              and torch.equal(banded, whole),
              "the B2' bands differ from the unbanded B2' launch")
        log(f"[sharded] {what}: the two B2' bands equal the unbanded B2' "
            f"launch ({tuple(whole.shape)}) bit for bit")
        del calls
    del state, images, single, start
    check(launches is not None,
          "no mesh with a rows axis and volume shards was driven")
    return results, launches


def phase_sharded_settings(cfg, dev, mesh_path, smi_line, frames: int = 2,
                           profile_all: bool = False):
    """The sharded frame step at the demo scale in the settings outside
    the main path (`SETTINGS_SHARDED`), each on 2 rows x 1 and 2 rows x 4
    volume shards of the card, `frames` orbit frames against the
    unsharded frames of the same setting from the same state (one frame
    under the reference light, whose frames take seconds): at atol
    2e-5 where no per-shard LOD caps apply (2 rows x 1, the un-bucketed
    sweep and the reference march), at the no-mesh sharded limits where
    they do (mean < 2e-3, p99.9 < 1e-1). Each sharded path runs with the
    launch counts set to 0 just before it and read just after; its
    kernels must launch and no other. Per setting and mesh: ms/frame
    (host clock, sync per frame), peak memory, the movements of the last
    frame, and the device busy time of one profiled frame (with
    `profile_all` also under the reference light, whose profile of half
    a million kernels takes minutes). On 2 rows x 4 of the un-bucketed
    tile setting, B1 per volume shard (16 @ 128, one launch a shard)
    against its plain version (`B1_ATOL`; the rows
    `sweep@unbucketed-shard-d<shard>`) and the B2 band on the unsorted
    f32 maps (the `composite@band-unsorted` row), whose two bands must
    equal the unbanded launch bit for bit. Returns (the summary rows, the
    launch counts of that path)."""
    import types

    import numpy as np
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.ops import sweep as sweep_ops
    from multivolumes_tpu_torch.parallel import sharding
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.render import sweep as sweep_mod
    from multivolumes_tpu_torch.render import tilecast as tile_mod

    card = torch.device("cuda", 0) if dev.type == "cuda" else dev
    meshes = [("2 rows x 1", sharding.make_mesh([card] * 2, rows=2)),
              ("2 rows x 4", sharding.make_mesh([card] * 8, rows=2))]
    times_s = [0.25 * i for i in range(frames)]
    cams = [cam_lib.orbit_camera(tm, cfg.aspect_ratio, device=dev)
            for tm in times_s]
    eyes = [(np.sin(tm * 0.5) * 60.0, 6.0, np.cos(tm * 0.5) * 60.0)
            for tm in times_s]
    results, launches = [], None
    for setting, (change, with_mesh, kernels) in SETTINGS_SHARDED.items():
        t_setting = time.time()
        engine = MultiRayCaster(cfg.with_(**change), device=dev)
        if with_mesh:
            engine.set_mesh(mesh_path)
            presets = {engine.select_raster_preset(eye) for eye in eyes}
            check(presets == {"far"}, f"{setting}: presets {presets}")
        config = engine.config
        # the reference light's frames take seconds: one frame each
        n_frames = (frames if config.light_mode == "sweep"
                    and not config.point_light else 1)
        per_shard_caps = (config.lod_bucket_caps is not None
                          and config.adaptive_raymarch
                          and config.march_mode == "sweep")
        start = clone_state(engine.state)
        single, state = [], clone_state(start)
        for cam in cams[:n_frames]:
            out = frame_lib.render_frame(state, cam, config)
            state = out.state
            single.append(out.image)
        del state, engine
        torch.cuda.synchronize()
        for mesh_what, mesh in meshes:
            what = f"sharded {setting} ({mesh_what})"
            step = sharding.make_sharded_step(config, mesh)
            state = sharding.shard_state(clone_state(start), mesh)
            n_vol_shards = mesh.n_volumes_axis
            held = setting == "unbucketed tile" and n_vol_shards > 1
            images, times, last = [], [], {}

            def run():
                nonlocal state
                for f, cam in enumerate(cams[:n_frames]):
                    mesh.log.clear()
                    t0 = time.perf_counter()
                    with (capture([(sweep_mod, "sweep_march"),
                                   (tile_mod, "tile_composite")])
                          if held and f == n_frames - 1
                          else contextlib.nullcontext({})) as calls:
                        img, state = step(state, cam)
                    last.update(calls)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    images.append(img)
                return images

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            _, counted = drive(what, run, n_frames, kernels)
            peak = torch.cuda.max_memory_allocated() - base
            others = {k: c for k, c in counted.items()
                      if c and k not in kernels}
            check(not others, f"{what} launched {others}")
            check(state.frame_idx == start.frame_idx + n_frames,
                  f"{what}: frame_idx {state.frame_idx}")
            log(f"[sharded-settings] {what}: ms/frame (host clock, sync "
                f"per frame) " + " ".join(f"{t:.2f}" for t in times)
                + f"; launches {counted}; peak memory "
                f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
                f"held before; {smi_line}")
            log(f"[sharded-settings] {what}: movements of the last frame "
                + " ".join(f"{n} {b} B" for n, _e, b in mesh.log)
                + f"; {sum(b for _n, _e, b in mesh.log)} B in all")
            for f, (img, want) in enumerate(zip(images, single)):
                check(img.device == mesh.root, f"image on {img.device}")
                check(bool(torch.isfinite(img).all()), f"non-finite {what}")
                if n_vol_shards == 1 or not per_shard_caps:
                    err = allclose_tol(2e-5, 0.0, f"{what}, frame {f} vs "
                                       f"unsharded")(img, want)
                    log(f"  {what}, frame {f} vs unsharded: max {err:.3e}")
                else:
                    image_tol(2e-3, 99.9, 1e-1, f"{what}, frame {f} vs "
                              f"unsharded")(img, want)
            if held:
                launches = counted
                results += unbucketed_shard_rows(what, last, mesh, config,
                                                 sweep_mod, sweep_ops,
                                                 tile_mod)
            if profile_all or config.light_mode == "sweep" \
                    and not config.point_light:
                holder = types.SimpleNamespace(has_mesh=False, state=state,
                                               config=config)
                profile_frames(holder, cams, eyes, f"{what}; {smi_line}",
                               frames=1, mesh=mesh)
            else:
                log(f"[sharded-settings] {what}: not profiled in this run "
                    f"(python3 chip_smoke.py --profile-sharded-settings)")
            del state, images, last
        del single, start
        torch.cuda.empty_cache()
        log(f"[sharded-settings] {setting}: {time.time() - t_setting:.1f} s")
    check(launches is not None, "the un-bucketed tile setting was not "
          "driven on volume shards")
    return results, launches


def unbucketed_shard_rows(what, calls, mesh, config, sweep_mod, sweep_ops,
                          tile_mod):
    """The un-bucketed sharded frame's kernels against their plain
    versions: each volume shard's one B1 launch (N / D volumes at S,
    `B1_ATOL`) and the lower row band of B2 on the unsorted maps, with
    the two bands against the unbanded launch, bit for bit."""
    import torch

    nd = mesh.n_volumes_axis
    nl, s = config.num_volumes // nd, config.cube_map_size
    marches = calls["sweep_march*"]
    check(len(marches) == nd and all(
        a[2].shape[0] == nl and a[8] == s
        and a[7] == (config.sweep_planes or s) for a, _k in marches),
        f"{what}: B1 launches {[(a[2].shape[0], a[8]) for a, _k in marches]}"
        f" (one of {nl} volumes at S={s} per shard expected)")
    rows = []
    for d, (a, k) in enumerate(marches):
        k = {n: x for n, x in k.items() if n != "impl"}
        info = sweep_ops.sweep_launch_info(
            a[8], a[7], a[0].shape[1], a[1].shape[1],
            a[0].dtype == torch.bfloat16)
        log(f"[occupancy] sweep@unbucketed-shard-d{d}: {info}")
        name = f"sweep@unbucketed-shard-d{d}"
        rows.append(compare_kernel(
            name, sweep_mod.sweep_march, a, k,
            allclose_tol(B1_ATOL, 0.0, name),
            bound_sweep, reps=(10, 1), device_kernel="sweep_kernel"))
    (a0, k0), (a1, k1) = calls["tile_composite*"][-2:]
    k0, k1 = ({n: x for n, x in k.items() if n != "impl"} for k in (k0, k1))
    check(k0["tile_row0"] == 0 and k1["tile_row0"] > 0
          and k1.get("depth_sel") is None, f"{what}: the band calls")
    check(a1[0].dtype == torch.float32
          and a1[0].shape[0] == config.num_volumes,
          f"{what}: B2 band maps {a1[0].dtype} {tuple(a1[0].shape)}")
    # B2's limit (the `composite` row's), and beside it the bf16 band
    # row's 1e-4 + 1e-4 rel on every element: the plain version divides
    # the pixel NDC as the kernel does (`ops/composite.py:pixel_ndc`)
    limits = (image_tol(3e-3, 99.5, 3e-2, "composite@band-unsorted"),
              allclose_tol(1e-4, 1e-4, "composite@band-unsorted"))
    rows.append(compare_kernel(
        "composite@band-unsorted", tile_mod.tile_composite, a1, k1,
        lambda g, w: max(t(g, w) for t in limits), bound_composite,
        reps=(10, 1), device_kernel=COMPOSITE_KERNELS))
    banded = torch.cat([tile_mod.tile_composite(*a, **k, impl="kernel")
                        for a, k in ((a0, k0), (a1, k1))], 1)
    whole = tile_mod.tile_composite(
        a0[0], *(torch.cat([x, y]) for x, y in zip(a0[1:4], a1[1:4])),
        *a0[4:], impl="kernel")
    check(tuple(banded.shape) == tuple(whole.shape)
          and torch.equal(banded, whole),
          f"{what}: the B2 bands on the unsorted maps differ from the "
          f"unbanded launch")
    log(f"[sharded-settings] {what}: the two B2 bands on the unsorted maps "
        f"equal the unbanded launch ({tuple(whole.shape)}) bit for bit")
    return rows


def phase_raster_bin(dev):
    """B6 against its plain version at the microbench's default size, then
    the microbench through its entry point; returns (the summary row, the
    launch counts of the microbench)."""
    import torch

    from multivolumes_tpu_torch import ops
    from multivolumes_tpu_torch.ops import raster_bin
    from multivolumes_tpu_torch.tools import raster_bin_microbench as tool

    n_c, n_t = 600, 150
    operands = tool.eval_inputs(n_c, n_t, dev)
    row = compare_kernel("raster_bin_eval", raster_bin.raster_bin_eval,
                         (*operands, n_t), {}, None, bound_raster_bin,
                         reps=(20, 2), device_kernel="raster_bin_eval_kernel")
    out = raster_bin.raster_bin_eval(*operands, n_t)
    covered = int((out != raster_bin.EMPTY).sum())
    log(f"[raster_bin] {covered} of {out.numel()} pixels covered, "
        f"{int((out < 0).sum())} of them by a word with the sign bit set")
    check(covered > 0, "no candidate covers a pixel")
    torch.cuda.synchronize()
    ops.reset_launches()
    times = tool.main([], device=dev)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["raster_bin_eval"] > 0,
          "the microbench did not launch the eval kernel")
    check(all(t > 0.0 for t in times.values()), f"microbench times {times}")
    log(f"[raster_bin] microbench times (ms): {times}; launches "
        f"{launches['raster_bin_eval']}")
    return [row], launches


def phase_app(frames: int = 4, mesh_path=None):
    """The app at the demo scale in its own process (with `--mesh` when
    `mesh_path` is given)."""
    name = "chip_smoke_app_mesh.png" if mesh_path else "chip_smoke_app.png"
    out = os.path.join(HERE, "build", name)
    if os.path.exists(out):
        os.remove(out)
    cmd = [sys.executable, "-m", "multivolumes_tpu_torch.app",
           "--numVolumes", "64", "--frames", str(frames), "--animate",
           "--out", out]
    if mesh_path:
        cmd += ["--mesh", mesh_path]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    tag = "[app --mesh]" if mesh_path else "[app]"
    tail = proc.stdout.strip().splitlines()[-(frames + 1):]
    for line in tail:
        log(f"{tag} {line}")
    check(proc.returncode == 0,
          f"app exited {proc.returncode}: {proc.stderr[-2000:]}")
    size = os.path.getsize(out) if os.path.exists(out) else 0
    check(size > 0, f"app wrote no PNG at {out}")
    log(f"{tag} rc 0, {size} byte PNG in {time.time() - t0:.1f} s")


# rounds of profile_frame and time_fn in turn, compared by their medians
TIMING_ROUNDS = 9

# the hand kernels of the frame by the pass that must launch them
PASS_KERNELS = {"sweep_kernel": "sweep", "sweep_prologue_kernel": "sweep",
                "lod_partition_kernel": "sweep", "lod_store_kernel": "sweep",
                "tile_composite_kernel": "composite",
                "mesh_tile_kernel": "composite", "self_scan_kernel": "light",
                "taa_resolve_kernel": "taa", "mesh_planes_kernel": "mesh",
                "mesh_shade_kernel": "mesh", "raster_setup_kernel": "mesh",
                "raster_emit_kernel": "mesh",
                "raster_resolve_kernel": "mesh",
                "light_prologue_kernel": "light",
                "light_occlusion_kernel": "light",
                "light_epilogue_kernel": "light"}
# the kernels of PASS_KERNELS that only a frame with the mesh launches
MESH_ONLY_KERNELS = ("mesh_tile_kernel", "mesh_planes_kernel",
                     "mesh_shade_kernel", "raster_setup_kernel",
                     "raster_emit_kernel", "raster_resolve_kernel")


def phase_tools(cfg, dev, mesh_path):
    """The entry points of `entry.py`, `utils/timing.py` and `tools/`, each
    driven with the launch counts set to 0 just before and read just
    after: `entry()`'s step, `dryrun_multichip(2)` and (4), `time_fn` of
    the demo frame against `profile_frame`'s pass sum, `trace_ops` on 2
    demo frames without and with the mesh (every hand kernel in its
    pass, at most 1% of the device time unattributed), `fidelity_demo` at
    full width with the torus and 16 volumes, `bench_fallbacks` at 8
    volumes and the gallery's 4 and 16 volumes."""
    import torch

    from multivolumes_tpu_torch import entry as entry_mod
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.tools import (BUILD, bench_fallbacks,
                                              fidelity_demo, render_gallery,
                                              trace_ops)
    from multivolumes_tpu_torch.utils.timing import (profile_frame,
                                                     readback_latency,
                                                     time_fn)

    def entry_step():
        step, example = entry_mod.entry()
        return step(*example)

    (img, _state), _ = drive("entry()", entry_step, 1, NO_MESH)
    check(tuple(img.shape) == (128, 192, 3)
          and bool(torch.isfinite(img).all()),
          f"entry(): image {tuple(img.shape)}, finite "
          f"{bool(torch.isfinite(img).all())}")
    drive("dryrun_multichip(2)", lambda: entry_mod.dryrun_multichip(2), 1,
          NO_MESH)
    drive("dryrun_multichip(4), 2 rows x 2", lambda:
          entry_mod.dryrun_multichip(4), 1, SHARDED)

    # The frame is host-bound, so both are host dispatch time, and a
    # shared host's rate drifts by up to 2x within seconds: the two are
    # taken in turn, TIMING_ROUNDS times, and their medians are compared.
    eng = MultiRayCaster(cfg, device=dev)
    cam = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=dev)
    sums, frames = [], []

    def step():
        out = frame_lib.render_frame(eng.state, cam, eng.config)
        eng.state = out.state
        return out.image

    def timed():
        for _ in range(TIMING_ROUNDS):
            passes = profile_frame(eng.state, cam, eng.config, iters=3)
            sums.append(sum(passes.values()))
            frames.append(time_fn(step, iters=8))
            log(f"[tools] profile_frame (median of 3, ms): " + " ".join(
                f"{n} {t:.3f}" for n, t in passes.items())
                + f"; sum {sums[-1]:.3f}; time_fn of the frame "
                f"{frames[-1]:.3f} ms")

    drive("profile_frame + time_fn", timed, TIMING_ROUNDS * 12, NO_MESH)
    total, frame = statistics.median(sums), statistics.median(frames)
    log(f"[tools] median of {TIMING_ROUNDS} rounds: the passes' sum "
        f"{total:.3f} ms, time_fn {frame:.3f} ms; readback latency "
        f"{readback_latency():.4f} ms")
    check(abs(frame - total) <= 0.25 * frame,
          f"time_fn {frame:.3f} ms against the passes' sum {total:.3f} ms "
          f"(medians of {TIMING_ROUNDS} rounds)")
    del eng

    for what, path, kernels in (("demo", None, NO_MESH),
                                ("mesh demo", mesh_path, WITH_MESH)):
        report, _ = drive(f"trace_ops, {what}", lambda: trace_ops.run(
            cfg, dev, 2, path), 3, kernels)
        log(f"[tools] trace_ops, {what}, 2 frames (device ms per frame):")
        trace_ops.print_report(report)
        for kernel, want in PASS_KERNELS.items():
            got = trace_ops.passes_of(report, kernel)
            check(got == {want} or (kernel in MESH_ONLY_KERNELS
                                    and path is None and not got),
                  f"trace_ops, {what}: {kernel} in the passes {got}, "
                  f"not in {want!r} alone")
        check(0.0 < report["device_ms"]
              and report["unattributed_ms"] <= 0.01 * report["device_ms"],
              f"trace_ops, {what}: {report['unattributed_ms']:.3f} of "
              f"{report['device_ms']:.3f} device ms/frame not attributed")

    r, _ = drive("fidelity_demo --volumes 16", lambda: fidelity_demo.main(
        ["--volumes", "16"]), 2,
        ("sweep", "composite_depth", "light_self_scan_sm",
         "light_advect_mul"))
    check(all(math.isfinite(r[k]) for k in ("mean", "p99", "max"))
          and r["covered"] > 0.05, f"fidelity_demo --volumes 16: {r}")
    drive("bench_fallbacks --volumes 8 --frames 2", lambda:
          bench_fallbacks.main(["--volumes", "8", "--frames", "2"]), 6,
          ("sweep", "composite_depth", "taa"))
    for n in (4, 16):
        png, _ = drive(f"gallery, {n} volumes", lambda:
                       render_gallery.render_count(
                           n, BUILD / "gallery", dev, mesh_path=mesh_path),
                       6, WITH_MESH)
        check(os.path.getsize(png) > 0, f"gallery: no PNG at {png}")


# the hand kernels one bench frame launches: profiler kernel name ->
# launches, and the launch counts, without and with the opaque mesh (B1,
# B7 and B13 once per LOD bucket, B12 once; B3 and B4 are both
# `self_scan_kernel`; B8
# once with the mesh, as its planes and its shade; B9 once with the mesh,
# as its setup, emit and resolve)
BENCH_FRAME = {
    False: ({"sweep_kernel": 3, "sweep_prologue_kernel": 3,
             "lod_partition_kernel": 1, "lod_store_kernel": 3,
             "tile_composite_kernel": 1, "mesh_tile_kernel": 0,
             "self_scan_kernel": 2, "taa_resolve_kernel": 1,
             "mesh_planes_kernel": 0, "mesh_shade_kernel": 0,
             "raster_setup_kernel": 0, "raster_emit_kernel": 0,
             "raster_resolve_kernel": 0, "light_prologue_kernel": 1,
             "light_occlusion_kernel": 1, "light_epilogue_kernel": 1},
            {"sweep": 3, "sweep_prologue": 3, "lod_partition": 1,
             "lod_store": 3, "composite": 1,
             "light_self_scan": 1, "light_advect_mul": 1,
             "light_prologue": 1, "light_occlusion": 1,
             "light_epilogue": 1, "taa": 1}),
    True: ({"sweep_kernel": 3, "sweep_prologue_kernel": 3,
            "lod_partition_kernel": 1, "lod_store_kernel": 3,
            "tile_composite_kernel": 1, "mesh_tile_kernel": 1,
            "self_scan_kernel": 2, "taa_resolve_kernel": 1,
            "mesh_planes_kernel": 1, "mesh_shade_kernel": 1,
            "raster_setup_kernel": 1, "raster_emit_kernel": 1,
            "raster_resolve_kernel": 1, "light_prologue_kernel": 1,
            "light_occlusion_kernel": 1, "light_epilogue_kernel": 1},
           {"sweep": 3, "sweep_prologue": 3, "lod_partition": 1,
            "lod_store": 3, "composite_depth": 1,
            "light_self_scan_sm": 1, "light_advect_mul": 1,
            "light_prologue": 1, "light_occlusion": 1, "light_epilogue": 1,
            "taa": 1, "mesh_shade": 1, "raster": 1}),
}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "mode"}


def phase_bench(dev, mesh_path, smi_line):
    """`bench.run` at the card config without the mesh (as the CLI runs
    where `bunny.obj` is absent) and with the test torus, each with the
    launch counts set to 0 just before and read just after; its record
    and numbers; then one bench frame under the profiler, which must
    launch the hand kernels of the path and call none of their plain
    versions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from multivolumes_tpu_torch import bench, ops
    from multivolumes_tpu_torch.ops import composite as composite_ops
    from multivolumes_tpu_torch.ops import lightsweep as light_ops
    from multivolumes_tpu_torch.ops import sweep as sweep_ops
    from multivolumes_tpu_torch.ops import taa as taa_ops
    from multivolumes_tpu_torch.render import lightsweep as light_lib
    from multivolumes_tpu_torch.render import mesh as mesh_lib
    from multivolumes_tpu_torch.render import sweep as sweep_lib

    cfg, frames = bench.bench_config(True)
    plains = ((mesh_lib, "shade_plain"), (mesh_lib, "rasterize_plain"),
              (sweep_ops, "sweep_march_plain"),
              (composite_ops, "tile_composite_plain"),
              (light_ops, "light_self_scan_plain"),
              (light_ops, "light_advect_mul_plain"),
              (light_lib, "prologue_plain"), (light_lib, "occlusion_entry"),
              (light_lib, "_shade_light_fields"),
              (sweep_lib, "partition_plain"),
              (sweep_lib, "bucket_store_plain"),
              (taa_ops, "taa_resolve_plain"))
    for path in (None, mesh_path):
        has_mesh = path is not None
        what = "bench, torus" if has_mesh else "bench"
        # frames: the warm-up step and block, the scan, async and batched
        # runs, the breakdown's 3
        r, _ = drive(what, lambda: bench.run(cfg, dev, frames, path),
                     1 + 8 + 3 * frames + 3,
                     WITH_MESH if has_mesh else NO_MESH)
        log(f"[bench] {what} ({smi_line}): " + json.dumps(r))
        res = r["result"]
        tag = "" if has_mesh else "_nomesh"
        check(set(res) == BENCH_KEYS, f"{what}: record keys {sorted(res)}")
        check(res["metric"] == f"frame_fps_64vol_all64_demo{tag}_gpu"
              and res["value"] > 0 and res["mode"] in ("scan", "async")
              and r["p50_ms"] <= r["p95_ms"] and r["mesh"] == has_mesh,
              f"{what}: {res}, p50 {r['p50_ms']} p95 {r['p95_ms']}")
        check(r["passes"] and ("mesh" in r["passes"]) == has_mesh
              and all(t > 0.0 for t in r["passes"].values()),
              f"{what}: passes {r['passes']}")

        # one bench frame under the profiler (a profile now and then
        # records no device event: tried three times)
        want_kernels, want_launches = BENCH_FRAME[has_mesh]
        engine = bench.make_engine(cfg, dev, path)
        state = engine.state
        cams = bench.orbit_cameras(0, 4, engine.config, dev)
        img, state = bench.step(state, cams[0], engine.config)
        for cam in cams[1:]:
            torch.cuda.synchronize()
            ops.reset_launches()
            with capture(plains) as calls, profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                img, state = bench.step(state, cam, engine.config)
                torch.cuda.synchronize()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            got = {k: sum(1 for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and k in e.name) for k in want_kernels}
            if any(got.values()):
                break
        log(f"[bench] {what}: one profiled bench frame launched {got} "
            f"(launch counts {launches}); plain versions called: "
            f"{calls.get('#', [])}")
        check(got == want_kernels, f"{what}: the profiled frame launched "
              f"{got}, not {want_kernels}")
        check(launches == want_launches, f"{what}: launch counts "
              f"{launches}, not {want_launches}")
        check(not calls, f"{what}: the frame called the plain versions "
              f"{calls.get('#')}")
        check(tuple(img.shape) == (3, cfg.height, cfg.width)
              and bool(torch.isfinite(img).all()),
              f"{what}: image {tuple(img.shape)}")
        del engine, state, img
        torch.cuda.empty_cache()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
