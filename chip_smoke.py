#!/usr/bin/env python3
"""Drive the PyTorch port (`multivolumes_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card

Phases (any failure exits non-zero, and no result line is printed):
  1. the card: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build every hand kernel from `multivolumes_tpu_torch/csrc/` (one nvcc
     per source, all at once, sm_90a) and load them;
  3. each kernel against its plain PyTorch version on the card, on the
     operands the main path gives it (captured from the demo-scale scene
     and its frames; the TAA resolve from the third frame, so the history
     is not zero, with and without the fused tone map, and on a seeded
     synthetic 1280x800 case with half the alpha at 1), with the parity
     tolerance of the kernel's CPU test; times of both from CUDA events
     after warm-up;
  4. the main path at the 64-volume 1280x800 demo scale (no mesh, TAA on):
     8 frames along the orbit through `MultiRayCaster.render`, then the
     same 8 cameras through `MultiRayCaster.render_block` from a copy of
     the starting state. Each path runs with the launch counts set to 0
     just before it and read just after, and every kernel must have
     launched in each; the block's images must equal the sequential ones
     (atol 2e-5), and the image must be finite with real volume coverage;
  5. three small frames with TAA rendered with impl="kernel" and with
     impl="plain" from the same state, compared with the golden-image
     tolerance;
  6. the app, `python -m multivolumes_tpu_torch.app` at the demo scale
     for 4 animated frames, in its own process: exit code 0 and a
     non-empty PNG.

The last line is `{"ok": true, "device": {...}}`; the line before it is
the per-kernel JSON summary, and the one before that the `nvidia-smi`
line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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
    "composite": (_CSRC + "composite.cu", _PALLAS + "composite_kernel.py:691"),
    "light_self_scan": (_CSRC + "lightsweep.cu",
                        _PALLAS + "lightsweep_kernel.py:96"),
    "light_advect_mul": (_CSRC + "lightsweep.cu",
                         _PALLAS + "lightsweep_kernel.py:152"),
    "taa": (_CSRC + "taa.cu", _PALLAS + "taa_kernel.py:226"),
}

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
    `targets` (and the call's result) while the block runs."""
    calls, saved = {}, []
    for mod, name in targets:
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def wrapper(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            calls.setdefault(_name, (a, k))
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


def compare_kernel(name, fn, args, kwargs, tol, reps=(10, 2)):
    """Run wrapper `fn` with impl kernel and plain on the same operands;
    check the tolerance; return the summary entry (launches filled in
    later)."""
    import torch

    got = fn(*args, **dict(kwargs, impl="kernel"))
    want = fn(*args, **dict(kwargs, impl="plain"))
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs, means = [], []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        errs.append(tol(g, w))
        means.append(float((g - w).abs().mean()))
    max_err = max(errs)
    ms = cuda_ms(lambda: fn(*args, **dict(kwargs, impl="kernel")), reps[0])
    plain_ms = cuda_ms(lambda: fn(*args, **dict(kwargs, impl="plain")),
                       reps[1])
    log(f"[kernel] {name}: max_abs_err {max_err:.3e}  mean_abs_err "
        f"{max(means):.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    src, replaces = KERNELS[name.split("@")[0]]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms}


def allclose_tol(atol, rtol, what):
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

    from multivolumes_tpu.config import RenderConfig
    from multivolumes_tpu_torch.ops import build

    # --- 2. build ---------------------------------------------------------
    t0 = time.time()
    build.library()
    log(f"[build] kernels built and loaded in {time.time() - t0:.1f} s")

    # --- 3. each kernel against its plain version -------------------------
    dev = torch.device("cuda")
    cfg = RenderConfig(**DEMO)
    engine, results = phase_kernels(cfg, dev)
    launches = phase_demo(engine, cfg, dev)
    for r in results:
        r["launches"] = launches[r["name"].split("@")[0]]
    phase_small(RenderConfig(**SMALL), dev)
    phase_app()

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
                            (tile_mod, "tile_composite")]) as frame_calls:
        probe = frame_lib.render_frame(probe, cams[0], engine.config).state
    probe = frame_lib.render_frame(probe, cams[1], engine.config).state
    with capture([(taa_ops, "taa_resolve")]) as taa_calls:
        frame_lib.render_frame(probe, cams[2], engine.config)
    del probe
    torch.cuda.synchronize()

    results = []
    sweep_tol = allclose_tol(2e-3, 2e-2, "sweep")
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
                                  sweep_tol, reps=(10, 2)))
    (a, k) = frame_calls["tile_composite"]
    k = dict(k)
    k.pop("impl", None)
    results.append(compare_kernel(
        "composite", tile_mod.tile_composite, a, k,
        image_tol(3e-3, 99.5, 3e-2, "composite"), reps=(10, 1)))
    for cname, calls in (("C1", frame_calls), ("C8", init_calls)):
        (a, k) = calls["light_self_scan"]
        k = dict(k)
        k.pop("impl", None)
        if cname == "C8":
            a = tuple(x[:8] for x in a)
        check(a[0].shape[0] == int(cname[1:]), f"cohort {a[0].shape}")
        results.append(compare_kernel(f"light_self_scan@{cname}",
                                      light_ops.light_self_scan, a, k,
                                      light_tol, reps=(10, 2)))
        (a, k) = calls["light_advect_mul"]
        k = dict(k)
        k.pop("impl", None)
        if cname == "C8":
            a = tuple(x[:8] for x in a)
        results.append(compare_kernel(f"light_advect_mul@{cname}",
                                      light_ops.light_advect_mul, a, k,
                                      light_tol, reps=(10, 2)))
    taa_tol = allclose_tol(2e-5, 0.0, "taa")
    (a, _k) = taa_calls["taa_resolve"]
    check(float(a[1][3].min()) > 0.0, "frame 3's TAA history is still zero")
    for name, kw in (("taa@frame3", {}), ("taa@frame3+tonemap",
                                           dict(tonemap=True))):
        results.append(compare_kernel(name, taa_ops.taa_resolve, a, kw,
                                      taa_tol, reps=(20, 3)))
    results.append(compare_kernel(
        "taa@synthetic", taa_ops.taa_resolve,
        taa_synthetic(dev, cfg.height, cfg.width), dict(tonemap=True),
        taa_tol, reps=(20, 3)))
    del frame_calls, init_calls, taa_calls
    return engine, results


def taa_synthetic(dev, h, w, seed=0):
    """Seeded B5 operands that reach the history blend: half the alpha at
    1, a random history with some full counts, a non-zero blur on half
    the pixels."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    cur = rng.rand(4, h, w).astype(np.float32) * 2.0
    cur[3] = np.where(rng.rand(h, w) < 0.5, 1.0, 0.5)
    hist = rng.rand(4, h, w).astype(np.float32)
    hist[3] = np.where(rng.rand(h, w) < 0.3, 1.0, hist[3])
    blur = np.where(rng.rand(h, w) < 0.5, 0.0, rng.rand(h, w) * 1.5)
    return tuple(torch.tensor(x, dtype=torch.float32, device=dev)
                 for x in (cur, hist, blur))


def drive(what, fn, frames):
    """Run fn() (which renders `frames` frames and returns the images) with
    the launch counts set to 0 just before and read just after; every
    kernel must have launched."""
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
    for name in KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the {what} frames")
    return out, launches


def phase_demo(engine, cfg, dev, frames: int = 8):
    """Drive the main path through the engine, frame by frame and as one
    block from the same starting state; return the launch counts of the
    frame-by-frame run."""
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.render import frame as frame_lib

    cams = [cam_lib.orbit_camera(0.25 * i, cfg.aspect_ratio, device=dev)
            for i in range(frames)]
    start = clone_state(engine.state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []

    def render_each():
        imgs = []
        for cam in cams:
            t0 = time.perf_counter()
            imgs.append(engine.render(cam))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return imgs

    seq, launches = drive("render", render_each, frames)
    # the copy of the starting state kept for render_block is not the
    # path's own memory
    copy_bytes = sum(getattr(start, f.name).nbytes
                     for f in dataclasses.fields(start)
                     if isinstance(getattr(start, f.name), torch.Tensor))
    peak = torch.cuda.max_memory_allocated() - copy_bytes
    log(f"[demo] render ms/frame (host clock, sync per frame): "
        + " ".join(f"{t:.2f}" for t in times))
    steady = sorted(times[1:])
    log(f"[demo] render median {steady[len(steady) // 2]:.3f} ms/frame over "
        f"frames 2-{frames}; peak memory {peak / 2**30:.3f} GiB (without "
        f"the {copy_bytes / 2**30:.3f} GiB copy of the starting state)")
    img = seq[-1]
    check(tuple(img.shape) == (cfg.height, cfg.width, 3),
          f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "non-finite demo image")
    end_state = engine.state

    engine.state = clone_state(start)
    del start
    block, _ = drive("render_block", lambda: engine.render_block(cams),
                     frames)
    check(tuple(block.shape) == (frames, 3, cfg.height, cfg.width),
          f"block shape {tuple(block.shape)}")
    check(engine.state.frame_idx == end_state.frame_idx,
          "render_block advanced the state by another frame count")
    for f in range(frames):
        allclose_tol(2e-5, 0.0, f"render_block frame {f} vs render")(
            block[f].permute(1, 2, 0), seq[f])
    del block, seq

    # per-pass device times of one more frame (CUDA events)
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    out = frame_lib.render_frame(engine.state, cams[-1], engine.config,
                                 timer=mark)
    engine.state = out.state
    torch.cuda.synchronize()
    passes = {events[i][0]: events[i][1].elapsed_time(events[i + 1][1])
              for i in range(len(events) - 1)}
    log("[demo] per pass (ms): " + " ".join(f"{n} {t:.3f}"
                                           for n, t in passes.items()))
    cover = float((out.hdr[..., 3] > 0.05).float().mean())
    log(f"[demo] volume alpha > 0.05 on {cover:.3f} of pixels")
    check(cover > 0.02, f"volume coverage {cover:.4f} too small")
    return launches


def phase_small(small, dev, frames: int = 3):
    """Three frames with TAA rendered with impl="kernel" and with
    impl="plain" from the same state, each held to the golden-image
    tolerance."""
    import torch

    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib

    eng_s = MultiRayCaster(small, device=dev)
    st_k, st_p = clone_state(eng_s.state), clone_state(eng_s.state)
    for f in range(frames):
        cam = cam_lib.orbit_camera(0.7 + f / 60.0, small.aspect_ratio,
                                   device=dev)
        out_k = frame_lib.render_frame(st_k, cam, eng_s.config,
                                       impl="kernel")
        out_p = frame_lib.render_frame(st_p, cam, eng_s.config, impl="plain")
        st_k, st_p = out_k.state, out_p.state
        image_tol(2e-3, 99.9, 3e-2, f"small frame {f} kernel vs plain")(
            out_k.image, out_p.image)
        check(bool(torch.isfinite(out_k.image).all()),
              "non-finite small frame")


def phase_app(frames: int = 4):
    """The app at the demo scale in its own process."""
    out = os.path.join(HERE, "build", "chip_smoke_app.png")
    if os.path.exists(out):
        os.remove(out)
    cmd = [sys.executable, "-m", "multivolumes_tpu_torch.app",
           "--numVolumes", "64", "--frames", str(frames), "--animate",
           "--out", out]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                          timeout=600)
    tail = proc.stdout.strip().splitlines()[-(frames + 1):]
    for line in tail:
        log(f"[app] {line}")
    check(proc.returncode == 0,
          f"app exited {proc.returncode}: {proc.stderr[-2000:]}")
    size = os.path.getsize(out) if os.path.exists(out) else 0
    check(size > 0, f"app wrote no PNG at {out}")
    log(f"[app] rc 0, {size} byte PNG in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
