"""Benchmark: full-pipeline frame time on the all64 demo workload.

Counterpart of the repository's `bench.py`, with its workload, camera
path and outputs: the reference's 64-volume demo (`Bin/all64.bat`) at
the default 1280x800 window with the orbit-camera animation, the
engine's procedural radiance probe, and the reference's `bunny.obj`
where that file exists (else the run is tagged `_nomesh`). vs_baseline
is frame-FPS / 60, the real-time target at the default window.

    python -m multivolumes_tpu_torch.bench [--cpu]

On the card it runs the demo for 32 frames; with `--cpu` a small scene
for 3. Stderr gets the amortized frame time of both dispatch modes, the
per-frame times in 4-frame batches, the readback times, p50 / p95 and,
on the card, the per-pass breakdown; the last stdout line is one JSON
object {"metric", "value", "unit", "vs_baseline", "mode"}.

Left behind from the JAX bench: `configure_for_host` (a TPU host
workaround; the device is the caller's), `donate_argnums` (the port's
state advances in place), the `MV_SCAN_K` / `MV_SCAN_UNROLL` knobs
(`unroll` means nothing without `lax.scan`) and the `try/except` around
the breakdown: here a failing breakdown fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

# the reference demo's mesh, where the JAX bench looks for it
BUNNY = os.path.join(os.sep, "root", "reference", "Bin", "Assets",
                     "bunny.obj")
# the real-time target at the default window
BASELINE_FPS = 60.0
# frames per sample of the per-frame percentiles
BATCH = 4


def bench_config(on_card: bool):
    """-> (RenderConfig, frames): the `all64.bat` workload for 32 frames on
    the card (p95 = sorted[30] of 32, not the single worst frame), a small
    scene for 3 frames on the CPU."""
    from multivolumes_tpu_torch.config import RenderConfig

    if on_card:
        return RenderConfig(
            width=1280, height=800, grid_size=128, light_grid_size=96,
            max_ray_samples=256, max_light_samples=96,
            num_volumes=64, num_volume_srcs=10,
            cube_map_size=128, shadow_map_size=1024,
        ), 32
    return RenderConfig(
        width=320, height=200, grid_size=32, light_grid_size=16,
        max_ray_samples=64, max_light_samples=16,
        num_volumes=4, num_volume_srcs=2,
        cube_map_size=32, shadow_map_size=64,
    ), 3


def make_engine(cfg, device, mesh_path=None):
    """The bench's engine: the scene of `cfg` on `device`, with the mesh at
    `mesh_path` when given."""
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.tools import ORBIT_EYE

    engine = MultiRayCaster(cfg, device)
    if mesh_path is not None:
        engine.set_mesh(mesh_path)
        # the demo orbit keeps a fixed camera distance: the host-side
        # raster-preset pick is the same every frame, so make it once
        engine.select_raster_preset(ORBIT_EYE)
    return engine


def step(state, camera, cfg):
    """One frame with TAA -> (planar (3, H, W) image, advanced state)."""
    from multivolumes_tpu_torch.render import frame as frame_lib

    out = frame_lib.render_frame(state, camera, cfg, use_taa=True,
                                 planar=True)
    return out.image, out.state


def scan(state, cameras, cfg):
    """K frames in one call (`render_frames`, the counterpart of the JAX
    bench's `lax.scan` dispatch) -> ((K, 3, H, W) images, state)."""
    from multivolumes_tpu_torch.render import frame as frame_lib

    return frame_lib.render_frames(state, cameras, cfg, use_taa=True)


def orbit_cameras(f0: int, n: int, cfg, device):
    """The orbit cameras of frames f0 + 1 .. f0 + n at 60 frames/s."""
    from multivolumes_tpu_torch.core import camera as cam_lib

    return [cam_lib.orbit_camera((f0 + i + 1) / 60.0, cfg.aspect_ratio,
                                 device=device) for i in range(n)]


def run(cfg, device, frames: int, mesh_path=None) -> dict:
    """The bench on `device`: the JAX bench's `main` with the mesh path
    passed in. Prints its stderr lines and returns {"result": the JSON
    record, "scan_ms", "async_ms" (amortized ms/frame), "k_frames",
    "per_frame_ms" (one per batch), "p50_ms", "p95_ms", "rtt_ms",
    "latency_ms", "mesh", "passes" ({pass: ms}, on the card; else None)}."""
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.utils.timing import (profile_frame,
                                                     readback_latency, sync)

    device = torch.device(device)
    on_card = device.type == "cuda"
    has_mesh = mesh_path is not None
    engine = make_engine(cfg, device, mesh_path)
    cfg = engine.config
    state = engine.state

    # K frames per call for the amortized headline; p50 / p95 below stay
    # single-frame dispatches
    k_frames = 8 if on_card and frames % 8 == 0 else 1
    blocks = [orbit_cameras(f0, k_frames, cfg, device)
              for f0 in range(0, frames, k_frames)]

    # warm-up (the animated camera, as in the demo's [A] toggle)
    camera = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=device)
    img, state = step(state, camera, cfg)
    sync(img)
    imgs, state = scan(state, orbit_cameras(-k_frames, k_frames, cfg,
                                            device), cfg)
    sync(imgs)
    # on the CPU a sync reads back nothing
    lat = readback_latency() if on_card else 0.0

    # headline: amortized frame time over an animated run, one sync, in
    # two dispatch modes; the faster wins
    #   scan  -- K frames per call (`render_frames`)
    #   async -- one call per frame, no sync in between (cameras prebuilt)
    t0 = time.perf_counter()
    for blk in blocks:
        imgs, state = scan(state, blk, cfg)
    sync(imgs)
    dt_scan = (time.perf_counter() - t0 - lat / 1e3) / frames

    async_cams = orbit_cameras(frames, frames, cfg, device)
    t0 = time.perf_counter()
    for camera in async_cams:
        img, state = step(state, camera, cfg)
    sync(img)
    dt_async = (time.perf_counter() - t0 - lat / 1e3) / frames
    print(f"amortized: scan x{k_frames} {dt_scan * 1e3:.1f} ms/frame  "
          f"async single {dt_async * 1e3:.1f} ms/frame", file=sys.stderr)
    mode = "scan" if dt_scan <= dt_async else "async"
    dt = max(min(dt_scan, dt_async), 1e-6)

    # secondary: frame-time percentiles, each sample a batch of BATCH
    # frames with one sync (one readback), which divides the readback's
    # jitter by BATCH and still shows a pacing spike
    per_frame = []
    for f0 in range(0, frames, BATCH):
        batch_cams = orbit_cameras(frames + f0, BATCH, cfg, device)
        t1 = time.perf_counter()
        for camera in batch_cams:
            img, state = step(state, camera, cfg)
        sync(img)
        per_frame.append(((time.perf_counter() - t1) * 1e3 - lat) / BATCH)
    # the readback time over as many trivial syncs: each sample above
    # holds one readback, so its spread is a floor on the per-frame tail
    tiny = torch.zeros((1,), dtype=torch.float32, device=device)
    sync(tiny)
    rtts = []
    for _ in range(frames):
        t1 = time.perf_counter()
        sync(tiny)
        rtts.append((time.perf_counter() - t1) * 1e3)
    print(f"per-frame(ms, {BATCH}-frame batches): "
          + " ".join(f"{t:.1f}" for t in per_frame), file=sys.stderr)
    print("readback(ms): " + " ".join(f"{t:.3f}" for t in rtts),
          file=sys.stderr)
    ordered, rtt_sorted = sorted(per_frame), sorted(rtts)
    p50 = ordered[len(ordered) // 2]
    p95 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.95))]
    rtt_p95 = rtt_sorted[min(len(rtts) - 1, int(len(rtts) * 0.95))]
    print(f"p50 {p50:.1f} ms  p95 {p95:.1f} ms  rtt_p95 {rtt_p95 - lat:.1f} "
          f"ms over median (readback latency {lat:.1f} ms subtracted; "
          f"mesh={has_mesh})", file=sys.stderr)

    # the per-pass breakdown (host ms of the frame's passes, from its
    # spans) so that a regression localizes itself; the JAX bench's
    # `tail` is `tail + taa + tonemap` here, and its `orient` (a TPU
    # layout) has no counterpart
    passes = None
    if on_card:
        passes = profile_frame(state, cam_lib.orbit_camera(
            0.5, cfg.aspect_ratio, device=device), cfg)
        print("passes(ms): " + "  ".join(
            f"{k}={v:.1f}" for k, v in passes.items())
            + f"  | sum={sum(passes.values()):.1f}", file=sys.stderr)

    fps = 1.0 / dt
    mesh_tag = "" if has_mesh else "_nomesh"
    result = {
        "metric": (f"frame_fps_64vol_all64_demo{mesh_tag}_gpu" if on_card
                   else "frame_fps_small_cpu"),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "mode": mode,
    }
    return {"result": result, "scan_ms": dt_scan * 1e3,
            "async_ms": dt_async * 1e3, "k_frames": k_frames,
            "per_frame_ms": per_frame, "p50_ms": p50, "p95_ms": p95,
            "rtt_ms": rtts, "latency_ms": lat, "mesh": has_mesh,
            "passes": passes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from multivolumes_tpu_torch.tools import tool_device

    device = tool_device(args.cpu, "multivolumes_tpu_torch.bench")
    cfg, frames = bench_config(device.type == "cuda")
    mesh_path = BUNNY if os.path.exists(BUNNY) else None
    r = run(cfg, device, frames, mesh_path)
    print(json.dumps(r["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
