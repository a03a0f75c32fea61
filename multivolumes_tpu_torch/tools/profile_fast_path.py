"""Per-pass times and the whole frame's time of the fast path.

Counterpart of the repository's `tools/profile_fast_path.py`: at the
demo's scale (or `--small`) it prints `utils.timing.profile_frame` (the
median over `--iters` frames of each pass's host ms, from the frame's
spans) and `utils.timing.time_fn` of the whole frame step (`--iters`
frames dispatched back to back, one sync; stream time, idle gaps
included). The frame is host-bound; `tools/trace_ops.py` gives the
device busy time of each pass.

    python -m multivolumes_tpu_torch.tools.profile_fast_path [--volumes 64]
        [--small] [--iters 8] [--cpu]
"""

from __future__ import annotations

import argparse

SMALL = dict(width=320, height=200, grid_size=32, light_grid_size=16,
             max_ray_samples=64, max_light_samples=16, num_volume_srcs=2,
             cube_map_size=32, shadow_map_size=64)


def profile(cfg, device, iters: int) -> tuple:
    """-> ({pass: median ms} of `profile_frame`, ms of one frame step by
    `time_fn`), both from one engine's state (which they advance)."""
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.utils.timing import profile_frame, time_fn

    eng = MultiRayCaster(cfg, device=device)
    camera = cam_lib.orbit_camera(0.0, cfg.aspect_ratio, device=device)
    passes = profile_frame(eng.state, camera, eng.config, iters=iters)

    def step():
        out = frame_lib.render_frame(eng.state, camera, eng.config)
        eng.state = out.state
        return out.image

    return passes, time_fn(step, iters=iters)


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--volumes", type=int, default=64)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.tools import DEMO, tool_device

    device = tool_device(args.cpu, "profile_fast_path")
    base = SMALL if args.small else DEMO
    cfg = RenderConfig(**dict(base, num_volumes=args.volumes,
                              num_volume_srcs=min(args.volumes, 10)))
    passes, frame_ms = profile(cfg, device, args.iters)
    print(f"profile_fast_path: {cfg.num_volumes} volumes, "
          f"{cfg.width}x{cfg.height}, {args.iters} frames, {device}")
    for name, ms in passes.items():
        print(f"  {name:28s} {ms:9.3f} ms")
    print(f"  {'sum of the passes':28s} {sum(passes.values()):9.3f} ms")
    print(f"  {'FULL FRAME (time_fn)':28s} {frame_ms:9.3f} ms", flush=True)
    return passes, frame_ms


if __name__ == "__main__":
    main()
