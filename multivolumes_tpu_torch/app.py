"""Offline app harness: the `MultiVolumes` shell without a window.

Counterpart of `multivolumes_tpu/app.py`: the reference's CLI
(`MultiVolumes::ParseCommandLineArgs`, `MultiVolumes.cpp:543-613`) and
per-frame loop (`OnUpdate`/`OnRender`). It renders F frames of the demo
scene with TAA (optionally along the orbit-camera animation of
`MultiVolumes.cpp:328-337`) and writes a PNG screenshot, the F11 path
(`MultiVolumes.cpp:744-764`). It renders on the CUDA device; `--warp`
(the reference's software-adapter flag) renders on the CPU instead, and
without `--warp` and without a CUDA device it exits non-zero. `--mesh`
loads an OBJ as the opaque mesh (the reference's `-mesh`); each frame
then picks the mesh raster's preset from the host-side camera pose.
`--march reference` renders in the reference semantics (per-ray march,
gather composite), `--stats` adds the cull/LOD stats and the frame's
host ms per pass and host syncs (its span record, `utils.timing.SPANS`)
to each frame's line, and `--interactive` takes the hotkeys, [o] and
[w] among them. Run:

    python -m multivolumes_tpu_torch.app --numVolumes 64 --frames 8 \\
        --animate --mesh bunny.obj --out out.png
    python -m multivolumes_tpu_torch.app --warp --width 96 --height 64 \\
        --gridSize 16 --lightGridSize 8 --numVolumes 4 --frames 2 --animate
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from multivolumes_tpu_torch.config import RenderConfig
from multivolumes_tpu_torch.utils.png import write_png
from multivolumes_tpu_torch.utils.steptimer import StepTimer
from multivolumes_tpu_torch.core import camera as cam_lib
from multivolumes_tpu_torch.engine import MultiRayCaster
from multivolumes_tpu_torch.render import cull as cull_lib
from multivolumes_tpu_torch.render.perframe import build_per_object
from multivolumes_tpu_torch.render.postprocess import srgb_encode
from multivolumes_tpu_torch.utils import stats as stats_lib, timing


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # reference flags (`MultiVolumes.cpp:543-613`)
    p.add_argument("--gridSize", type=int, default=128)
    p.add_argument("--lightGridSize", type=int, default=96)
    p.add_argument("--maxRaySamples", type=int, default=256)
    p.add_argument("--maxLightSamples", type=int, default=96)
    p.add_argument("--numVolumes", type=int, default=2)
    p.add_argument("--volume", nargs="+", default=None, action="append",
                   metavar="[FILE] X Y Z SCALE",
                   help="reference -volume parity "
                        "(`MultiVolumes.cpp:559-568`): an optional R32F "
                        "volume DDS, then the scene placement x y z scale "
                        "(any trailing subset). Repeatable: occurrence "
                        "k's file loads into volume source k; later "
                        "placement floats win")
    p.add_argument("--volumeFile", type=str, default=None,
                   help="R32F volume DDS loaded into source 0 (alias for "
                        "the file part of --volume)")
    p.add_argument("--radiance", type=str, default=None,
                   help="radiance cube-map DDS (LightProbe::Init)")
    p.add_argument("--uma", action="store_true",
                   help="accepted for reference CLI parity; adapter "
                        "selection does not apply")
    p.add_argument("--mesh", type=str, default=None,
                   help="OBJ file of the opaque mesh (reference -mesh)")
    p.add_argument("--meshPos", nargs=4, type=float,
                   default=[0.0, -9.0, 0.0, 1.8],
                   metavar=("X", "Y", "Z", "SCALE"))
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=800)
    # harness extras
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--animate", action="store_true",
                   help="orbit camera ([A] hotkey)")
    p.add_argument("--fixedTimestep", type=float, default=None, metavar="FPS",
                   help="fixed-timestep clock at the given rate "
                        "(StepTimer::SetFixedTimeStep); default variable")
    p.add_argument("--no-taa", action="store_true")
    p.add_argument("--march", choices=["sweep", "reference"], default="sweep",
                   help="view-march algorithm: the plane sweep, or the "
                        "reference semantics (per-ray march, gather "
                        "composite; see render/raymarch.py)")
    p.add_argument("--warp", action="store_true",
                   help="render on the CPU (the reference's -warp "
                        "software-adapter flag, MultiVolumes.cpp:110-128)")
    p.add_argument("--bf16", dest="bf16", action="store_true", default=None,
                   help="bfloat16 sweep stacks (the default; the reference "
                        "computes in min16float)")
    p.add_argument("--f32", dest="bf16", action="store_false",
                   help="full-precision sweep stacks")
    p.add_argument("--stats", action="store_true",
                   help="print per-frame cull/LOD stats (F1-style overlay), "
                        "then the frame's host ms per pass with its self "
                        "ms (less its steps and syncs) in brackets, and "
                        "its host syncs with their wait: the numbers the "
                        "benchmark reads as <pass>.dispatch_ms, "
                        "frame.host_syncs and frame.sync_wait_ms; then "
                        "the near-ladder raster's ms and the frame's "
                        "counters (mesh.raster_samples, mesh.shade_px, "
                        "taa.reproj_px)")
    p.add_argument("--interactive", action="store_true",
                   help="read hotkey commands from stdin between frames, "
                        "the headless analog of the reference's runtime "
                        "hotkeys (`MultiVolumes::OnKeyUp`, "
                        "MultiVolumes.cpp:447-479): one letter per line: "
                        "[p]ause (Space), [a]nimate, [m]esh on/off, [o] "
                        "cycle composite (the OIT-method cycle: tile, "
                        "warp, gather), [w] march mode (sweep / "
                        "reference), [t] TAA, [f] FPS line (F1), [s] "
                        "screenshot now (F11), [q]uit")
    p.add_argument("--out", type=str, default="frame.png")
    return p


# the reference's [O] cycles its 3 OIT methods (k-buffer / ray query /
# DXR); here the 3 composites, which share the k-buffer semantics
_OIT_CYCLE = ("tile", "warp", "gather")


def apply_command(cmd: str, engine, ui: dict) -> bool:
    """One hotkey command against the live engine (returns False on
    quit)."""
    cfg = engine.config
    if cmd == "q":
        return False
    if cmd == "o":
        cur = (_OIT_CYCLE.index(cfg.composite_mode)
               if cfg.composite_mode in _OIT_CYCLE else -1)
        mode = _OIT_CYCLE[(cur + 1) % len(_OIT_CYCLE)]
        engine.config = cfg.with_(composite_mode=mode)
        print(f"composite={mode}")
    elif cmd == "w":
        mode = "reference" if cfg.march_mode == "sweep" else "sweep"
        engine.config = cfg.with_(march_mode=mode)
        print(f"march={mode}")
    elif cmd == "m":
        if engine.has_mesh:
            engine.config = engine.config.with_(
                show_mesh=not engine.config.show_mesh)
            print(f"mesh={engine.config.show_mesh}")
        else:
            print("no mesh loaded")
    elif cmd in ("p", "a", "t", "f"):
        key = {"p": "paused", "a": "animate", "t": "taa", "f": "fps"}[cmd]
        ui[key] = not ui[key]
        print(f"{key}={ui[key]}")
    elif cmd == "s":
        ui["screenshot"] = True
    elif cmd:
        print(f"unknown command {cmd!r} (p a m o w t f s q)")
    return True


def _poll_commands(timeout: float = 0.0):
    """Non-blocking read of pending stdin lines (one command each).
    Returns (commands, eof): EOF means stop polling; the remaining frames
    still render (piped scripts end with 'q' to quit early)."""
    import select

    cmds = []
    while True:
        ready, _, _ = select.select([sys.stdin], [], [], timeout)
        if not ready:
            return cmds, False
        line = sys.stdin.readline()
        if not line:
            return cmds, True
        cmds.append(line.strip().lower())
        timeout = 0.0


def parse_volume_arg(tokens, default_file=None, vol_pos_scale=None):
    """-volume [FILE] x y z s (`MultiVolumes.cpp:559-568`): a leading
    non-numeric token is the volume file; the numbers update vol_pos_scale
    in order, keeping the defaults for the rest.
    Returns (volume_file, [x, y, z, scale])."""
    volume_file = default_file
    if vol_pos_scale is None:
        vol_pos_scale = [0.0, 0.0, 0.0, 10.0]
    if tokens:
        tokens = list(tokens)
        try:
            float(tokens[0])
        except ValueError:
            volume_file = tokens.pop(0)
        for i, tok in enumerate(tokens[:4]):
            vol_pos_scale[i] = float(tok)
    return volume_file, vol_pos_scale


def parse_volume_args(occurrences, default_file=None):
    """All --volume occurrences: occurrence k's file maps to volume source
    k; the placement floats accumulate last-wins.
    Returns ([file_or_None per source index], [x, y, z, scale])."""
    files = []
    vol_pos_scale = [0.0, 0.0, 0.0, 10.0]
    for k, tokens in enumerate(occurrences or [None]):
        f, vol_pos_scale = parse_volume_arg(
            tokens, default_file=(default_file if k == 0 else None),
            vol_pos_scale=vol_pos_scale)
        files.append(f)
    return files, vol_pos_scale


def host_stats(rec) -> str:
    """A frame's span record -> its host ms per pass (self ms in
    brackets), its host syncs with the ms they waited, the near-ladder
    raster's ms where it ran, and its counters."""
    own = rec.self_ms("pass")
    near = rec.ms("step").get("mesh.near")
    return ("host ms " + ", ".join(f"{name} {ms:.2f} ({own[name]:.2f})"
                                   for name, ms in rec.ms("pass").items())
            + f" | {rec.count('sync')} host syncs, "
            f"{sum(rec.ms('sync').values()):.2f} ms"
            + ("" if near is None else f" | mesh.near {near:.2f} ms")
            + "".join(f" | {name} {v}" for name, v in rec.counters.items()))


def write_image(path: str, img: torch.Tensor) -> None:
    write_png(path, srgb_encode(img.float()).cpu().numpy())


def main(argv=None) -> None:
    args = build_arg_parser().parse_args(argv)
    if not args.warp and not torch.cuda.is_available():
        sys.exit("multivolumes_tpu_torch.app: no CUDA device; pass --warp "
                 "to render on the CPU")
    device = torch.device("cpu" if args.warp else "cuda")

    volume_files, vol_pos_scale = parse_volume_args(
        args.volume, default_file=args.volumeFile)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        grid_size=args.gridSize,
        light_grid_size=args.lightGridSize,
        max_ray_samples=args.maxRaySamples,
        max_light_samples=args.maxLightSamples,
        num_volumes=args.numVolumes,
        num_volume_srcs=min(args.numVolumes, 10),
        vol_pos_scale=tuple(vol_pos_scale),
        mesh_pos_scale=tuple(args.meshPos),
        march_mode=args.march,
    )
    if args.bf16 is not None:
        cfg = cfg.with_(use_bf16=args.bf16)
    engine = MultiRayCaster(cfg, device=device)
    for k, volume_file in enumerate(volume_files[:cfg.num_volume_srcs]):
        if volume_file:
            engine.load_volume_file(k, volume_file)
    if args.radiance:
        engine.set_radiance_file(args.radiance)
    if args.mesh:
        engine.set_mesh(args.mesh)

    aspect = cfg.aspect_ratio
    # the reference ticks a StepTimer every frame (`MultiVolumes::OnUpdate`,
    # MultiVolumes.cpp:320-322); offline the animation advances at the
    # demo's nominal 60 Hz per rendered frame, and the timer gives the
    # wall-clock stats and fixed-timestep pacing
    timer = StepTimer()
    if args.fixedTimestep:
        timer.set_fixed_time_step(True)
        timer.set_target_elapsed_seconds(1.0 / args.fixedTimestep)
    img = None
    ui = {"paused": False, "animate": args.animate,
          "taa": not args.no_taa, "fps": True, "screenshot": False}
    anim_t = 0.0
    polling = args.interactive
    for f in range(args.frames):
        if polling:
            cmds, eof = _poll_commands()
            polling = not eof
            if not all([apply_command(cmd, engine, ui) for cmd in cmds]):
                break
        if ui["animate"]:
            camera = cam_lib.orbit_camera(anim_t, aspect, device=device)
            # host-side copy of the orbit eye (MultiVolumes.cpp:328-337)
            # for the raster-preset pick: never a device read
            t = anim_t * 0.5
            eye_host = (np.sin(t) * 60.0, 6.0, np.cos(t) * 60.0)
            if not ui["paused"]:          # Space freezes the clock
                anim_t += 1.0 / 60.0
        else:
            camera = cam_lib.default_camera(aspect, device=device)
            eye_host = (4.0, 16.0, -80.0)   # MultiVolumes.cpp:273-278
        if engine.has_mesh and engine.config.show_mesh:
            engine.select_raster_preset(eye_host)
        t0 = time.perf_counter()
        img = engine.render(camera, use_taa=ui["taa"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timer.tick()
        if ui["screenshot"]:              # F11: save this frame now
            ui["screenshot"] = False
            shot = f"{args.out.rsplit('.', 1)[0]}_f{f}.png"
            write_image(shot, img)
            print(f"wrote {shot}")
        msg = f"frame {f}: {(time.perf_counter() - t0) * 1000:.1f} ms"
        if timer.frames_per_second and ui["fps"]:
            msg += f" | {timer.frames_per_second} fps"
        if args.stats:
            po = build_per_object(engine.state.volume_worlds,
                                  camera.view_proj)
            cull = cull_lib.cull_volumes(
                po, camera.eye, [cfg.width, cfg.height],
                cfg.max_ray_samples, cfg.cube_map_size, cfg.num_cube_mips)
            msg += " | " + stats_lib.format_stats(
                stats_lib.frame_stats(cull)) + " | " + host_stats(
                    timing.SPANS.last())
        print(msg, flush=True)

    if img is not None:
        write_image(args.out, img)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
