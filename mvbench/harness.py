"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, the check against the reference, and the result line.

`measure` is the whole run on a device the caller chose; `run.py` is the
command, which insists on the card. The order inside a run:

1. set-up through the engine's public API, as the app does:
   `MultiRayCaster(cfg)`, `load_volume_data` of every source (the seeded
   R32F densities), `set_mesh` (the torus written under TMPDIR), then the
   traffic's [m] toggle;
2. warm-up: `WARMUP_FRAMES` through the frame loop (at least two rounds
   of the light cohort where the toggle hid the mesh after set-up; see
   `check.py`); its first frame and its frame `REPLAY_FRAMES - 1` are
   checked;
3. the window: the closed frame loop for `--seconds` seconds, each frame
   offered to the sample of checked frames;
4. with `--trace 1`, a profiled sub-window of `TRACE_FRAMES` frames
   through the same loop, with `pass:` ranges
   from the frame's own marks and `op:` ranges around the entry points
   the per-layer readers wrap;
5. the peak memory; the metrics, each from its reader; the engine freed;
6. the reference frames of the samples, and the verdict.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mvbench import check, inputs, spec as spec_lib, trace as trace_lib
from mvbench.loop import FrameLoop, stamp_latency_us
from mvbench.reference.replay import render_samples

FORBIDDEN = ("jax", "jaxlib", "flax", "multivolumes_tpu")

WARMUP_FRAMES = 8       # frames rendered after set-up, before the window
REPLAY_FRAMES = 8       # the reference renders the first this many
                        # frames in turn and checks the last of them
TRACE_FRAMES = 12       # frames of the profiled sub-window
CHECK_FRAMES = 3        # window frames sampled for the check


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (from /proc, to 10 ms)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    """The card's name, clocks, power and power limit from nvidia-smi."""
    cmd = ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
           "power.draw,power.limit,temperature.gpu",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class FrameTap:
    """Stands in for `render_frame` in the program's frame module, which
    `MultiRayCaster.render` calls: passes each call through unchanged,
    keeps its pre-TAA scene colour (`hdr`, which `render` drops), and
    hands the frame its `timer=` marks while `timer` is set."""

    def __init__(self, frame_module):
        self.module = frame_module
        self.orig = frame_module.render_frame
        self.timer = None
        self.hdr = None
        frame_module.render_frame = self

    def __call__(self, *args, **kwargs):
        out = self.orig(*args, timer=self.timer, **kwargs)
        self.hdr = out.hdr
        return out

    def close(self):
        self.module.render_frame = self.orig


class OpTap:
    """Wraps program entry points (module, name) for a traced window: each
    call runs inside a `record_function` range `op:<name>`, its operands
    kept in `calls[name]`, in call order."""

    def __init__(self, targets):
        from torch.profiler import record_function

        self.calls, self.saved = {}, []
        for module_name, name in targets:
            module = __import__(module_name, fromlist=[name])
            orig = getattr(module, name)
            self.saved.append((module, name, orig))
            self.calls[name] = []

            def wrapper(*a, _orig=orig, _name=name, **k):
                self.calls[_name].append((a, k))
                with record_function(trace_lib.OP_PREFIX + _name):
                    return _orig(*a, **k)

            setattr(module, name, wrapper)

    def close(self):
        for module, name, orig in self.saved:
            setattr(module, name, orig)


class Context:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def warmup_frames(traffic: dict, config: dict) -> int:
    n = WARMUP_FRAMES
    if config.get("mesh_triangles") and not traffic["mesh"]:
        # set-up drew the light maps under the mesh's shadow; hidden, the
        # cohort refresh draws them without: two rounds of the cohort
        # reach the steady maps the reference starts from
        n = max(n, 2 * int(config["render"]["num_volumes"]) + 1)
    return n


def setup(config: dict, traffic: dict, seed: int, device):
    """Build the engine from the seed -> (engine, densities, mesh path)."""
    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.engine import MultiRayCaster

    steps = [("imports", process_age_s())]
    render = spec_lib.render_config(config)
    cfg = RenderConfig(**render)
    dens = inputs.densities(seed, cfg.num_volume_srcs, cfg.grid_size,
                            device)
    steps.append(("densities", process_age_s()))
    mesh_path = None
    if config.get("mesh_triangles"):
        n = int(config["mesh_triangles"])
        mesh_path = inputs.write_torus(
            Path(tempfile.gettempdir()) / f"mvbench_torus{n}.obj", n)
        steps.append(("torus", process_age_s()))
    engine = MultiRayCaster(cfg, device=device)
    steps.append(("engine", process_age_s()))
    for i, d in enumerate(dens):
        engine.load_volume_data(i, d)
    steps.append(("load_volume_data", process_age_s()))
    if mesh_path is not None:
        engine.set_mesh(mesh_path)
        if not traffic["mesh"]:           # the app's [m]
            engine.config = engine.config.with_(show_mesh=False)
        steps.append(("set_mesh", process_age_s()))
    log("[setup] s of the process at the end of: " + ", ".join(
        f"{name} {t:.2f}" for name, t in steps))
    return engine, dens, mesh_path


def traced_window(loop, frame_tap, targets, frames: int):
    """`frames` frames under the profiler -> (trace report, op calls)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if loop.cuda:
        acts.append(ProfilerActivity.CUDA)
    ops = OpTap(targets)
    frame_tap.timer = trace_lib.range_marker(trace_lib.PASS_PREFIX)
    path = Path(tempfile.gettempdir()) / "mvbench_trace.json"
    try:
        with profile(activities=acts) as prof:
            with record_function(trace_lib.WINDOW):
                loop.run(frames=frames)
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            report = trace_lib.read(json.load(f), frames)
    finally:
        frame_tap.timer = None
        ops.close()
        path.unlink(missing_ok=True)
    return report, ops.calls


class Run:
    """A cell's engine, built from the seed, driven through the frame
    loop, its checked frames kept in `samples`."""

    def __init__(self, spec: spec_lib.Spec, workload: str, seed: int,
                 device, setup_hook=None):
        from multivolumes_tpu_torch.core.camera import Camera
        from multivolumes_tpu_torch.render import frame as frame_module

        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        cell = spec.workload(workload)
        self.config = spec.config(cell["config"])
        self.traffic = spec.traffic(cell["traffic"])
        self.engine, self.dens, self.mesh_path = setup(
            self.config, self.traffic, seed, self.device)
        if setup_hook is not None:
            setup_hook(self.engine)
        self.phase = inputs.orbit_phase(seed)
        self.samples = check.Samples(CHECK_FRAMES,
                                     inputs.rng(seed, "samples"))
        self.tap = FrameTap(frame_module)
        self.loop = FrameLoop(self.engine, self.traffic, self.phase, Camera,
                              on_delivered=self.samples.deliver)

    def _keep(self, frame, prev_history, image):
        self.samples.keep_start(frame, prev_history, image, self.tap.hdr,
                                self.engine.state.taa_history)

    def _keep_replayed(self, frame, prev_history, image):
        self.samples.keep_replayed(frame, prev_history, image,
                                   self.tap.hdr,
                                   self.engine.state.taa_history)

    def _offer(self, frame, prev_history, image):
        self.samples.offer(frame, prev_history, image, self.tap.hdr,
                           self.engine.state.taa_history)

    def warmup(self) -> None:
        """The warm-up frames; the first and frame `REPLAY_FRAMES - 1`
        are checked."""
        self.loop.run(frames=1, on_frame=self._keep)
        self.loop.run(frames=REPLAY_FRAMES - 2)
        self.loop.run(frames=1, on_frame=self._keep_replayed)
        self.loop.run(frames=warmup_frames(self.traffic, self.config)
                      - REPLAY_FRAMES)

    def window(self, seconds: float):
        """The measured window -> its frames."""
        return self.loop.run(seconds=seconds, on_frame=self._offer)

    def close(self) -> None:
        """Free the program: the engine and everything the loop holds (the
        samples keep their frames)."""
        self.tap.close()
        self.loop.close()
        self.engine = self.loop = self.tap = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def numbers(self, prec=None) -> dict:
        """The checked frames against the reference (`prec` its
        precision) -> {"rows": per frame, "worst"}."""
        rows = [check.frame_numbers(s, r) for s, r in zip(
            self.samples.all(), self.reference(prec))]
        return {"rows": rows, "worst": check.worst(rows)}

    def reference(self, prec=None):
        """The reference frames of the checked frames, in their order."""
        from mvbench.reference.precision import EXACT

        render = spec_lib.render_config(self.config)
        aspect = render["width"] / render["height"]
        camera, phase = self.traffic["camera"], self.phase

        def pose(i):
            return inputs.orbit(camera, phase, i, aspect)

        return render_samples(
            render, self.dens, self.mesh_path, bool(self.traffic["mesh"]),
            self.samples.start, self.samples.replayed,
            sorted(self.samples.window, key=lambda s: s.index), pose,
            self.device, prec or EXACT)


def measure(spec: spec_lib.Spec, workload: str, seed: int, seconds: float,
            trace: bool, device, setup_hook=None) -> dict:
    """One run of `workload` on `device` -> the result line's object.
    `setup_hook(engine)`, given, runs after set-up (the tests break the
    timed path with it)."""
    limits = spec.limits(workload)
    if torch.device(device).type == "cuda":
        log(f"[card] {card_line()}")
    run = Run(spec, workload, seed, device, setup_hook)
    cuda, traffic = run.cuda, run.traffic
    log(f"[setup] scene built at {process_age_s():.2f} s of the process")
    try:
        run.warmup()
        if cuda:
            stamps = stamp_latency_us(run.device)
            log(f"[stamp] delivery stamp latency on an idle stream: median "
                f"{float(np.median(stamps)):.1f} us, max "
                f"{max(stamps):.1f} us over {len(stamps)} events")
            torch.cuda.synchronize(run.device)
        setup_s = process_age_s()
        log(f"[setup] warmed up at {setup_s:.2f} s")
        window = run.window(seconds)
        if cuda:
            log(f"[card] after the window: {card_line()}")
        log(f"[window] {len(window)} frames in {seconds} s; by quarter: "
            + " ".join(str(n) for n in np.histogram(
                [f.camera_s - window[0].camera_s for f in window], 4,
                (0.0, seconds))[0])
            + f"; dispatch ms median "
            f"{1e3 * float(np.median([f.dispatch_s for f in window])):.2f}")

        metrics_spec = spec.metrics(workload, trace)
        readers = {m["name"]: spec.reader(m["name"]) for m in metrics_spec}
        report = calls = None
        if trace:
            targets = sorted({t for r in readers.values()
                              for t in getattr(r, "WRAPS", ())})
            report, calls = traced_window(run.loop, run.tap, targets,
                                          TRACE_FRAMES)
        dev_info = {"platform": "gpu" if cuda else run.device.type,
                    "kind": (torch.cuda.get_device_name(run.device) if cuda
                             else "cpu"),
                    "count": 1,
                    "memory_peak_bytes": (
                        int(torch.cuda.max_memory_allocated(run.device))
                        if cuda else 0)}
        ctx = Context(window=window, seconds=seconds, setup_s=setup_s,
                      trace=report, calls=calls,
                      trace_frames=TRACE_FRAMES)
        metrics = {}
        for m in metrics_spec:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        del ctx, calls
    finally:
        run.close()
    undelivered = sum(1 for f in window if not np.isfinite(f.delivered_s))
    result = {"attempted": len(window), "metrics": metrics,
              "device": dev_info}
    if trace:
        dev_info["busy_s"] = report["busy_s"]
        dev_info["window_s"] = report["window_s"]
        result["breakdown"] = breakdown(report)

    t_ref = process_age_s()
    numbers = run.numbers()
    log(f"[check] {len(numbers['rows'])} frames against the reference in "
        f"{process_age_s() - t_ref:.2f} s")
    for s, row in zip(run.samples.all(), numbers["rows"]):
        log(f"[check] frame {s.index}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in row.items()))
    correct, shown = check.verdict(numbers["worst"], limits)
    failed = undelivered + sum(1 for row in numbers["rows"]
                               if not check.verdict(row, limits)[0])
    return {"correct": bool(correct and not undelivered), "failed": failed,
            **result, "check": shown}


def breakdown(report: dict) -> dict:
    """The ten device operations that took most time, and the idle time
    by the pass the host was in, in seconds over the traced window."""
    ops = sorted(report["device_ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(report["idle_by_pass"].items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
