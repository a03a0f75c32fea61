"""Device time and idle gaps of the frame by the program's spans, from a
`torch.profiler` trace.

Counterpart of the repository's `tools/trace_ops.py`. It renders N frames
of the demo under `utils.timing.profile_trace`; while the profiler
records, every span of the frame's recorder (`utils.timing.SPANS`: the
frame, its passes, the steps inside them and the host syncs) is also a
`record_function` range `span:<name>` on the trace's own clock. It reads
the exported Chrome trace:

* each device event (kernel, memcpy, memset) is tied by its
  `correlation` id to the runtime or driver call that launched it
  (`cudaLaunchKernel`, `cudaLaunchKernelExC` for the hand kernels, which
  are launched through ctypes and have no aten op above them);
* that call is placed in the innermost span whose range holds its host
  timestamp, and so in that span's pass (the span just under the
  frame). A kernel runs later than it is launched, so its own device
  timestamp cannot place it;
* each gap in which the device ran nothing goes to the innermost span
  the host was in when the gap began.

It prints, per pass, the device ms and kernels per frame and the top
kernels, then the device total and what it could not attribute to a
span, then the innermost spans by the idle time that began in them. On
the CPU (`--cpu`) there are no device events, and only the spans' host
times are shown.

    python -m multivolumes_tpu_torch.tools.trace_ops [--frames 4]
        [--volumes 64] [--no-mesh] [--top 5] [--dir DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import bisect
import json
import re

from multivolumes_tpu_torch.utils.timing import SPAN_PREFIX

FRAME = "frame"         # the recorder's frame span
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespaces of
    the anonymous kind and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(", 1)[0][:90]


def trace_frames(engine, cameras, log_dir=None):
    """Render one frame per camera from `engine.state` (advancing it)
    under `utils.timing.profile_trace` -> the path of the Chrome trace."""
    from multivolumes_tpu_torch.render import frame as frame_lib
    from multivolumes_tpu_torch.utils import timing

    timing.sync(engine.state)
    with timing.profile_trace(log_dir) as log_dir:
        for cam in cameras:
            out = frame_lib.render_frame(engine.state, cam, engine.config)
            engine.state = out.state
        timing.sync(out.image)
    return log_dir / timing.TRACE_FILE


class Spans:
    """The `span:` ranges of a trace, nested: `ranges[i]` is (start, end,
    name, parent index or -1, pass name or None), in order of start."""

    def __init__(self, events):
        raw = sorted(((e["ts"], e["ts"] + e["dur"],
                       e["name"][len(SPAN_PREFIX):])
                      for e in events if e.get("ph") == "X"
                      and e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith(SPAN_PREFIX)),
                     key=lambda r: (r[0], -r[1]))
        self.ranges, stack = [], []
        for t0, t1, name in raw:
            while stack and self.ranges[stack[-1]][1] <= t0:
                stack.pop()
            parent = stack[-1] if stack else -1
            if name == FRAME:
                pass_name = None
            elif parent < 0 or self.ranges[parent][2] == FRAME:
                pass_name = name
            else:
                pass_name = self.ranges[parent][4]
            self.ranges.append((t0, t1, name, parent, pass_name))
            stack.append(len(self.ranges) - 1)
        self.starts = [r[0] for r in self.ranges]

    def innermost(self, ts) -> int:
        """The index of the innermost range holding host time `ts`, else
        -1."""
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and ts > self.ranges[i][1]:
            i = self.ranges[i][3]
        return i


def attribute(trace: dict, frames: int) -> dict:
    """The device events and idle gaps of a Chrome trace by the span that
    launched them, per frame -> {"passes": {pass: {"host_ms",
    "device_ms", "kernels", "idle_ms", "by_kernel": {short name: [ms,
    launches]}}}, "spans": {innermost span: {"pass", "device_ms",
    "kernels", "idle_ms"}}, "device_ms", "kernels", "idle_ms",
    "unattributed_ms", "unattributed": {short name: [ms, launches]}}.
    The idle time counts within the frames' spans."""
    events = trace["traceEvents"]
    spans = Spans(events)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    passes, inner = {}, {}
    for t0, t1, name, _parent, pass_name in spans.ranges:
        if pass_name is None:
            continue
        p = passes.setdefault(pass_name, {"host_ms": 0.0, "device_ms": 0.0,
                                          "kernels": 0, "idle_ms": 0.0,
                                          "by_kernel": {}})
        if name == pass_name:
            p["host_ms"] += (t1 - t0) / 1e3
    lost = {"device_ms": 0.0, "kernels": 0, "by_kernel": {}}

    def span_of(i):
        """(the innermost span's entry, its pass's entry or None)."""
        _t0, _t1, name, _parent, pass_name = spans.ranges[i]
        d = inner.setdefault(name, {"pass": pass_name, "device_ms": 0.0,
                                    "kernels": 0, "idle_ms": 0.0})
        return d, passes.get(pass_name)

    total = count = 0.0
    intervals = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ms = e.get("dur", 0.0) / 1e3
        total += ms
        count += 1
        intervals.append((e["ts"], e["ts"] + e.get("dur", 0.0)))
        ts = launched.get(e.get("args", {}).get("correlation"))
        i = -1 if ts is None else spans.innermost(ts)
        into = lost
        if i >= 0:
            d, p = span_of(i)
            d["device_ms"] += ms
            d["kernels"] += 1
            into = p if p is not None else lost
        into["device_ms"] += ms
        into["kernels"] += 1
        k = into["by_kernel"].setdefault(short_name(e.get("name", "?")),
                                         [0.0, 0])
        k[0] += ms
        k[1] += 1

    idle = 0.0
    for a, b in _gaps(intervals, [r for r in spans.ranges
                                  if r[2] == FRAME] if intervals else []):
        ms = (b - a) / 1e3
        idle += ms
        i = spans.innermost(a)
        if i >= 0:
            d, p = span_of(i)
            d["idle_ms"] += ms
            if p is not None:
                p["idle_ms"] += ms

    def per_frame(d):
        out = {key: (v / frames if key in ("host_ms", "device_ms",
                                           "kernels", "idle_ms") else v)
               for key, v in d.items()}
        if "by_kernel" in d:
            out["by_kernel"] = {n: [ms / frames, c / frames]
                                for n, (ms, c) in d["by_kernel"].items()}
        return out

    return {"passes": {n: per_frame(p) for n, p in passes.items()},
            "spans": {n: per_frame(d) for n, d in inner.items()},
            "device_ms": total / frames, "kernels": count / frames,
            "idle_ms": idle / frames,
            "unattributed_ms": lost["device_ms"] / frames,
            "unattributed": per_frame(lost)["by_kernel"]}


def _gaps(intervals, frame_ranges):
    """The stretches inside the frame ranges in which no device interval
    runs -> [(start, end)]."""
    union = []
    for a, b in sorted(intervals):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    ends = [b for _a, b in union]
    out = []
    for w0, w1, *_ in frame_ranges:
        cur = w0
        for a, b in union[bisect.bisect_right(ends, w0):]:
            if a >= w1:
                break
            if a > cur:
                out.append((cur, a))
            cur = b
        if cur < w1:
            out.append((cur, w1))
    return out


def passes_of(report: dict, kernel: str) -> set:
    """The passes in which a kernel whose name holds `kernel` ran."""
    return {p for p, d in report["passes"].items()
            if any(kernel in n for n in d["by_kernel"])}


def print_report(report: dict, top: int = 5) -> None:
    for name, p in report["passes"].items():
        tops = sorted(p["by_kernel"].items(), key=lambda kv: -kv[1][0])[:top]
        print(f"  {name:10s} device {p['device_ms']:8.3f} ms/frame in "
              f"{p['kernels']:6.1f} kernels; host {p['host_ms']:8.3f} ms; "
              f"idle {p['idle_ms']:8.3f} ms"
              + "".join(f"\n      {ms:8.3f} ms x{c:5.1f}  {n}"
                        for n, (ms, c) in tops))
    total = report["device_ms"]
    share = report["unattributed_ms"] / total if total else 0.0
    print(f"device total {total:.3f} ms/frame in {report['kernels']:.1f} "
          f"kernels; not attributed to a pass "
          f"{report['unattributed_ms']:.3f} ms/frame ({share:.4f})"
          + "".join(f"\n      {ms:8.3f} ms x{c:5.1f}  {n}" for n, (ms, c)
                    in sorted(report["unattributed"].items(),
                              key=lambda kv: -kv[1][0])[:top]))
    print(f"device idle {report['idle_ms']:.3f} ms/frame inside the frames; "
          f"by the innermost span the host was in as each gap began:"
          + "".join(f"\n  {d['idle_ms']:8.3f} ms idle, {d['device_ms']:8.3f} "
                    f"ms device in {d['kernels']:6.1f} kernels  {n} "
                    f"({d['pass']})" for n, d in sorted(
                        report["spans"].items(),
                        key=lambda kv: -kv[1]["idle_ms"])[:2 * top]),
          flush=True)


def run(cfg, device, frames: int, mesh_path=None, log_dir=None) -> dict:
    """Build the engine of `cfg`, render one frame, trace `frames` orbit
    frames -> the report of `attribute`."""
    from multivolumes_tpu_torch.core import camera as cam_lib
    from multivolumes_tpu_torch.engine import MultiRayCaster
    from multivolumes_tpu_torch.tools import ORBIT_EYE
    from multivolumes_tpu_torch.utils.timing import sync

    eng = MultiRayCaster(cfg, device=device)
    if mesh_path is not None:
        eng.set_mesh(mesh_path)
        eng.select_raster_preset(ORBIT_EYE)
    cams = [cam_lib.orbit_camera(f / 60.0, cfg.aspect_ratio, device=device)
            for f in range(frames + 1)]
    sync(eng.render(cams[0]))
    path = trace_frames(eng, cams[1:], log_dir)
    with open(path) as f:
        return attribute(json.load(f), frames)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--volumes", type=int, default=64)
    ap.add_argument("--no-mesh", action="store_true")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--dir", default=None,
                    help="where the trace goes (default build/trace)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from multivolumes_tpu_torch.config import RenderConfig
    from multivolumes_tpu_torch.tools import (DEMO, DEMO_MESH_TRIS,
                                              tool_device, torus_mesh)

    device = tool_device(args.cpu, "trace_ops")
    cfg = RenderConfig(**dict(DEMO, num_volumes=args.volumes,
                              num_volume_srcs=min(args.volumes, 10)))
    mesh_path = None if args.no_mesh else torus_mesh(DEMO_MESH_TRIS)
    report = run(cfg, device, args.frames, mesh_path, args.dir)
    print(f"trace_ops: {args.frames} frames, {cfg.num_volumes} volumes, "
          f"{cfg.width}x{cfg.height}, mesh={mesh_path is not None}, "
          f"{device}")
    print_report(report, args.top)
    return report


if __name__ == "__main__":
    main()
