"""Reading a profiler trace of the frame loop: device time by pass and by
hand-kernel call, the device's busy time, and the idle gaps.

The pass attribution is a frozen copy of `tools/trace_ops.py` of the
port (`pass_marker`, `attribute`, `short_name`): a `record_function`
range `pass:<name>` is open from each `render_frame(timer=)` mark to the
next; each device event (kernel, memcpy, memset) is tied by its
`correlation` id to the runtime or driver call that launched it, and
that call is placed in the range that holds its host timestamp (a
kernel runs later than it is launched, so its own timestamp cannot place
it). The hand-kernel calls get ranges `op:<name>` the same way, so the
device time of each launch of B1-B5 is told apart from the PyTorch glue
around it.
"""

from __future__ import annotations

import bisect
import re

PASS_PREFIX = "pass:"
OP_PREFIX = "op:"
WINDOW = "mvbench:window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespaces of
    the anonymous kind and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(", 1)[0][:90]


def range_marker(prefix: str):
    """A callback that keeps a `record_function` range `<prefix><name>`
    open from each call to the next (None closes the last): the
    `render_frame(timer=)` marks."""
    from torch.profiler import record_function

    open_ranges = []

    def mark(name):
        if open_ranges:
            open_ranges.pop().__exit__(None, None, None)
        if name is not None:
            r = record_function(prefix + name)
            r.__enter__()
            open_ranges.append(r)

    return mark


def _ranges(events, prefix):
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(prefix):])
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e.get("name", "").startswith(prefix))


def _locate(ranges, starts, ts):
    """The index of the range that holds host time `ts`, else -1 (the
    ranges of one list follow each other without overlap)."""
    i = bisect.bisect_right(starts, ts) - 1
    return i if i >= 0 and ts <= ranges[i][1] else -1


def read(trace: dict, frames: int) -> dict:
    """A Chrome trace of `frames` frames -> {"passes": {pass: {"host_ms",
    "device_ms", "kernels"}} per frame, "ops": {op: [{"device_s",
    "kernels": {short name: s}}, ...] one entry per call in order},
    "device_ops": {short name: s}, "busy_s", "window_s", "kernels",
    "idle_by_pass": {pass or "(between passes)": s}}."""
    events = trace["traceEvents"]
    passes = _ranges(events, PASS_PREFIX)
    ops = _ranges(events, OP_PREFIX)
    pstarts = [r[0] for r in passes]
    ostarts = [r[0] for r in ops]
    window = [e for e in events if e.get("ph") == "X"
              and e.get("name") == WINDOW]
    w0 = window[0]["ts"] if window else min(r[0] for r in passes)
    w1 = window[0]["ts"] + window[0]["dur"] if window else max(
        r[1] for r in passes)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}

    by_pass = {name: {"host_ms": 0.0, "device_ms": 0.0, "kernels": 0}
               for _t0, _t1, name in passes}
    for t0, t1, name in passes:
        by_pass[name]["host_ms"] += (t1 - t0) / 1e3
    calls = [{"name": name, "device_s": 0.0, "kernels": {}}
             for _t0, _t1, name in ops]
    device_ops, intervals, kernels = {}, [], 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        dur = e.get("dur", 0.0)
        short = short_name(e.get("name", "?"))
        device_ops[short] = device_ops.get(short, 0.0) + dur / 1e6
        intervals.append((e["ts"], e["ts"] + dur))
        kernels += e.get("cat") == "kernel"
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = _locate(passes, pstarts, ts)
        if i >= 0:
            p = by_pass[passes[i][2]]
            p["device_ms"] += dur / 1e3
            p["kernels"] += 1
        j = _locate(ops, ostarts, ts)
        if j >= 0:
            c = calls[j]
            c["device_s"] += dur / 1e6
            c["kernels"][short] = c["kernels"].get(short, 0.0) + dur / 1e6

    busy, idle_by_pass = _busy_and_gaps(intervals, w0, w1, passes, pstarts)
    op_calls = {}
    for c in calls:
        op_calls.setdefault(c.pop("name"), []).append(c)
    return {"passes": {n: {k: v / frames for k, v in p.items()}
                       for n, p in by_pass.items()},
            "ops": op_calls, "device_ops": device_ops,
            "busy_s": busy, "window_s": (w1 - w0) / 1e6,
            "kernels": kernels, "idle_by_pass": idle_by_pass}


def _busy_and_gaps(intervals, w0, w1, passes, pstarts):
    """The union of the device intervals inside [w0, w1] (s), and the
    idle time inside it by the pass range the host was in when each gap
    began (s)."""
    busy, idle, cur = 0.0, {}, w0
    for a, b in sorted(intervals):
        a, b = max(a, w0), min(b, w1)
        if b <= cur:
            continue
        if a > cur:
            _add_gap(idle, cur, a, passes, pstarts)
            cur = a
        busy += b - cur
        cur = b
    if cur < w1:
        _add_gap(idle, cur, w1, passes, pstarts)
    return busy / 1e6, idle


def _add_gap(idle, a, b, passes, pstarts):
    i = _locate(passes, pstarts, a)
    key = PASS_PREFIX + passes[i][2] if i >= 0 else "(between passes)"
    idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
