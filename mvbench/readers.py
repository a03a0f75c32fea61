"""What the metric readers (`mvbench/metrics/<name>.py`) share.

Each reader gets the run's `Context`: `window` (the measured frames,
each with its camera time, its host time inside `render` and its
delivery stamp), `seconds`, `setup_s`, and in a traced run `trace` (the
report of `trace.read` over the `trace_frames` profiled frames) and
`calls` (the operands of each call of the entry points the readers
wrap). A reader that finds nothing to read returns None, and the run
leaves its metric out.
"""

from __future__ import annotations

import numpy as np

from mvbench.roofline import least_s


def delivered_in_window(ctx) -> list:
    """The measured frames delivered within the window's seconds."""
    if not ctx.window:
        return []
    end = ctx.window[0].camera_s + ctx.seconds
    return [f for f in ctx.window if f.delivered_s <= end]


def fps(ctx):
    return len(delivered_in_window(ctx)) / ctx.seconds


def latency_ms(ctx, pct: float):
    """The `pct` percentile over every frame delivered in the window of
    its delivery stamp less the time its camera was taken (ms)."""
    lat = [f.delivered_s - f.camera_s for f in delivered_in_window(ctx)]
    return float(np.percentile(lat, pct)) * 1e3 if lat else None


def pass_ms(ctx, name: str, kind: str):
    """A pass's `host_ms` or `device_ms` per traced frame."""
    if ctx.trace is None or name not in ctx.trace["passes"]:
        return None
    return ctx.trace["passes"][name][kind]


def roofline(ctx, op: str, kernels: tuple, bound):
    """A hand kernel's share of its roofline (%) over the traced frames:
    the sum over the calls of `op` of the least time of each call's
    operands (`bound(args, kwargs) -> (bytes, flops)`), over the device
    time of the kernels named `kernels` that the calls launched."""
    if ctx.trace is None or not ctx.calls or not ctx.calls.get(op):
        return None
    traced = ctx.trace["ops"].get(op, [])
    least = device = 0.0
    for (args, kwargs), call in zip(ctx.calls[op], traced):
        dev = sum(s for name, s in call["kernels"].items()
                  if any(k in name for k in kernels))
        if dev > 0.0:
            least += least_s(*bound(args, kwargs))
            device += dev
    return 100.0 * least / device if device > 0.0 else None
