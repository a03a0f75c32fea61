"""Timing and profiling helpers, and the frame's span recorder.

Counterpart of `multivolumes_tpu/utils/timing.py`. On the card a sync is
`torch.cuda.synchronize` and timings are CUDA events around work that is
dispatched without a sync in between; on the CPU they are the host clock.

`SPANS` records, on the host clock, every `render_frame` call: one
`frame` span keyed by the state's frame index, a `pass` span between
each of the frame's marks (`render_frame(timer=)`), `step` spans
(`span(name)`) inside the passes that hold most of the host time, and a
`sync` span around each place the frame makes the host wait for the
device (`host_read(site, fn)`), and counters (`add(name, value)`): host
numbers summed into the frame's record, such as the samples a pass
launches. It keeps the last `KEEP_FRAMES` frames
in memory and writes nothing out. While a `torch.profiler` records, each
span of a frame also opens a `record_function` range `span:<name>`, so a
device trace places its kernels and idle gaps in the program's spans on
its own clock (`tools/trace_ops.py`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from pathlib import Path
from typing import Callable

import torch

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "trace"
TRACE_FILE = "trace.json"

SPAN_PREFIX = "span:"   # the profiler ranges of the recorder's spans
_now = time.perf_counter_ns
KEEP_FRAMES = 4096      # frames the recorder keeps, the newest


class FrameRecord:
    """The spans of one `render_frame` call, in the order they opened;
    `spans[0]` is the frame span. A span is a list [name, kind, parent,
    start_ns, end_ns]: `parent` the index of the enclosing span (-1 for
    the frame span), the times `time.perf_counter_ns` (`end_ns` 0 while
    open). `counters` is {name: summed value} of the frame's `add`
    calls."""

    __slots__ = ("index", "spans", "counters")

    def __init__(self, index: int):
        self.index, self.spans, self.counters = index, [], {}

    def ms(self, kind: str) -> dict:
        """{name: summed ms} of the spans of `kind`, in first-open order
        (a pass the sharded step runs once per device sums its runs)."""
        out = {}
        for name, k, _parent, t0, t1 in self.spans:
            if k == kind:
                out[name] = out.get(name, 0.0) + (t1 - t0) / 1e6
        return out

    def self_ms(self, kind: str) -> dict:
        """{name: summed self ms} of the spans of `kind`: each span's
        duration less its children's."""
        child = [0] * len(self.spans)
        for _name, _k, parent, t0, t1 in self.spans:
            if parent >= 0:
                child[parent] += t1 - t0
        out = {}
        for (name, k, _parent, t0, t1), c in zip(self.spans, child):
            if k == kind:
                out[name] = out.get(name, 0.0) + (t1 - t0 - c) / 1e6
        return out

    def count(self, kind: str) -> int:
        return sum(1 for s in self.spans if s[1] == kind)


class _Step:
    """`with` block of one step span; nothing is recorded outside a
    frame."""

    __slots__ = ("rec", "name", "i")

    def __init__(self, rec, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = (-1 if self.rec.current is None
                  else self.rec._open(self.name, "step"))
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.i >= 0:
            self.rec._close(self.i, _now())


class SpanRecorder:
    """The frame records of one process, by frame index, the newest
    `keep`; `current` is the open frame's record, None between frames.
    A frame index recorded again replaces its older record. Spans nest by
    `with` blocks and pass marks; a `sync` span has no children."""

    def __init__(self, keep: int = KEEP_FRAMES):
        self.keep = keep
        self.frames = {}
        self.current = None
        self._stack = []            # open spans of `current`, innermost last
        self._pass = -1             # the open pass span
        self._ranges = None         # {span: its profiler range} if profiled

    def last(self):
        """The newest frame record, or None."""
        return next(reversed(self.frames.values()), None)

    @contextlib.contextmanager
    def frame(self, index: int):
        """One frame: its record, its frame span and, while a profiler
        records, its `span:` ranges (checked once, here)."""
        rec = FrameRecord(index)
        self.current, self._stack, self._pass = rec, [], -1
        self._ranges = ({} if torch.autograd.profiler._is_profiler_enabled
                        else None)
        self._open("frame", "frame")
        try:
            yield rec
        finally:
            self._close(0, _now())
            self.frames.pop(index, None)
            self.frames[index] = rec
            while len(self.frames) > self.keep:
                del self.frames[next(iter(self.frames))]
            self.current, self._pass, self._ranges = None, -1, None

    def mark(self, name, timer=None) -> None:
        """A pass boundary: close the open pass and open pass `name` (None
        opens none) at one time stamp. `timer(name)`, if given, is called
        in between, so that profiler ranges it closes and opens there nest
        with the `span:` ranges."""
        now = _now()
        if self._pass >= 0:
            self._close(self._pass, now)
            self._pass = -1
        if timer is not None:
            timer(name)
        if name is not None and self.current is not None:
            self._pass = self._open(name, "pass", now)

    def host_read(self, site: str, fn):
        """`fn()` inside a `sync` span named `site`."""
        if self.current is None:
            return fn()
        i = self._open(site, "sync")
        try:
            return fn()
        finally:
            self._close(i, _now())

    def add(self, name: str, value) -> None:
        """Sum `value` into the open frame's counter `name`."""
        rec = self.current
        if rec is not None:
            rec.counters[name] = rec.counters.get(name, 0) + value

    def _open(self, name: str, kind: str, now: int = 0) -> int:
        spans, stack = self.current.spans, self._stack
        i = len(spans)
        spans.append([name, kind, stack[-1] if stack else -1,
                      now or _now(), 0])
        stack.append(i)
        if self._ranges is not None:
            r = torch.autograd.profiler.record_function(SPAN_PREFIX + name)
            r.__enter__()
            self._ranges[i] = r
        return i

    def _close(self, i: int, now: int) -> None:
        """Close span `i` and every span still open inside it."""
        spans, stack = self.current.spans, self._stack
        while stack and stack[-1] >= i:
            j = stack.pop()
            spans[j][4] = now
            if self._ranges is not None:
                self._ranges.pop(j).__exit__(None, None, None)


SPANS = SpanRecorder()


def span(name: str) -> _Step:
    """`with span(name):` records a step span of the open frame."""
    return _Step(SPANS, name)


def add(name: str, value) -> None:
    """Sum the host number `value` into the open frame's counter `name`
    (`FrameRecord.counters`); outside a frame nothing is recorded. It
    reads nothing from the device."""
    SPANS.add(name, value)


def host_read(site: str, fn):
    """Run `fn`, which makes the host wait for the device, inside a `sync`
    span named `site`: a read of a device value, or an upload from
    pageable host memory (a scalar or a host array written into a device
    tensor), which PyTorch follows with a stream synchronisation. Every
    such place on the frame's main path goes through here, so the frame
    records count its host syncs and time each wait."""
    return SPANS.host_read(site, fn)


def _leaves(tree):
    """The tensors of a nest of tuples, lists, dicts and dataclasses."""
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _on_card(tree) -> bool:
    return any(x.is_cuda for x in _leaves(tree))


def sync(tree) -> float:
    """Wait for the work that produces `tree`: `torch.cuda.synchronize` on
    each card a tensor leaf lies on (CPU work is already done). Returns
    the first element of the last non-empty leaf, as the JAX function
    does, or 0.0."""
    leaves = list(_leaves(tree))
    for dev in {x.device for x in leaves if x.is_cuda}:
        torch.cuda.synchronize(dev)
    for leaf in reversed(leaves):
        if leaf.numel():
            return float(leaf.reshape(-1)[0])
    return 0.0


def readback_latency(samples: int = 5) -> float:
    """Measured ms of one tiny device-to-host readback (`.item()` of a
    one-element tensor on the card)."""
    x = torch.zeros(1, device="cuda")
    x.item()
    t0 = time.perf_counter()
    for _ in range(samples):
        x.item()
    return (time.perf_counter() - t0) / samples * 1e3


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 8,
            **kwargs) -> float:
    """Mean ms of one call of `fn(*args, **kwargs)` over `iters` calls
    dispatched without a sync between them, after `warmup` calls. When
    the arguments or the result lie on the card: stream time between two
    CUDA events around the loop, one sync at the end; else the host
    clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    cuda = _on_card((args, kwargs, out))
    sync(out)
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(iters):
            out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    sync(out)
    return (time.perf_counter() - t0) * 1e3 / iters


@contextlib.contextmanager
def profile_trace(log_dir=None):
    """A `torch.profiler.profile` context (CPU activity, and CUDA activity
    where there is a card) that writes a Chrome trace to
    `log_dir/trace.json` (default: `build/trace` of the checkout) when it
    closes. Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir if log_dir is not None else TRACE_DIR)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))


def profile_frame(state, camera, config, iters: int = 3,
                  mesh=None) -> dict:
    """Per-pass host ms of `iters` frames of `render_frame` from `state` ->
    {pass: median ms}. The light stacks of `state` advance in place as
    the frames do.

    Each pass is its `pass` span in the frame's record (`SPANS`): the host
    time from the pass's mark to the next, on the card as on the CPU,
    the waits of its host syncs included. The device's busy time per
    pass comes from `tools/trace_ops.py`. Each frame is waited for before
    the next, so no frame's syncs wait for an earlier one.

    The keys are the port's pass names; the JAX `profile_frame`'s keys
    time the same work as separate jits: `prep` ~ `cull`; `mesh` (with
    the opaque mesh); `light` ~ `light_sweep` / `light_march`; `sweep` ~
    `view_march(sweep)` / `view_march`; `sky` ~ `sky`; `composite` ~
    `oit_composite`; `tail` (the background blend); `taa` ~ `taa`;
    `tonemap` (the display map)."""
    from multivolumes_tpu_torch.render import frame as frame_lib

    per = {}
    sync(state)
    for _ in range(iters):
        index = state.frame_idx
        out = frame_lib.render_frame(state, camera, config, mesh=mesh)
        state = out.state
        sync(out.image)
        for name, ms in SPANS.frames[index].ms("pass").items():
            per.setdefault(name, []).append(ms)
    return {name: statistics.median(v) for name, v in per.items()}
