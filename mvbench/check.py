"""Whether the timed path's frames are right: the sampled frames against
the reference, rendered again from the benchmark's own inputs.

What is kept from the run (`Samples`):

* the start: the first frame the engine renders after set-up, from the
  state set-up left (its light maps, shadow map and empty TAA history);
* the replayed frame: the last of the first `REPLAY_FRAMES` frames after
  set-up (`harness.py`);
* a sample of the window's frames, drawn from the seed (a reservoir, so
  every delivered frame is equally likely): for each, the TAA history
  it started from;

and for each, what it produced: the pre-TAA scene colour (`hdr`), the
new history and the display image; where the traffic delivers to the
host, the image is the host copy the client received.

The reference (`mvbench.reference`) builds the scene again from the
seeded densities, the mesh file and the config, and renders the start
frame from its own set-up state, then every frame after it up to the
replayed one in turn, carrying its own state (light cohort, TAA history,
the mesh's last transform): the replayed frame checks the history that
the program carried over those frames. A window frame's history is the
program's state after hundreds of frames, more than the reference can
replay in a run; so the reference renders a sampled window frame from
the program's history before it, and everything else (per-object
matrices, cull and LOD, light maps, shadow map, cube maps, sky,
composite, mesh, TAA resolve, tone map) from its own state: the light
maps of a frame are the fixed point of the per-frame cohort refresh,
which the reference reaches by one full refresh under the frame's
shadow setting. The history each sampled frame writes is compared too,
so each step of the carried history in the window is checked where it
is made.

The numbers are the largest, over the checked frames, of the 99.9th
percentile and of the largest absolute difference per pixel and channel
of the scene colour, the history and the image; a cell's limits file
names those it compares.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch


@dataclasses.dataclass
class Sample:
    index: int                # the engine's frame index
    prev_history: torch.Tensor
    hdr: torch.Tensor = None
    history: torch.Tensor = None
    image: torch.Tensor = None


class Samples:
    """The start frame, the replayed frame and a reservoir of `k` window
    frames."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.start = None
        self.replayed = None
        self.window = []
        self.seen = 0

    def keep_start(self, frame, prev_history, image, hdr, history):
        self.start = Sample(frame.index, prev_history, hdr, history, image)

    def keep_replayed(self, frame, prev_history, image, hdr, history):
        self.replayed = Sample(frame.index, prev_history, hdr, history,
                               image)

    def deliver(self, index: int, host_image: torch.Tensor) -> None:
        """Frame `index` was delivered into `host_image`: a kept frame's
        image becomes a copy of it (the buffer is written again by a
        later frame)."""
        for s in self.all():
            if s.index == index:
                s.image = host_image.clone()

    def offer(self, frame, prev_history, image, hdr, history):
        """Reservoir sampling (algorithm R) over the window's frames."""
        s = Sample(frame.index, prev_history, hdr, history, image)
        if len(self.window) < self.k:
            self.window.append(s)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.window[j] = s
        self.seen += 1

    def all(self):
        return [s for s in (self.start, self.replayed) if s is not None] \
            + sorted(self.window, key=lambda s: s.index)


def gaps(a: torch.Tensor, b: torch.Tensor) -> dict:
    """|a - b| per element -> {"p999", "max"}; a NaN on one side only
    is an infinite gap, a NaN on both none."""
    a, b = a.float(), b.float()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, 0.0, (a - b).abs())
    d = torch.nan_to_num(d, nan=float("inf")).flatten()
    k = max(1, int(np.ceil(0.999 * d.numel())))
    return {"p999": float(d.kthvalue(k).values), "max": float(d.max())}


def frame_numbers(prog: Sample, ref) -> dict:
    """The program's sample against the reference's frame output."""
    out = {}
    for field, got, want in (("hdr", prog.hdr, ref.hdr),
                             ("history", prog.history,
                              ref.state.taa_history),
                             ("image", prog.image, ref.image)):
        for stat, v in gaps(got.to(want.device), want).items():
            out[f"{field}_{stat}"] = v
    return out


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}) over the limited numbers:
    correct when each is at or under its limit."""
    shown = {n: {"value": numbers[n], "limit": float(lim)}
             for n, lim in limits.items()}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown


def print_numbers(shown: dict) -> None:
    for name, v in shown.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
