"""The client's frame loop: a closed loop with frames in flight.

The loop takes the camera of frame N only after frame N - F has been
delivered (F = the traffic's `frames_in_flight`), renders it through
`MultiRayCaster.render`, and hands it over for delivery:

* `delivery: device`: the frame is delivered when a CUDA event recorded
  after its `render` call completes (the on-screen app, which presents
  from the card);
* `delivery: host`: when its display image has been copied into pinned
  host memory (a headless or remote viewer that receives every frame);
  `on_delivered(index, host_image)` sees each host copy once it is
  delivered, before the buffer is written again.

A waiter thread blocks on each frame's event in turn and stamps the
delivery on the host clock the moment the event completes, so a stamp
never waits for the loop to look. On the CPU (the harness's tests) a
frame is delivered when `render` returns.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from mvbench import inputs


@dataclasses.dataclass
class Frame:
    index: int              # the engine's frame index (frames rendered
                            # before it in the process)
    camera_s: float         # host time the frame's camera was taken
    dispatch_s: float       # host time spent inside `render`
    delivered_s: float = float("nan")


class Deliveries:
    """The waiter thread: stamps each submitted frame's delivery."""

    def __init__(self):
        self._queue = queue.Queue()
        self._stamps = {}
        self._cv = threading.Condition()
        self._thread = threading.Thread(target=self._wait_each,
                                        name="mvbench-delivery", daemon=True)
        self._thread.start()

    def _wait_each(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            index, event = item
            if event is not None:
                event.synchronize()
            stamp = time.perf_counter()
            with self._cv:
                self._stamps[index] = stamp
                self._cv.notify_all()

    def submit(self, index: int, event) -> None:
        """Frame `index` is delivered when `event` completes (at once when
        it is None)."""
        self._queue.put((index, event))

    def wait(self, index: int) -> float:
        """Block until frame `index` is delivered -> its stamp."""
        with self._cv:
            self._cv.wait_for(lambda: index in self._stamps)
            return self._stamps[index]

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join()


class FrameLoop:
    """Drives `engine.render` along a traffic file's camera path."""

    def __init__(self, engine, traffic: dict, phase: float, camera_cls,
                 on_delivered=None):
        self.engine = engine
        self.camera_spec = traffic["camera"]
        self.in_flight = int(traffic["frames_in_flight"])
        self.host_delivery = traffic["delivery"] == "host"
        if traffic["delivery"] not in ("device", "host"):
            raise ValueError(f"delivery {traffic['delivery']!r}")
        self.phase = phase
        self.camera_cls = camera_cls
        self.device = engine.device
        self.cuda = self.device.type == "cuda"
        cfg = engine.config
        self.aspect = cfg.width / cfg.height
        self.frame = 0
        self.handed = 0         # frames before it were handed over
        self.on_delivered = on_delivered
        self.deliveries = Deliveries()
        # pinned camera slots: slot N % (F + 1) is written again only
        # once frame N - F is delivered, so its upload has run
        self._cam_slots = [torch.empty(35, dtype=torch.float32,
                                       pin_memory=self.cuda)
                           for _ in range(self.in_flight + 1)]
        self._images = [torch.empty((cfg.height, cfg.width, 3),
                                    dtype=torch.float32,
                                    pin_memory=self.cuda)
                        for _ in range(self.in_flight)] \
            if self.host_delivery else None

    def pose(self, index: int):
        """Frame `index`'s host pose -> (eye, view, proj)."""
        return inputs.orbit(self.camera_spec, self.phase, index, self.aspect)

    def camera(self, index: int):
        eye, view, proj = self.pose(index)
        slot = self._cam_slots[index % len(self._cam_slots)]
        slot.numpy()[:] = np.concatenate([eye, view.ravel(), proj.ravel()])
        dev = (slot.to(self.device, non_blocking=True) if self.cuda
               else slot.clone())
        return self.camera_cls(eye=dev[:3], view=dev[3:19].view(4, 4),
                               proj=dev[19:35].view(4, 4)), eye

    def run(self, seconds: float | None = None, frames: int | None = None,
            on_frame=None) -> list[Frame]:
        """Render until `seconds` have passed since the first camera was
        taken, or `frames` frames, then wait for every frame to be
        delivered -> the frames, stamped. `on_frame(frame, prev_history,
        image)` is called after each `render`."""
        engine, out = self.engine, []
        first = self.frame
        deadline = None
        while frames is None or len(out) < frames:
            index = self.frame
            if index - self.in_flight >= first:
                self.deliveries.wait(index - self.in_flight)
                self._hand_over(index - self.in_flight + 1)
            now = time.perf_counter()
            if deadline is None and seconds is not None:
                deadline = now + seconds
            if deadline is not None and now >= deadline:
                break
            cam, eye = self.camera(index)
            if engine.has_mesh and engine.config.show_mesh:
                engine.select_raster_preset(tuple(float(e) for e in eye))
            prev_history = engine.state.taa_history
            t0 = time.perf_counter()
            image = engine.render(cam)
            dispatch = time.perf_counter() - t0
            if self.host_delivery:
                self._send(index, image)
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
            self.deliveries.submit(index, event)
            frame = Frame(index, now, dispatch)
            if on_frame is not None:
                on_frame(frame, prev_history, image)
            out.append(frame)
            self.frame += 1
        for frame in out:
            frame.delivered_s = self.deliveries.wait(frame.index)
        self._hand_over(self.frame)
        return out

    def _send(self, index: int, image: torch.Tensor) -> None:
        """Start the copy of frame `index`'s image into its pinned host
        buffer (host delivery)."""
        self._images[index % self.in_flight].copy_(image, non_blocking=True)

    def _hand_over(self, upto: int) -> None:
        """Frames before `upto` are delivered: hand each host copy not yet
        handed over to `on_delivered`."""
        while self.handed < upto:
            if self.host_delivery and self.on_delivered is not None:
                self.on_delivered(self.handed,
                                  self._images[self.handed % self.in_flight])
            self.handed += 1

    def close(self) -> None:
        self.deliveries.close()


def stamp_latency_us(device, trials: int = 64) -> list[float]:
    """What a stamp costs: the host time from recording an event on an
    idle stream to the waiter's stamp of it (us), `trials` times."""
    deliveries = Deliveries()
    try:
        out = []
        for i in range(trials):
            torch.cuda.synchronize(device)
            event = torch.cuda.Event()
            t0 = time.perf_counter()
            event.record()
            deliveries.submit(i, event)
            out.append((deliveries.wait(i) - t0) * 1e6)
        return out
    finally:
        deliveries.close()
