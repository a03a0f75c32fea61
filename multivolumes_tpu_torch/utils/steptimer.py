"""Frame clock: fixed/variable timestep with delta clamping.

Behavioral port of `Common/StepTimer.h` (the DirectX sample timer the
reference app ticks every frame, `MultiVolumes.cpp:320-322`): 10 MHz
canonical ticks, a one-second max-delta clamp (debugger pauses), fixed-
timestep accumulation with catch-up updates and the 1/4-ms NTSC-drift
snap, variable-timestep passthrough, and a once-per-second FPS counter
(the reference's F1 window-title stat, `MultiVolumes.cpp:766-812`).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

TICKS_PER_SECOND = 10_000_000


def ticks_to_seconds(ticks: int) -> float:
    return ticks / TICKS_PER_SECOND


def seconds_to_ticks(seconds: float) -> int:
    return int(seconds * TICKS_PER_SECOND)


class StepTimer:
    def __init__(self, now: Optional[Callable[[], float]] = None):
        # injectable clock for tests (seconds, monotonic)
        self._now = now or time.perf_counter
        self._last_time = self._now()
        self._max_delta_s = 1.0  # clamp excessively large deltas

        self.elapsed_ticks = 0
        self.total_ticks = 0
        self._left_over_ticks = 0
        self.frame_count = 0
        self.frames_per_second = 0
        self._frames_this_second = 0
        self._second_counter_s = 0.0

        self.is_fixed_time_step = False
        self.target_elapsed_ticks = TICKS_PER_SECOND // 60

    # --- accessors mirroring StepTimer.h:36-48 ---------------------------
    @property
    def elapsed_seconds(self) -> float:
        return ticks_to_seconds(self.elapsed_ticks)

    @property
    def total_seconds(self) -> float:
        return ticks_to_seconds(self.total_ticks)

    def set_fixed_time_step(self, fixed: bool) -> None:
        self.is_fixed_time_step = fixed

    def set_target_elapsed_seconds(self, seconds: float) -> None:
        self.target_elapsed_ticks = seconds_to_ticks(seconds)

    def reset_elapsed_time(self) -> None:
        """After a timing discontinuity (blocking IO): avoid fixed-step
        catch-up bursts (`StepTimer.h:68-76`)."""
        self._last_time = self._now()
        self._left_over_ticks = 0
        self.frames_per_second = 0
        self._frames_this_second = 0
        self._second_counter_s = 0.0

    def tick(self, update: Optional[Callable[[], None]] = None) -> None:
        """`StepTimer::Tick` (`StepTimer.h:80-160`)."""
        current = self._now()
        delta_s = current - self._last_time
        self._last_time = current
        self._second_counter_s += delta_s

        if delta_s > self._max_delta_s:
            delta_s = self._max_delta_s
        time_delta = int(delta_s * TICKS_PER_SECOND)

        last_frame_count = self.frame_count

        if self.is_fixed_time_step:
            # snap sub-1/4-ms deviations to the target (NTSC-drift guard)
            if abs(time_delta - self.target_elapsed_ticks) < \
                    TICKS_PER_SECOND // 4000:
                time_delta = self.target_elapsed_ticks

            self._left_over_ticks += time_delta
            while self._left_over_ticks >= self.target_elapsed_ticks:
                self.elapsed_ticks = self.target_elapsed_ticks
                self.total_ticks += self.target_elapsed_ticks
                self._left_over_ticks -= self.target_elapsed_ticks
                self.frame_count += 1
                if update:
                    update()
        else:
            self.elapsed_ticks = time_delta
            self.total_ticks += time_delta
            self._left_over_ticks = 0
            self.frame_count += 1
            if update:
                update()

        if self.frame_count != last_frame_count:
            self._frames_this_second += 1
        if self._second_counter_s >= 1.0:
            self.frames_per_second = self._frames_this_second
            self._frames_this_second = 0
            self._second_counter_s %= 1.0
