"""Frame timer — behavioral port of the reference's StepTimer.

Reference: DXRVoxelizer/Common/StepTimer.h:15-183 (QPC-based variable/fixed
timestep, FPS counter, 1-second frame-stats cadence used by
CalculateFrameStats, DXRVoxelizer.cpp:553-584). Both timestep modes are
ported; the app uses the variable default (the reference app never enables
fixed timestep either, but the framework surface carries it).
"""

from __future__ import annotations

import time


class StepTimer:
    TICKS_PER_SECOND = 10_000_000  # StepTimer.h:63

    def __init__(self):
        self._last = time.perf_counter()
        self._elapsed = 0.0
        self._total = 0.0
        self.frame_count = 0
        self._fps_frames = 0
        self._fps_time = 0.0
        self.frames_per_second = 0.0
        # clamp huge gaps (e.g. paused in a debugger), StepTimer.h:130-133
        self.max_delta_seconds = 1.0
        # fixed-timestep mode (StepTimer.h:104-133): tick() runs the update
        # callback once per elapsed target interval, accumulating leftover
        # time, so simulation steps stay uniform under jittery frame times
        self.is_fixed_time_step = False
        self.target_elapsed_seconds = 1.0 / 60.0
        self._leftover = 0.0

    def reset_elapsed_time(self):
        """ResetElapsedTime (StepTimer.h:67-75): call after an intentional
        discontinuity so fixed timestep doesn't run catch-up updates."""
        self._last = time.perf_counter()
        self._leftover = 0.0
        self._fps_frames = 0
        self._fps_time = 0.0
        self.frames_per_second = 0.0

    def tick(self, update=None):
        """Advance the clock; in fixed mode run ``update`` once per whole
        target interval elapsed (catch-up semantics, StepTimer.h:104-133),
        in variable mode once per call."""
        now = time.perf_counter()
        delta = min(now - self._last, self.max_delta_seconds)
        self._last = now
        last_frame_count = self.frame_count

        if self.is_fixed_time_step:
            # snap deltas within 1/4 ms of the target to exactly the target
            # so tiny clock jitter never accumulates into a dropped frame
            # (StepTimer.h:110-118)
            if abs(delta - self.target_elapsed_seconds) < 1.0 / 4000.0:
                delta = self.target_elapsed_seconds
            self._fps_time += delta
            self._leftover += delta
            while self._leftover >= self.target_elapsed_seconds:
                self._elapsed = self.target_elapsed_seconds
                self._total += self.target_elapsed_seconds
                self._leftover -= self.target_elapsed_seconds
                self.frame_count += 1
                if update is not None:
                    update()
        else:
            self._elapsed = delta
            self._total += delta
            self._leftover = 0.0
            self.frame_count += 1
            self._fps_time += delta
            if update is not None:
                update()

        if self.frame_count != last_frame_count:
            self._fps_frames += self.frame_count - last_frame_count
        if self._fps_time >= 1.0:  # 1 Hz stats (StepTimer.h:154-160)
            self.frames_per_second = self._fps_frames / self._fps_time
            self._fps_frames = 0
            self._fps_time = 0.0

    @property
    def elapsed_seconds(self) -> float:
        return self._elapsed

    @property
    def total_seconds(self) -> float:
        return self._total
