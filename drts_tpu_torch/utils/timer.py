"""Frame timing: a fixed or variable timestep and the FPS counter (port of
``drts_tpu/utils/timer.py``).

The reference's StepTimer (StepTimer.ixx, QPC-based): a variable step by
default, an optional fixed step with catch-up, and the elapsed time
clamped after a stall, on the host (it drives the render loop; the
physics step clamps its own dt in ``ops/physics.py``).
"""

from __future__ import annotations

import time


class StepTimer:
    MAX_DELTA_SECONDS = 1.0  # StepTimer.ixx clamp after debugger stalls

    def __init__(self, fixed_timestep: float | None = None):
        self._last = time.perf_counter()
        self._fixed = fixed_timestep
        self._leftover = 0.0
        self.total_seconds = 0.0
        self.frame_count = 0
        self.frames_per_second = 0.0
        self._fps_frames = 0
        self._fps_accum = 0.0

    def tick(self, update) -> None:
        """Calls update(elapsed_seconds) once (variable step) or N times
        (fixed step catch-up), like StepTimer::Tick (StepTimer.ixx:92)."""
        now = time.perf_counter()
        elapsed = min(now - self._last, self.MAX_DELTA_SECONDS)
        self._last = now

        self._fps_accum += elapsed
        if self._fixed is None:
            self.total_seconds += elapsed
            self.frame_count += 1
            self._fps_frames += 1
            update(elapsed)
        else:
            self._leftover += elapsed
            while self._leftover >= self._fixed:
                self._leftover -= self._fixed
                self.total_seconds += self._fixed
                self.frame_count += 1
                self._fps_frames += 1
                update(self._fixed)

        if self._fps_accum >= 1.0:
            self.frames_per_second = self._fps_frames / self._fps_accum
            self._fps_frames = 0
            self._fps_accum = 0.0
