"""One run of a cell on one card or one rank: set-up, warm frames, the
measured window, the traced frames, and what the check keeps.

The window is a closed loop with one frame in flight: a frame is
submitted as soon as the previous step returns; a CUDA event is recorded
on the stream after each step; nothing synchronises inside the window.
Frames run until ``seconds`` have passed on the host clock since the
window opened; then one synchronize closes it.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from . import timing, traffic


@dataclasses.dataclass
class Window:
    frames: int
    window_s: float
    intervals_ms: list
    host_step_ms: list
    spill_waves: float | None
    peak_bytes: int
    kept: list


class Driver:
    """Steps the system under test frame by frame along the traffic."""

    def __init__(self, step, mix: dict, camera: dict, device,
                 max_frames: int):
        from drts_tpu_torch.models import pipeline
        self._step = step          # step(pose, prev_pose, dt) -> image
        self.dt = float(traffic.params(mix)["dt"])
        poses = np.stack([np.stack(traffic.pose(mix, camera, i))
                          for i in range(max_frames)])
        self._poses = torch.from_numpy(poses).to(device)
        self._up = torch.tensor((0.0, 1.0, 0.0), device=device)
        self._mk = pipeline.CameraPose
        self.frame = 0             # frames submitted so far
        self.last = None           # the last frame's image
        self.poses_host = poses

    def pose(self, i):
        return self._mk(position=self._poses[i, 0], forward=self._poses[i, 1],
                        up=self._up)

    def step(self):
        i = self.frame
        self.last = self._step(self.pose(i), self.pose(max(i - 1, 0)),
                               self.dt)
        self.frame += 1
        return self.last


def window(drv: Driver, seconds: float, keep_at: set, keep, stats=None,
           device=None, count: int | None = None) -> Window:
    """Frames for `seconds` from now (or `count` frames: ranks that must
    step together); after window frame j in `keep_at`, and after the last,
    ``keep(j)`` clones what the check reads (enqueued on the stream, no
    synchronize)."""
    on_card = torch.device(device).type == "cuda"
    spills0 = stats.spill_waves if stats is not None else None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ends, host_ms, kept = [], [], []
    start_ev = torch.cuda.Event(enable_timing=True) if on_card else None
    t0 = time.perf_counter()
    if on_card:
        start_ev.record()
    j = 0
    while True:
        h0 = time.perf_counter()
        drv.step()
        h1 = time.perf_counter()
        host_ms.append((h1 - h0) * 1e3)
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        else:
            ends.append(h1)
        if j in keep_at:
            kept.append(keep(j))
        j += 1
        if (j >= count) if count is not None else (h1 - t0 >= seconds):
            break
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    if (j - 1) not in keep_at:
        kept.append(keep(j - 1))
    if on_card:
        stamps = [0.0] + [start_ev.elapsed_time(e) for e in ends]
        peak = torch.cuda.max_memory_allocated()
    else:
        stamps = [0.0] + [(e - t0) * 1e3 for e in ends]
        peak = 0
    spills = None
    if stats is not None:
        spills = (stats.spill_waves - spills0) / j
    return Window(frames=j, window_s=t1 - t0,
                  intervals_ms=timing.intervals_ms(stamps),
                  host_step_ms=host_ms, spill_waves=spills, peak_bytes=peak,
                  kept=kept)


def free_cuda():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
