"""Observability: scoped pass tracing, per-frame metrics and a device
trace (port of ``drts_tpu/utils/obs.py``).

The reference's instrumentation (PIX scoped events, App.cpp:598; the
Streamline latency markers and OutputDebugString logging) becomes
``torch.profiler.record_function`` labels with a host-time debug log, a
per-frame metric dict written as JSON lines, and ``device_trace``: a
``torch.profiler`` capture of a code region, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import torch

logger = logging.getLogger("drts_tpu_torch")


def synchronize(device) -> None:
    """Wait for the device's queued work (a no-op off the card)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def pass_scope(name: str):
    """ScopedPixEvent analogue: labels the region in profiler timelines
    and logs its host wall time at debug level."""
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    logger.debug("pass %s: %.2f ms host", name,
                 (time.perf_counter() - start) * 1e3)


class FrameMetrics:
    """Per-frame metric accumulator (ms per frame, counters) with JSON-lines
    output, the structured form of the reference's debug overlay stats.
    On a card, ``frame`` synchronizes the device before it reads the clock
    at either end, so ``frame_ms`` is the frame's work and not the time
    to enqueue it."""

    def __init__(self, device=None):
        self.frames = []
        self.device = device

    @contextlib.contextmanager
    def frame(self):
        record = {}
        synchronize(self.device)
        start = time.perf_counter()
        yield record
        synchronize(self.device)
        record["frame_ms"] = (time.perf_counter() - start) * 1e3
        self.frames.append(record)

    def summary(self) -> dict:
        if not self.frames:
            return {}
        keys = {k for f in self.frames for k in f}
        return {k: sum(f.get(k, 0.0) for f in self.frames) / len(self.frames)
                for k in keys}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for record in self.frames:
                f.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile a code region over CPU activity and, where a card is
    present, CUDA activity; writes ``<log_dir>/trace.json`` (Chrome trace
    format) and yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
