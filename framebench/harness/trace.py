"""The traced part of a ``--trace 1`` run, after the measured window: a
few graph frames under the profiler (device busy time, kernel times by
name, idle gaps), then a few eager frames of the same frame graph with the
benchmark's own span around each stage and a synchronize on either side
(device time by stage) and with the measured kernels' inputs counted
(their least bytes). Per-layer metrics read the ``Reading`` it returns.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from . import timing

STAGE_PREFIX = "framebench.stage."
WINDOW_NAME = "framebench.window"


@dataclasses.dataclass
class Reading:
    """What per-layer readers read. Times in seconds unless named."""
    device_name: str
    frames: int = 0                  # the measured window's frames
    window_s: float = 0.0
    host_step_ms: list = dataclasses.field(default_factory=list)
    spill_waves_per_frame: float | None = None
    peak_bytes: int = 0              # over the measured window
    graph_frames: int = 0            # traced graph frames
    trace_lo: float = 0.0            # traced window, profiler clock (us)
    trace_hi: float = 0.0
    kernels: list = dataclasses.field(default_factory=list)  # (name, s, e)
    host_ops: list = dataclasses.field(default_factory=list)  # (name, s, e)
    eager_frames: int = 0
    stage_ms: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)

    def kernel_seconds(self, pattern) -> float:
        return sum(e - s for n, s, e in self.kernels
                   if pattern.search(n)) * 1e-6

    @property
    def traced_window_s(self) -> float:
        return (self.trace_hi - self.trace_lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return timing.busy([(s, e) for _, s, e in self.kernels],
                           self.trace_lo, self.trace_hi) * 1e-6


def _events(prof):
    """(device operations, host ranges) as (name, start_us, end_us). The
    benchmark's own spans also show on the device's timeline; they are
    ranges, not operations, and are left out there."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        item = (e.name, float(tr.start), float(tr.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith("framebench."):
                dev.append(item)
        else:
            host.append(item)
    return dev, host


def graph_frames(step, frames: int, reading: Reading):
    """Profile `frames` calls of step() (graph frames)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_NAME):
            for _ in range(frames):
                step()
            torch.cuda.synchronize()
    dev, host = _events(prof)
    win = [h for h in host if h[0] == WINDOW_NAME]
    reading.trace_lo, reading.trace_hi = win[0][1], win[0][2]
    reading.kernels = [k for k in dev
                       if k[2] > reading.trace_lo and k[1] < reading.trace_hi]
    reading.host_ops = [h for h in host if h[0] != WINDOW_NAME]
    reading.graph_frames = frames


def _wrap(module_name, attr, bytes_fn, sink, key):
    mod = importlib.import_module(module_name)
    inner = getattr(mod, attr)

    def wrapped(*args, **kwargs):
        sink[key] = sink.get(key, 0) + bytes_fn(*args)
        return inner(*args, **kwargs)
    setattr(mod, attr, wrapped)
    return lambda: setattr(mod, attr, inner)


def eager_frames(render, frames: int, wraps, reading: Reading):
    """`frames` eager frames through render(run_hook): each stage between
    two synchronizes inside the benchmark's span; `wraps` = [(key, module,
    attribute, bytes_fn)] count each call's least bytes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def hook(name, fn, *args):
        torch.cuda.synchronize()
        with record_function(STAGE_PREFIX + name):
            out = fn(*args)
            torch.cuda.synchronize()
        return out

    sink = {}
    undo = [_wrap(m, a, f, sink, k) for k, m, a, f in wraps]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(frames):
                render(hook)
            torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    dev, host = _events(prof)
    stages = {}
    for name, s, e in host:
        if name.startswith(STAGE_PREFIX):
            stage = name[len(STAGE_PREFIX):]
            busy = sum(min(ke, e) - max(ks, s) for _, ks, ke in dev
                       if ks < e and ke > s)
            stages[stage] = stages.get(stage, 0.0) + busy * 1e-3
    reading.stage_ms = {k: v / frames for k, v in stages.items()}
    reading.eager_frames = frames
    reading.bytes = {k: float(v) for k, v in sink.items()}


def breakdown(reading: Reading, top: int = 10) -> dict:
    """The traced graph frames' device operations that took most time and
    the longest idle gaps, named by the host operation under each gap."""
    by_name = {}
    for n, s, e in reading.kernels:
        key = n[:120]
        by_name[key] = by_name.get(key, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gap_by = {}
    spans = [(s, e) for _, s, e in reading.kernels]
    for gs, ge in timing.gaps(spans, reading.trace_lo, reading.trace_hi):
        mid = 0.5 * (gs + ge)
        under = [h for h in reading.host_ops if h[1] <= mid <= h[2]]
        name = (min(under, key=lambda h: h[2] - h[1])[0][:120] if under
                else "host (no traced op)")
        gap_by[name] = gap_by.get(name, 0.0) + (ge - gs) * 1e-6
    gaps = sorted(gap_by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""
