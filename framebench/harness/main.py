"""A run of one cell: ``run.py --workload W --seed S --seconds T --trace
0|1``. Prints one JSON line last on standard output and each compared
number beside its limit last on standard error."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import frames, spec, system, timing, trace, traffic

BANNED = ("jax", "jaxlib", "flax", "drts_tpu")
EAGER_FRAMES = 2       # a SHARC cadence cycle: one update, one skip frame
TRACED_FRAMES = 4


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the whole top-level name: the port's begins with it)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


def note(text: str) -> None:
    print(f"framebench: {text}", file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def check_frame_at(seed: int, check: dict) -> int:
    """The window frame, drawn from the seed, that the check keeps besides
    the window's last."""
    rng = np.random.default_rng(seed)
    return int(rng.integers(0, max(1, int(check["first_frames"]))))


def keeper(drv, get_state, extra=None):
    """keep(j): clones of what the check reads after window frame j."""
    def keep(j):
        st = get_state()
        i = drv.frame - 1
        out = {"window_frame": j, "frame_index": i, "steps": i + 1,
               "pose": drv.poses_host[i], "image": drv.last.clone(),
               "hdr": st.taa.history.clone(), "depth": st.prev_depth.clone(),
               "position": st.bodies.position.clone(),
               "rotation": st.bodies.rotation.clone()}
        if extra is not None:
            out.update(extra(st))
        return out
    return keep


def readers_of(cell):
    return {m["name"]: spec.metric_reader(m["name"]) for m in cell.per_layer}


def wraps_of(readers):
    return [(name,) + tuple(mod.WRAP) for name, mod in readers.items()
            if hasattr(mod, "WRAP")]


def run_one(cell, seed: int, seconds: float, traced: bool, t_start: float,
            device="cuda", control: bool = False) -> dict:
    """Set-up, warm frames, the window, the traced frames and the check of
    a one-card cell. Returns the result (its ``checks`` key last)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mix = cell.traffic
    p = traffic.params(mix)
    pipe, host, sess = system.build(cell.config, dev)
    inputs = system.inputs(host, pipe.cfg, cell.config, p["dt"])
    drv = frames.Driver(
        lambda pose, prev, dt: sess.step(pose, dt=dt, prev_pose=prev),
        mix, system.camera_start(host), dev,
        int(p["warm_frames"]) + int(seconds * 1000) + TRACED_FRAMES
        + EAGER_FRAMES + 64)
    for _ in range(int(p["warm_frames"])):
        drv.step()
    if on_card:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
    setup_s = time.perf_counter() - t_start
    note(f"set-up {setup_s:.2f} s")
    stats = sess._frame.stats if sess._frame is not None else None
    keep = keeper(drv, lambda: sess.state)
    win = frames.window(drv, seconds, {check_frame_at(seed, cell.check)},
                        keep, stats, dev)
    reading = trace.Reading(
        device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
        frames=win.frames, window_s=win.window_s,
        host_step_ms=win.host_step_ms,
        spill_waves_per_frame=win.spill_waves, peak_bytes=win.peak_bytes)
    result_extra = {}
    readers = readers_of(cell) if traced else {}
    if traced and on_card:
        trace.graph_frames(drv.step, TRACED_FRAMES, reading)

        def eager(hook):
            i = drv.frame
            sess.state, drv.last = sess.pipe.render_frame(
                sess.state, drv.pose(i), drv.dt, prev_pose=drv.pose(i - 1),
                dyn=sess.dyn, _run=hook)
            drv.frame += 1
        trace.eager_frames(eager, EAGER_FRAMES, wraps_of(readers), reading)
        result_extra["breakdown"] = trace.breakdown(reading)
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) \
        if on_card else 0
    card = trace.power_limit() if on_card else ""
    del drv, sess, pipe, host, stats
    frames.free_cuda()

    note(f"window {win.frames} frames in {win.window_s:.3f} s")
    t_check = time.perf_counter()
    kept = win.kept
    from ..reference import compare
    if control:
        kept = compare.control_outputs(inputs, kept, cell.check, seed, dev)
    checks, failed, each = compare.numbers(inputs, kept, cell.check, seed,
                                           dev)
    note(f"check {time.perf_counter() - t_check:.2f} s")
    out = result_of(cell, win, reading, readers, setup_s, peak, checks,
                    failed, traced, card, checked_frames(kept, each))
    out.update(result_extra)
    out["checks"] = out.pop("checks")
    return out


def checked_frames(kept, each) -> list:
    """Where each checked frame lies in the run, and its numbers."""
    return [{"window_frame": f["window_frame"], "frame": f["frame_index"],
             "camera": [round(float(x), 4) for x in f["pose"][0]],
             "numbers": got} for f, got in zip(kept, each)]


def window_summary(win) -> dict:
    """The window's frames, spill waves and the spread of its intervals."""
    iv = sorted(win.intervals_ms)
    return {"frames": win.frames, "seconds": win.window_s,
            "spill_waves_per_frame": win.spill_waves,
            "interval_ms_min_median_max": [iv[0], iv[len(iv) // 2], iv[-1]]}


def result_of(cell, win, reading, readers, setup_s, peak, checks, failed,
              traced, card, checked=()) -> dict:
    """The result line: the cell's end-to-end metrics (or, traced, its
    per-layer metrics that found something to read), the device, and the
    compared numbers under ``checks``."""
    on_card = reading.device_name != "cpu"
    metrics = {}
    if traced:
        for name, mod in readers.items() if on_card else ():
            value = mod.read(reading)
            if value is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": float(value), "unit": unit}
    else:
        values = {"frame_ms": timing.frame_ms(win.window_s, win.frames),
                  "frame_ms_p95": timing.percentile(win.intervals_ms, 95),
                  "setup_s": setup_s}
        # A metric split by kind of cell ("frame_ms.bands4") is the quantity
        # its name starts with.
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": float(values[m["name"].split(".")[0]]),
                "unit": m["unit"]}
    device_out = {"platform": "gpu" if on_card else "cpu",
                  "kind": reading.device_name, "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    if traced and on_card:
        device_out["busy_s"] = reading.busy_s
        device_out["window_s"] = reading.traced_window_s
    return {"correct": failed == 0, "attempted": win.frames,
            "failed": int(failed), "metrics": metrics, "device": device_out,
            "card": card, "window": window_summary(win),
            "checked_frames": list(checked),
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}


def _finite(x):
    """JSON has no infinity: a reading that is none is the largest float."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not np.isfinite(x):
        return float(np.finfo(np.float64).max)
    return x


def emit(result: dict) -> None:
    """Print the compared numbers last on standard error and the result
    line last on standard output, unless JAX or the JAX package has been
    loaded into this process by then: that ends the run with no result."""
    bad = banned_modules()
    if bad:
        raise SystemExit(f"framebench: modules of JAX or the JAX package "
                         f"loaded, no result: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(result)), flush=True)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); PyTorch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if int(cell.config.get("ranks", 1)) > 1:
        from . import bands
        return bands.main(cell, args, t_start)
    emit(run_one(cell, args.seed, args.seconds, bool(args.trace), t_start))
    return 0
