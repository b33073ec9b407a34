"""A run of a cell on several cards: the port's sharded graph frame
(``render_frame_graph()(state, pose, group=)``) over an NCCL group of one
rank per card, spawned here through the port's ``parallel.multihost``.

Every rank steps the same frames: the window's frame count is fixed
before it opens from rank 0's time of the last set-up frames (so that no
rank waits on a collective another never issues), and nothing
synchronises inside it. Rank 0 times the window, reads the per-layer
metrics from its trace (every rank traces its card for the device's busy
share), gathers the checked frames' bands and the replicated bodies of
every rank, runs the check and prints the result; the others print
nothing.
"""

from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from . import frames, main as main_mod, system, trace, traffic

ESTIMATE_FRAMES = 4


def main(cell, args, t_start: float) -> int:
    from drts_tpu_torch import backend
    from drts_tpu_torch.parallel import multihost
    backend.build()             # once, before the ranks load it
    multihost.spawn(rank_main, int(cell.config["ranks"]), device="cuda",
                    args=(cell, args.seed, args.seconds, bool(args.trace),
                          t_start))
    return 0


def _gather_rows(t, group):
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, 0)


def rank_main(group, cell, seed, seconds, traced, t_start, device=None):
    """One rank's run (``device``: "cpu" runs the pieces eagerly on a gloo
    group, for the tests)."""
    rank = dist.get_rank(group)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device is None else torch.device(device))
    on_card = dev.type == "cuda"
    mix = cell.traffic
    p = traffic.params(mix)
    pipe, host, _ = system.build(cell.config, dev)
    inputs = system.inputs(host, pipe.cfg, cell.config, p["dt"])
    state = pipe.init_state(host)
    box = {"state": state}
    call = pipe.render_frame_graph()

    def step(pose, prev, dt):
        box["state"], image = call(box["state"], pose, dt, prev_pose=prev,
                                   group=group)
        return image

    drv = frames.Driver(step, mix, system.camera_start(host), dev,
                        int(p["warm_frames"]) + ESTIMATE_FRAMES
                        + int(seconds * 1000) + main_mod.TRACED_FRAMES + 64)
    # One eager sharded frame first, its result dropped: the frame's cached
    # constants and halo index tensors exist before the capture.
    pipe.render_frame(pipe.shard_state(state, group), drv.pose(0),
                      prev_pose=drv.pose(0), group=group)
    for _ in range(int(p["warm_frames"])):
        drv.step()
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(ESTIMATE_FRAMES):
        drv.step()
    sync()
    per_frame = (time.perf_counter() - t0) / ESTIMATE_FRAMES
    count = torch.tensor([max(1, math.ceil(seconds / per_frame))],
                         dtype=torch.int64, device=dev)
    dist.broadcast(count, 0, group=group)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = time.perf_counter() - t_start
    if rank == 0:
        main_mod.note(f"set-up {setup_s:.2f} s; window of {int(count)} "
                      f"frames")

    def replicas(st):
        return {"replica_pos": st.bodies.position.clone()}
    keep = main_mod.keeper(drv, lambda: box["state"], replicas)
    win = frames.window(drv, seconds,
                        {main_mod.check_frame_at(seed, cell.check)}, keep,
                        call.stats, dev, count=int(count))
    reading = trace.Reading(
        device_name=torch.cuda.get_device_name(dev) if on_card else "cpu",
        frames=win.frames, window_s=win.window_s,
        host_step_ms=win.host_step_ms,
        spill_waves_per_frame=win.spill_waves, peak_bytes=win.peak_bytes)
    readers = main_mod.readers_of(cell) if traced else {}
    result_extra = {}
    device_times = None
    if traced and on_card:
        # Every rank traces its own card; the device's busy and traced
        # seconds are the ranks' mean, the rest rank 0's.
        trace.graph_frames(drv.step, main_mod.TRACED_FRAMES, reading)
        times = torch.tensor([reading.busy_s, reading.traced_window_s],
                             dtype=torch.float64, device=dev)
        dist.all_reduce(times, group=group)
        device_times = (times / dist.get_world_size(group)).tolist()
        if rank == 0:
            result_extra["breakdown"] = trace.breakdown(reading)
    sync()
    peak = torch.tensor([max(setup_peak, torch.cuda.max_memory_allocated())
                         if on_card else 0], dtype=torch.int64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)

    # The checked frames whole on rank 0: bands gathered in rank order,
    # each replicated body position against rank 0's.
    kept = []
    for f in win.kept:
        whole = {k: _gather_rows(f[k], group) for k in ("image", "hdr",
                                                        "depth")}
        pos = [torch.empty_like(f["replica_pos"])
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(pos, f["replica_pos"], group=group)
        gap = max(float((q - pos[0]).abs().max()) for q in pos)
        kept.append(dict(f, replica_gap=gap, **whole))
    card = trace.power_limit() if on_card and rank == 0 else ""
    del drv, call, box, state, pipe, host
    frames.free_cuda()
    if rank != 0:
        return
    main_mod.note(f"window {win.frames} frames in {win.window_s:.3f} s")
    from ..reference import compare
    t_check = time.perf_counter()
    checks, failed, each = compare.numbers(inputs, kept, cell.check, seed,
                                           dev)
    main_mod.note(f"check {time.perf_counter() - t_check:.2f} s")
    out = main_mod.result_of(cell, win, reading, readers, setup_s,
                             int(peak), checks, failed, traced, card,
                             main_mod.checked_frames(kept, each))
    if device_times is not None:
        out["device"]["busy_s"], out["device"]["window_s"] = device_times
    out.update(result_extra)
    out["checks"] = out.pop("checks")
    main_mod.emit(out)
