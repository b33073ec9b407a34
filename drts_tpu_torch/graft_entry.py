"""Entry points of the port (port of ``__graft_entry__.py``): one
frame step, the multi-device dry run and the sharded frame's scaling run.

- ``entry()``: (fn, example args) of one frame step of the flagship
  pipeline at 256x256, 4 bounces, on the card.
- ``dryrun_multichip(n)``: the reference's recipe (64x64 below 8 devices,
  ``max(128, 8n)`` from 8; 2 bounces, ``compact_from=1``, SHARC 2^16,
  ReSTIR 8 cells) rendered sharded over n ranks (one frame: every leaf
  of the new state shaped as ``RenderPipeline.placement`` says, the
  replicated ones the same on every rank, the gathered image finite),
  then the banded ``trace_image`` over the instanced-geosphere scene;
  both as graph frames (``render_frame_graph()(..., group=)``,
  ``trace_image_graph(cfg, rows=band)`` with the gather outside), as the
  reference jits both, or eagerly with ``graph=False``. Under an existing
  process group it runs on that group's first n ranks; otherwise it
  spawns n ranks (NCCL, one card each, on ``cuda``; gloo on ``cpu``).
- ``python -m drts_tpu_torch.graft_entry``, alone or under torchrun::

      torchrun --nproc_per_node 4 -m drts_tpu_torch.graft_entry \\
          --default-frame [--width 1920 --height 1080] [--frames 5] [--eager]

  renders the frame (``PipelineConfig()`` at the size given with
  ``--default-frame``, else ``entry``'s recipe) unsharded on rank 0
  (``group=None``, reported as rank count 0), then sharded over the first
  1, 2, 4, ... ranks and all of them; at each rank count as graph frames
  and then eagerly, each from the same start state: the warm frame (the
  graph's capture), then ``--frames - 1`` timed frames (a synchronize and
  a barrier around each, timed by CUDA events), and after the eager ones
  one SHARC cadence timed stage by stage (the ranks aligned by a barrier
  before each stage). Then one SHARC cadence from the graph run's state,
  each frame through the graph callable and eagerly from the same input
  state. Rank 0 holds every gathered image to the unsharded one (the
  bounds of ``DEFAULT_*``), each graph frame to the eager frame bit for
  bit (image and state) on a SHARC skip frame and within ``DEFAULT_*``
  plus two eager frames' own difference on an update frame (the splat's
  float atomics add in another order); every run's replicated leaves
  must agree and no leaf may be off its placement. It prints one JSON
  line: per form and rank count the frame ms (mean, median, range, each)
  and per rank its stage times, launches, spill waves a frame, the
  graph's capture seconds and host launches a frame, the bytes of its
  ``FrameState`` between frames and its peak device memory; a failed
  check exits non-zero. ``--eager`` runs the eager frames alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from . import backend, bench, graphs
from .models import myscene, pipeline
from .ops import camera as camera_mod, pathtrace, restir, sharc
from .parallel import mesh as mesh_mod, multihost
from .utils import checkpoint

# The bounds of chip_smoke.py's DEFAULT_* (a frame of another rank count,
# or another order of the SHARC splat's float additions, against this one):
# mean |image difference|, and the share of pixels off by more than
# DEFAULT_OFF.
DEFAULT_MEAN = 2e-4
DEFAULT_OFF = 0.05
DEFAULT_OFF_SHARE = 2e-3


def _config(width, height, bounces, spp, denoiser="NRDReBLUR",
            out_scale=1, compact_from=2) -> pipeline.PipelineConfig:
    return pipeline.PipelineConfig(
        output_width=width * out_scale, output_height=height * out_scale,
        render_width=width, render_height=height,
        bounces=bounces, samples_per_pixel=spp, denoiser=denoiser,
        upscaling=out_scale != 1, block_size=4096,
        compact_from=compact_from,
        sharc=sharc.SHARCConfig(capacity_log2=16),
        restir=restir.ReSTIRConfig(regir_cells_per_axis=8,
                                   regir_build_samples=4,
                                   local_light_samples=4))


def _setup(cfg, device, oscillator_grid=10, pose=None):
    """(pipeline, start state, camera pose) of `cfg` on the demo scene;
    `pose` is (position, forward, up) or the scene's camera."""
    pipe = pipeline.RenderPipeline(cfg, device)
    host = myscene.build(oscillator_grid=oscillator_grid, device=pipe.device)
    state = pipe.init_state(host)
    if pose is None:
        return pipe, state, pipe.default_camera_pose(host)
    return pipe, state, pipeline.CameraPose(*(
        torch.tensor(v, dtype=torch.float32, device=pipe.device)
        for v in pose))


def entry(device="cuda"):
    """(fn, example_args): one frame step of the flagship pipeline
    (physics + G-buffer + path trace + denoise + post) at 256x256;
    ``fn(state, pose, group=None)`` returns the image (with a group, the
    whole image, gathered from the ranks' bands)."""
    pipe, state, pose = _setup(_config(256, 256, bounces=4, spp=1), device)

    def fn(state, pose, group=None):
        _, image = pipe.render_frame(state, pose, 1.0 / 60.0, group=group)
        if group is not None:
            image = mesh_mod.gather_rows(image, group, pipe.cfg.output_height)
        return image

    return fn, (state, pose)


def _dryrun(group, n_devices, device, graph=True):
    dev = multihost.rank_device(device)
    height = width = max(128, 8 * n_devices) if n_devices >= 8 else 64
    pipe, state, pose = _setup(_config(width, height, bounces=2, spp=1,
                                       compact_from=1), dev)
    render = pipe.render_frame_graph() if graph else pipe.render_frame
    new_state, image = render(state, pose, 1.0 / 60.0, group=group)
    image = mesh_mod.gather_rows(image, group, pipe.cfg.output_height)
    assert image.shape == (pipe.cfg.output_height, pipe.cfg.output_width,
                           3)
    assert bool(torch.isfinite(image).all())
    bad = misplaced(pipe, state, new_state, group)
    assert not bad, f"leaves off their placement: {bad}"
    differ = mesh_mod.replicas_differ(replicated_checksums(pipe, new_state,
                                                           group))
    assert not differ, f"the ranks' replicated leaves differ at {differ}"

    # The mesh path under the same bands: one banded trace over the
    # instanced-geosphere scene (one shared BLAS and an instance table,
    # the same on every rank), its rows gathered.
    mh = myscene.as_mesh_scene(myscene.build(oscillator_grid=4, device=dev),
                               tessellation=2)
    mw = mh_h = max(64, 8 * n_devices) if n_devices >= 8 else 32
    mcfg = pathtrace.PathTraceConfig(width=mw, height=mh_h, bounces=2,
                                     samples_per_pixel=1, block_size=4096,
                                     compact_from=2)
    mimg = banded_trace(group, mh, mcfg, graph=graph)
    assert mimg.shape == (mh_h, mw, 3)
    assert bool(torch.isfinite(mimg).all())


def replicated_checksums(pipe, state, group):
    """``mesh.replica_checksums`` over the leaves the placement
    replicates."""
    placed = pipe.placement(state, dist.get_world_size(group))
    return mesh_mod.replica_checksums(
        state, group, {p for p, k in placed.items()
                       if k == mesh_mod.REPLICATED})


def misplaced(pipe, state0, state, group):
    """The paths of `state` (a rank's shards after a sharded frame) whose
    first axis is not what the placement of the one-device `state0` says:
    the rank's band or slot range for "rows" and "slots", the one-device
    size for "replicated"."""
    r, n = mesh_mod.group_rank(group)
    placed = pipe.placement(state0, n)
    full = dict(checkpoint.leaves(state0))
    bad = []
    for path, leaf in checkpoint.leaves(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        want = tuple(full[path].shape)
        if placed[path] != mesh_mod.REPLICATED:
            s, e = mesh_mod.row_band(want[0], r, n)
            want = (e - s,) + want[1:]
        if tuple(leaf.shape) != want:
            bad.append((path, tuple(leaf.shape), want))
    return bad


def banded_trace(group, host, cfg, frame_index=0, graph=False):
    """``trace_image`` of `host`'s scene from its camera (90 degrees
    horizontal, aspect width / height), this rank's band traced and the
    radiance gathered: the full (height, width, 3) frame on every rank.
    With `graph`, the band is traced by ``trace_image_graph(cfg,
    rows=band)`` (CUDA graphs on the card) and gathered outside it."""
    dev = host.scene.center.device
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 aspect=cfg.width / cfg.height, device=dev)
    rows = mesh_mod.group_band(cfg.height, group)
    if graph:
        out = pathtrace.trace_image_graph(cfg, rows=rows)(host.scene, cam,
                                                          frame_index)
    else:
        out = pathtrace.trace_image(host.scene, cam, cfg, frame_index,
                                    rows=rows)
    return mesh_mod.gather_rows(out.radiance, group, cfg.height)


def trace_worker(group, cfg, oscillator_grid, out_dir, device="cuda"):
    """A rank of ``multihost.spawn`` (the tests' spawned ranks):
    ``banded_trace`` of the demo scene (`oscillator_grid`) at frame 0;
    rank 0 saves the radiance to ``out_dir/trace.pt``."""
    dev = multihost.rank_device(device)
    host = myscene.build(oscillator_grid=oscillator_grid, device=dev)
    radiance = banded_trace(group, host, cfg)
    if dist.get_rank(group) == 0:
        torch.save(radiance.cpu(), os.path.join(out_dir, "trace.pt"))


def dryrun_multichip(n_devices: int, device="cuda", graph=True) -> None:
    """The full frame step sharded over n ranks, one step, then the banded
    mesh trace (see the module docstring), as graph frames (``graph``,
    the default) or eager. Under a started process group, every rank of it
    calls this; otherwise it spawns the n ranks."""
    if dist.is_initialized():
        group = mesh_mod.make_group(n_devices)
        if mesh_mod.is_member(group):
            _dryrun(group, n_devices, device, graph)
        return
    multihost.spawn(_dryrun, n_devices, device,
                    args=(n_devices, device, graph))


def frames_worker(group, cfgs, frames, out_dir, oscillator_grid=10,
                  pose=None, device="cuda", spill_capacity=0):
    """A rank of ``multihost.spawn`` (the tests' spawned ranks): for each
    config of `cfgs`, `frames` frames sharded over `group` from the demo
    scene's start state (cut by ``RenderPipeline.shard_state``), then the
    same frames through ``render_frame_graph()`` (``_graph_frames``;
    None where ``graph_refusal`` refuses the group: gloo on the card);
    then, per config, this rank's image bands, final shards (on the CPU),
    the leaves off their placement (``misplaced``), the checksums of the
    replicated leaves (over the group), the gathered final state, render
    band (the global group's ``process_local_rows``), kernel launches and
    the graph frames' results, saved as a list with torch.save to
    ``out_dir/rank<r>.pt``. With `spill_capacity`, one more eager and one
    graph frame of the first config at that deep-segment capacity (a
    frame that spills) go to ``out_dir/spill<r>.pt``."""
    dev = multihost.rank_device(device)
    runs = []
    for cfg in cfgs:
        pipe, state0, pose_ = _setup(cfg, dev, oscillator_grid, pose)
        backend.reset_launches()
        state = pipe.shard_state(state0, group)
        images = []
        for _ in range(frames):
            state, image = pipe.render_frame(state, pose_, group=group)
            images.append(image.cpu())
        runs.append({
            "images": images,
            "state": mesh_mod.map_tensors(lambda t: t.cpu(), state),
            "misplaced": misplaced(pipe, state0, state, group),
            "checksums": replicated_checksums(pipe, state, group),
            "gathered": mesh_mod.map_tensors(
                lambda t: t.cpu(), pipe.gather_state(state, group)),
            "launches": dict(backend.LAUNCHES),
            "band": multihost.process_local_rows(cfg.render_height),
            "graph": (_graph_frames(pipe, state0, pose_, group, frames)
                      if pipeline.graph_refusal(group, dev) is None
                      else None)})
    r = dist.get_rank(group)
    torch.save(runs, os.path.join(out_dir, f"rank{r}.pt"))
    if spill_capacity:
        pipe, state0, pose_ = _setup(cfgs[0], dev, oscillator_grid, pose)
        base = pipe._pt_cfg
        pipe._pt_cfg = lambda: dataclasses.replace(
            base(), compact_capacity=spill_capacity)
        waves = []

        def count(name, fn, *args):
            out = fn(*args)
            if name == "trace":
                waves.append(out.spill_waves)
            return out
        state = pipe.shard_state(state0, group)
        _, image = pipe.render_frame(state, pose_, group=group, _run=count)
        got = _graph_frames(pipe, state0, pose_, group, 1)
        torch.save({"eager_image": image.cpu(), "eager_waves": waves,
                    "graph": got}, os.path.join(out_dir, f"spill{r}.pt"))


def _graph_frames(pipe, state, pose, group, frames):
    """`frames` frames of ``pipe.render_frame_graph()`` sharded over
    `group` from the one-device `state`, each piece under an
    ``graphs.OpLog`` of the host ops a capture cannot hold and each spill
    wave under one of the collectives. Returns {"images", "state" (on the
    CPU), "host_ops", "spill_collectives", "spill_waves", "refusal" (what
    ``graph_refusal`` says of this group on the card), "other_group"
    (the error of a call without the group)}. One eager frame with the
    callable's inputs (the pose as the previous pose) comes first, as the
    capture's warm-up frame does, so that the cached constants exist."""
    pipe.render_frame(pipe.shard_state(state, group), pose, prev_pose=pose,
                      group=group)
    host, spill = [], []
    old = graphs.PIECE_MODE, graphs.SPILL_MODE
    graphs.PIECE_MODE = functools.partial(graphs.OpLog, host,
                                          graphs.HOST_OPS)
    graphs.SPILL_MODE = functools.partial(graphs.OpLog, spill,
                                          graphs.COLLECTIVE_OPS)
    call = pipe.render_frame_graph()
    images = []
    try:
        for _ in range(frames):
            state, image = call(state, pose, group=group)
            images.append(image.cpu())
    finally:
        graphs.PIECE_MODE, graphs.SPILL_MODE = old
    try:
        call(state, pose)
        other = None
    except ValueError as exc:
        other = str(exc)
    return {"images": images,
            "state": mesh_mod.map_tensors(lambda t: t.cpu(), state),
            "host_ops": host, "spill_collectives": spill,
            "spill_waves": call.stats.spill_waves,
            "refusal": pipeline.graph_refusal(group, torch.device("cuda")),
            "other_group": other}


# The row shifts and roll offsets exchange_worker checks (rows of halo).
EXCHANGE_SHIFTS = (-5, -2, -1, 1, 3, 5)


def exchange_worker(group, height, width, out_dir, device="cuda"):
    """A rank of ``multihost.spawn`` (the tests' spawned ranks): the
    sharded frame's exchanges on this rank's ``row_band`` of seeded data,
    the same on every rank. Saves to ``out_dir/rank<r>.pt``: the band's
    rows of ``post._shift`` (an (H, W, 3) image) and
    ``denoise._shift_chw`` (a (3, H, W) stack) by each of
    EXCHANGE_SHIFTS rows and one column, computed on the band and a
    clamped halo of |shift| rows; the band's rows of ``torch.roll`` by
    each shift, from a cyclic halo; this rank's rows of the sum and the
    max over the ranks of each rank's (H, 4) and (H,) int64 data in
    both reduce-scatter forms; and the whole image gathered back."""
    from .ops import denoise, post
    dev = multihost.rank_device(device)
    r, n = mesh_mod.group_rank(group)
    band = mesh_mod.Band.of(group, height)
    gen = torch.Generator().manual_seed(height * 1000 + width)
    img = torch.randn((height, width, 3), generator=gen).to(dev)
    mine = img[band.start:band.end]
    chw = img.permute(2, 0, 1)[:, band.start:band.end]
    out = {"band": band.span(), "shift": {}, "shift_chw": {}, "roll": {},
           "reduce_scatter": {}}
    for dy in EXCHANGE_SHIFTS:
        k = abs(dy)
        ext = band.halo([mine], k, k)[0]
        out["shift"][dy] = band.inner(post._shift(ext, dy, 1), k).cpu()
        ext_chw = band.halo([chw.permute(1, 2, 0)], k, k)[0]
        out["shift_chw"][dy] = band.inner(
            denoise._shift_chw(ext_chw.permute(2, 0, 1), dy, 1)
            .permute(1, 2, 0), k).cpu()
        lo, hi = max(0, -dy), max(0, dy)
        ring = band.halo([mine], lo, hi, cyclic=True)[0]
        out["roll"][dy] = torch.roll(ring[lo + dy:lo + dy + band.rows],
                                     shifts=-1, dims=1).cpu()
    local = torch.Generator().manual_seed(7 + r)
    sums = torch.randn((height, 4), generator=local).to(dev)
    words = torch.randint(0, 1 << 40, (height,), generator=local).to(dev)
    for form in mesh_mod.REDUCE_SCATTER_FORMS:
        out["reduce_scatter"][form] = (
            band.reduce_scatter(sums, form=form).cpu(),
            band.reduce_scatter(words, op=dist.ReduceOp.MAX,
                                form=form).cpu())
    out["gathered"] = band.gather(mine).cpu()
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def _sync(dev, group):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        dist.barrier(group)


def _frame_ms(dev, group, render):
    """render() between a synchronize and a barrier on each side: its ms
    from CUDA events on the card (the host's clock on the CPU)."""
    _sync(dev, group)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = render()
        _sync(dev, group)
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = render()
    end.record()
    _sync(dev, group)
    return out, start.elapsed_time(end)


def _scaling_run(cfg, frames, group, dev, graph=True, stages=True):
    """The warm frame, `frames` - 1 timed frames and (with `stages`) one
    SHARC cadence timed stage by stage of `cfg` on the demo scene, sharded
    over `group` (None: one device) from a start state of its own, which a
    rank holds only as its shards; the warm and timed frames as graph
    replays (``render_frame_graph``) with `graph`, else eager; the stage
    timing always eager (the ranks aligned by a barrier before each
    stage), from the timed frames' state. Returns a dict: the timed
    frames' ms each, the last timed image gathered whole, the pipeline,
    its pose, the graph callable (None eager), the start state's leaves as
    meta tensors, the last state (this rank's shards; a graph frame's
    state lives until the callable's call after next) and this rank's
    stats: stage ms, launches (eager frames) and spill waves of its own
    band per timed frame, the graph's capture seconds and host launches a
    frame, the bytes of its state between frames and its peak device
    memory over the run."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    pipe, state, pose = _setup(cfg, dev)
    like = mesh_mod.map_tensors(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    if group is not None:
        state = pipe.shard_state(state, group)
    call = pipe.render_frame_graph() if graph else None
    spills = []

    def count_spills(name, fn, *args):
        out = fn(*args)
        if name == "trace":
            spills.append(out.spill_waves)
        return out

    def render(state):
        if call is not None:
            return call(state, pose, group=group)
        return pipe.render_frame(state, pose, group=group,
                                 _run=count_spills)
    state, image = render(state)
    _sync(dev, group)
    backend.reset_launches()
    spills.clear()
    waves0 = call.stats.spill_waves if call is not None else 0
    timed = max(frames - 1, 1)
    each = []
    for _ in range(timed):
        (state, image), ms = _frame_ms(dev, group, lambda: render(state))
        each.append(ms)
    if call is not None:
        spills = [call.stats.spill_waves - waves0]
    stats = {"launches_per_frame": {k: v / timed for k, v in
                                    backend.LAUNCHES.items() if v},
             "spill_waves_per_frame": sum(spills) / timed}
    if call is not None:
        stats["capture_s"] = call.stats.capture_s
        stats["host_launches_per_frame"] = call.stats.last_host_launches
        stats["graph_launches_per_frame"] = {
            k: v / call.stats.frames for k, v in call.stats.launches.items()}
    if group is not None:
        image = mesh_mod.gather_rows(image, group, pipe.cfg.output_height)
    image = image.cpu()
    staged = max(pipe.cfg.sharc_update_period, 1) if stages else 0
    passes = {}
    for _ in range(staged):
        frame = {}
        timer = bench.stage_timer(frame, dev)

        def aligned(name, fn, *args):
            # The ranks start each stage together (a synchronize and a
            # barrier outside the timed span), so a stage's time holds its
            # own work and exchanges, not the wait for a rank still in an
            # earlier stage.
            _sync(dev, group)
            return timer(name, fn, *args)
        state, _ = pipe.render_frame(state, pose, group=group, _run=aligned)
        for name, ms in frame.items():
            passes[name] = passes.get(name, 0.0) + ms / staged
    _sync(dev, group)
    stats["passes_ms"] = passes
    stats["state_bytes"] = mesh_mod.state_bytes(state)
    stats["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None)
    return {"ms": each, "image": image, "pipe": pipe, "pose": pose,
            "call": call, "like": like, "state": state, "stats": stats}


def _image_diff(a, b):
    """(mean |a - b|, share of pixels off by more than DEFAULT_OFF)."""
    d = (a - b).abs()
    return float(d.mean()), float((d.amax(-1) > DEFAULT_OFF).float().mean())


def _graph_vs_eager(run, group, dev):
    """One SHARC cadence of frames from `run`'s last state (a graph run's):
    each frame through its graph callable and eagerly from the same input
    state (twice eagerly on a SHARC update frame, for the eager frame's own
    spread), the graph's state carried on. Returns per frame (SHARC update,
    image bit for bit, state bit for bit, mean |graph - eager|, share off,
    eager's own mean, share off), the images gathered whole."""
    pipe, call, pose = run["pipe"], run["call"], run["pose"]
    period = max(pipe.cfg.sharc_update_period, 1)
    state = graphs.clone_tree(run["state"])
    out = []

    def whole(img):
        if group is not None:
            img = mesh_mod.gather_rows(img, group, pipe.cfg.output_height)
        return img.cpu()
    for _ in range(period):
        update = pipe.cfg.sharc_enabled and state.frame_count % period == 0
        s_e, img_e = pipe.render_frame(state, pose, group=group)
        img_e = whole(img_e)
        spread = (0.0, 0.0)
        if update:
            spread = _image_diff(whole(pipe.render_frame(
                state, pose, group=group)[1]), img_e)
        s_g, img_g = call(state, pose, group=group)
        img_g = whole(img_g)
        same = (mesh_mod.replica_checksums(s_g)
                == mesh_mod.replica_checksums(s_e))
        out.append((update, bool(torch.equal(img_g, img_e)), same,
                    *_image_diff(img_g, img_e), *spread))
        state = graphs.clone_tree(s_g)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--default-frame", action="store_true",
                        help="PipelineConfig() (at --width x --height) "
                             "instead of entry()'s 256x256 recipe")
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--height", type=int, default=None)
    parser.add_argument("--frames", type=int, default=5,
                        help="frames per rank count: one warm, the rest "
                             "timed")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--eager", action="store_true",
                        help="eager frames alone (no graph frames)")
    args = parser.parse_args(argv)

    started = multihost.initialize(device=args.device)
    world = dist.get_world_size() if started else 1
    rank = dist.get_rank() if started else 0
    dev = multihost.rank_device(args.device)
    if args.default_frame:
        w, h = args.width or 1920, args.height or 1080
        cfg = pipeline.PipelineConfig(output_width=w, output_height=h,
                                      render_width=w, render_height=h)
    else:
        w, h = args.width or 256, args.height or 256
        cfg = _config(w, h, bounces=4, spp=1)

    # Rank count 0 is the unsharded frame (group=None), on rank 0 alone.
    counts = [0] + (sorted({k for k in (1, 2, 4, 8, 16, 32) if k <= world}
                           | {world}) if started else [])
    forms = ("eager",) if args.eager else ("graph", "eager")
    report = {"world": world, "config": f"{w}x{h}"
              + (" PipelineConfig()" if args.default_frame else " entry"),
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "forms": list(forms)}
    for name in ("frame_ms", "frame_ms_median", "frame_ms_range",
                 "frame_ms_each", "counters", "replicas_equal", "misplaced",
                 "ranks", "graph_vs_eager"):
        report[name] = {form: {} for form in forms} if name.startswith(
            "frame_ms") or name == "ranks" else {}
    images = {}
    for k in counts:
        group = mesh_mod.make_group(k) if k else None
        if not (mesh_mod.is_member(group) if k else rank == 0):
            continue
        for form in forms:
            # The stage timing is eager in either form: once, with the
            # eager frames.
            run = _scaling_run(cfg, args.frames, group, dev,
                               graph=form == "graph",
                               stages=form == "eager")
            state, stats = run["state"], run["stats"]
            per_rank = [stats]
            if group is not None:
                differ = mesh_mod.replicas_differ(
                    replicated_checksums(run["pipe"], state, group))
                report["replicas_equal"][f"{k} {form}"] = not differ
                report["misplaced"][f"{k} {form}"] = misplaced(
                    run["pipe"], run["like"], state, group)
                per_rank = [None] * k
                dist.all_gather_object(per_rank, stats, group=group)
            if form == forms[0]:
                images[k] = run["image"]
                report["counters"][k] = {n: float(v) for n, v in
                                         state.counters.items()}
            ms = run["ms"]
            report["frame_ms"][form][k] = sum(ms) / len(ms)
            report["frame_ms_median"][form][k] = float(
                torch.tensor(ms).median())
            report["frame_ms_range"][form][k] = [min(ms), max(ms)]
            report["frame_ms_each"][form][k] = ms
            report["ranks"][form][k] = per_rank
            if form == "graph":
                report["graph_vs_eager"][k] = _graph_vs_eager(run, group,
                                                              dev)
            del run, state
    ok = (all(report["replicas_equal"].values())
          and not any(report["misplaced"].values()))
    if rank == 0:
        for name in ("image_mean_abs_diff", "image_max_abs_diff",
                     "pixels_off"):
            report[name] = {}
        for k, image in images.items():
            d = (image - images[0]).abs()
            report["image_mean_abs_diff"][k] = float(d.mean())
            report["image_max_abs_diff"][k] = float(d.max())
            report["pixels_off"][k] = float((d.amax(-1) > DEFAULT_OFF)
                                            .float().mean())
            ok = ok and (report["image_mean_abs_diff"][k] <= DEFAULT_MEAN
                         and report["pixels_off"][k] <= DEFAULT_OFF_SHARE
                         and bool(torch.isfinite(image).all()))
        for k, frames in report["graph_vs_eager"].items():
            for update, exact, same, mean, off, e_mean, e_off in frames:
                if update:
                    ok = ok and (mean <= DEFAULT_MEAN + e_mean
                                 and off <= DEFAULT_OFF_SHARE + e_off)
                else:
                    ok = ok and exact and same
        report["ok"] = ok
        print(json.dumps({"graft_entry": report}), flush=True)
    if started:
        flag = torch.tensor([0.0 if ok else 1.0], device=dev
                            if dist.get_backend() == "nccl" else "cpu")
        dist.all_reduce(flag)
        ok = float(flag) == 0.0
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
