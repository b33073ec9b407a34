"""Entry points of the port (port of ``__graft_entry__.py``): one
frame step, the multi-device dry run and the banded frame's scaling run.

- ``entry()``: (fn, example args) of one frame step of the flagship
  pipeline at 256x256, 4 bounces, on the card.
- ``dryrun_multichip(n)``: the reference's recipe (64x64 below 8 devices,
  ``max(128, 8n)`` from 8; 2 bounces, ``compact_from=1``, SHARC 2^16,
  ReSTIR 8 cells) rendered banded over n ranks (one frame, its image
  finite and every rank's ``FrameState`` the same), then the banded
  ``trace_image`` over the instanced-geosphere scene. Under an existing
  process group it runs on that group's first n ranks; otherwise it
  spawns n ranks (NCCL, one card each, on ``cuda``; gloo on ``cpu``).
- ``python -m drts_tpu_torch.graft_entry``, alone or under torchrun::

      torchrun --nproc_per_node 4 -m drts_tpu_torch.graft_entry \\
          --default-frame [--width 1920 --height 1080] [--frames 5]

  renders the frame (``PipelineConfig()`` at the size given with
  ``--default-frame``, else ``entry``'s recipe) unbanded on rank 0
  (``group=None``, reported as rank count 0), then banded over the first
  1, 2, 4, ... ranks and all of them, each from the same start state: the
  warm frame, then ``--frames - 1`` timed frames (a synchronize and a
  barrier around each) and one SHARC cadence timed stage by stage. Rank
  0 holds every banded image to the unbanded one (the bounds of
  ``DEFAULT_*``), every count's replicas must agree, and it prints one
  JSON line: per rank count the frame time and the counters, and per
  rank its stage times, launches and spill waves a frame; a failed check
  exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from . import backend, bench
from .models import myscene, pipeline
from .ops import camera as camera_mod, pathtrace, restir, sharc
from .parallel import mesh as mesh_mod, multihost

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
    ``fn(state, pose, group=None)`` returns the image."""
    pipe, state, pose = _setup(_config(256, 256, bounces=4, spp=1), device)

    def fn(state, pose, group=None):
        _, image = pipe.render_frame(state, pose, 1.0 / 60.0, group=group)
        return image

    return fn, (state, pose)


def _dryrun(group, n_devices, device):
    dev = multihost.rank_device(device)
    height = width = max(128, 8 * n_devices) if n_devices >= 8 else 64
    pipe, state, pose = _setup(_config(width, height, bounces=2, spp=1,
                                       compact_from=1), dev)
    new_state, image = pipe.render_frame(state, pose, 1.0 / 60.0,
                                         group=group)
    assert image.shape == (pipe.cfg.output_height, pipe.cfg.output_width,
                           3)
    assert bool(torch.isfinite(image).all())
    differ = mesh_mod.replicas_differ(mesh_mod.replica_checksums(new_state,
                                                                 group))
    assert not differ, f"the ranks' states differ at {differ}"

    # The mesh path under the same bands: one banded trace over the
    # instanced-geosphere scene (one shared BLAS and an instance table,
    # the same on every rank), its rows gathered.
    mh = myscene.as_mesh_scene(myscene.build(oscillator_grid=4, device=dev),
                               tessellation=2)
    mw = mh_h = max(64, 8 * n_devices) if n_devices >= 8 else 32
    mcfg = pathtrace.PathTraceConfig(width=mw, height=mh_h, bounces=2,
                                     samples_per_pixel=1, block_size=4096,
                                     compact_from=2)
    mimg = banded_trace(group, mh, mcfg)
    assert mimg.shape == (mh_h, mw, 3)
    assert bool(torch.isfinite(mimg).all())


def banded_trace(group, host, cfg, frame_index=0):
    """``trace_image`` of `host`'s scene from its camera (90 degrees
    horizontal, aspect width / height), this rank's band traced and the
    radiance gathered: the full (height, width, 3) frame on every rank."""
    dev = host.scene.center.device
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 aspect=cfg.width / cfg.height, device=dev)
    out = pathtrace.trace_image(host.scene, cam, cfg, frame_index,
                                rows=mesh_mod.group_band(cfg.height, group))
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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The full frame step banded over n ranks, one step, then the banded
    mesh trace (see the module docstring). Under a started process group,
    every rank of it calls this; otherwise it spawns the n ranks."""
    if dist.is_initialized():
        group = mesh_mod.make_group(n_devices)
        if mesh_mod.is_member(group):
            _dryrun(group, n_devices, device)
        return
    multihost.spawn(_dryrun, n_devices, device, args=(n_devices, device))


def frames_worker(group, cfgs, frames, out_dir, oscillator_grid=10,
                  pose=None, device="cuda"):
    """A rank of ``multihost.spawn`` (the tests' spawned ranks): for each
    config of `cfgs`, `frames` frames banded over `group` from the demo
    scene's start state; then, per config, this rank's images, final
    state (on the CPU), replica checksums (over the group), band and
    kernel launches, saved as a list with torch.save to
    ``out_dir/rank<r>.pt``."""
    dev = multihost.rank_device(device)
    runs = []
    for cfg in cfgs:
        pipe, state, pose_ = _setup(cfg, dev, oscillator_grid, pose)
        backend.reset_launches()
        images = []
        for _ in range(frames):
            state, image = pipe.render_frame(state, pose_, group=group)
            images.append(image.cpu())
        runs.append({
            "images": images,
            "state": mesh_mod.map_tensors(lambda t: t.cpu(), state),
            "checksums": mesh_mod.replica_checksums(state, group),
            "launches": dict(backend.LAUNCHES),
            "band": mesh_mod.group_band(cfg.render_height, group)})
    torch.save(runs, os.path.join(out_dir, f"rank{dist.get_rank(group)}.pt"))


def _sync(dev, group):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        dist.barrier(group)


def _scaling_run(pipe, state, pose, frames, group, dev):
    """The warm frame, `frames` - 1 timed frames and one SHARC cadence
    timed stage by stage, banded over `group` (None: one device). Returns
    (frame ms, the last image, the last state, this rank's stats: stage
    ms, and launches and spill waves of its own band per timed frame)."""
    state, image = pipe.render_frame(state, pose, group=group)
    _sync(dev, group)
    backend.reset_launches()
    timed = max(frames - 1, 1)
    spills = []

    def count_spills(name, fn, *args):
        out = fn(*args)
        if name == "trace":
            spills.append(out.spill_waves)
        return out
    elapsed = 0.0
    for _ in range(timed):
        _sync(dev, group)
        t0 = time.perf_counter()
        state, image = pipe.render_frame(state, pose, group=group,
                                         _run=count_spills)
        _sync(dev, group)
        elapsed += time.perf_counter() - t0
    stats = {"launches_per_frame": {k: v / timed for k, v in
                                    backend.LAUNCHES.items() if v},
             "spill_waves_per_frame": sum(spills) / timed}
    staged = max(pipe.cfg.sharc_update_period, 1)
    passes = {}
    for _ in range(staged):
        frame = {}
        state, image = pipe.render_frame(
            state, pose, group=group, _run=bench.stage_timer(frame, dev))
        for name, ms in frame.items():
            passes[name] = passes.get(name, 0.0) + ms / staged
    _sync(dev, group)
    stats["passes_ms"] = passes
    return elapsed / timed * 1e3, image, state, stats


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
    pipe, state0, pose = _setup(cfg, dev)

    # Rank count 0 is the unbanded frame (group=None), on rank 0 alone.
    counts = [0] + (sorted({k for k in (1, 2, 4, 8, 16, 32) if k <= world}
                           | {world}) if started else [])
    report = {"world": world, "config": f"{w}x{h}"
              + (" PipelineConfig()" if args.default_frame else " entry"),
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "frame_ms": {}, "counters": {}, "replicas_equal": {},
              "ranks": {}}
    images = {}
    for k in counts:
        group = mesh_mod.make_group(k) if k else None
        if not (mesh_mod.is_member(group) if k else rank == 0):
            continue
        ms, image, state, stats = _scaling_run(pipe, state0, pose,
                                               args.frames, group, dev)
        per_rank = [stats]
        if group is not None:
            differ = mesh_mod.replicas_differ(
                mesh_mod.replica_checksums(state, group))
            report["replicas_equal"][k] = not differ
            per_rank = [None] * k
            dist.all_gather_object(per_rank, stats, group=group)
        images[k] = image.cpu()
        report["frame_ms"][k] = ms
        report["counters"][k] = {n: float(v) for n, v in
                                 state.counters.items()}
        report["ranks"][k] = per_rank
    ok = all(report["replicas_equal"].values())
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
