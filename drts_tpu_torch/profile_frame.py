"""Where a frame's device time goes: a torch.profiler trace of the
path-trace frame (``bench.trace_frame``) or, with ``--frame``, of the
ReSTIR frame (``RenderPipeline.render_frame``) or, with ``--mesh``, of the
instanced-mesh frame (``bench.make_mesh_setup``) or, with ``--mesh-frame``,
of the all-mesh ReSTIR frame, or, with ``--default-frame`` and
``--upscaled``, of the reference's default frame (``bench.
default_frame_config``), or, with ``--mesh-pipeline``, of the all-mesh
pipeline (``bench.mesh_pipeline_config``), or, with ``--textured-frame``,
of the default frame on the mixed textured scene (``bench.
make_frame_setup(textured=True)``), or, with ``--options-frame``, of the
default frame with the thin lens and the raytraced ReSTIR modes (``bench.
options_frame_config``), on one GPU. ``--mesh-cand`` sets
``ops.trimesh.MESH_CAND`` first; ``--accel none`` runs a sphere frame
recipe (``--frame``, ``--default-frame``, ``--options-frame``) with no
accel, ``--accel clustered`` the path trace on the clustered accel.

    python -m drts_tpu_torch.profile_frame
        [--frame | --mesh | --mesh-frame | --default-frame | --upscaled
         | --mesh-pipeline | --textured-frame | --options-frame]
        [--accel none | clustered] [--mesh-cand M] [--frames N] [--eager]
        [--out PATH]

Prints one JSON object: the frame time of unprofiled frames, then, over
the same traced frames, the frame time, device busy time and idle share,
launches per frame, each hand-written kernel's device time and calls per
frame, and the top device kernels by total time. The trace records device
activity only (no host op tracing); the two frame times show by how much
it stretches the frame. The frames are CUDA graph replays (the warm frame
captures them), as ``bench``'s, and the object also holds the host
launches of the last frame (graph launches, input writes) and the
callable's stats; ``--eager`` profiles eager frames instead. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import backend, bench
from .models import pipeline
from .ops import pathtrace, trimesh

# The hand-written kernels' function names in csrc/*.cu (B12a's and
# B12b's builds of every MXU precision count under their kernel's name;
# B12b's "highest" build is a kernel of its own).
HAND_KERNELS = ("morton_closest_hit", "brute_closest_hit", "morton_occlusion",
                "morton_mxu_closest_hit", "morton_mxu_occlusion",
                "morton_mxu_occlusion_highest", "clustered_closest_hit",
                "initial_candidates", "reproject", "bound_scan",
                "shared_blas_sweep", "mesh_instances_closest",
                "shared_blas_any", "mesh_instances_any", "cand_fused")


def _device_us(evt) -> float:
    return float(getattr(evt, "device_time_total", None)
                 or getattr(evt, "cuda_time_total", 0.0))


def _frames_wall_us(step, frames: int) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(frames):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e6


def _frame_step(recipe: str, device, accel: str = "morton",
                graph: bool = False):
    """A function that renders the next frame of the chosen recipe (a
    sphere frame recipe with `accel` as its accel_mode, the path trace on
    the clustered accel with "clustered"); with `graph`,
    as CUDA graph replays (the first call captures). Returns (step, the
    graph callable or None)."""
    frame = [0]
    if recipe == "mesh_frame":
        scene, cam, cfg = bench.make_mesh_setup(device=device)
        traced = pathtrace.trace_image_graph(cfg) if graph else None

        def step():
            if traced is not None:
                traced(scene, cam, frame[0])
            else:
                pathtrace.trace_image(scene, cam, cfg, frame[0])
            frame[0] += 1
        return step, traced
    if recipe in ("restir_frame", "mesh_restir_frame", "default_frame",
                  "upscaled_frame", "mesh_pipeline", "textured_frame",
                  "options_frame"):
        cfg = None
        if recipe in ("default_frame", "upscaled_frame", "textured_frame"):
            cfg = bench.default_frame_config(
                upscaled=recipe == "upscaled_frame")
        if recipe == "mesh_pipeline":
            cfg = bench.mesh_pipeline_config()
        if recipe == "options_frame":
            cfg = bench.options_frame_config()
        if accel != "morton":
            cfg = dataclasses.replace(
                cfg or pipeline.restir_frame_config(), accel_mode=accel)
        pipe, state, pose = bench.make_frame_setup(
            device=device, mesh=recipe in ("mesh_restir_frame",
                                           "mesh_pipeline"), cfg=cfg,
            textured=recipe == "textured_frame")
        box = [state]
        render = pipe.render_frame_graph() if graph else pipe.render_frame

        def step():
            box[0], _ = render(box[0], pose)
        return step, render if graph else None
    setup = bench.make_trace_setup(
        device=device, accel="clustered" if accel == "clustered" else "morton")
    traced = (pathtrace.trace_image_graph(setup.cfg, setup.plan, setup.accel)
              if graph else None)

    def step():
        if traced is not None:
            traced(setup.scene, setup.cam, frame[0])
        else:
            bench.trace_frame(setup, frame[0])
        frame[0] += 1
    return step, traced


def profile_frames(frames: int = 2, device="cuda",
                   recipe: str = "trace_frame", accel: str = "morton",
                   graph: bool = False) -> dict:
    step, graphed = _frame_step(recipe, device, accel, graph)
    step()                                           # warm (and capture)
    plain_us = _frames_wall_us(step, frames)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_us = _frames_wall_us(step, frames)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    hand = {}
    for name in HAND_KERNELS:
        found = [e for e in kernels
                 if re.search(rf"\b{name}[(<]", e.key)]
        hand[name] = {
            "calls_per_frame": sum(e.count for e in found) / frames,
            "ms_per_frame": sum(_device_us(e) for e in found) / frames / 1e3}
    out = {
        "device": torch.cuda.get_device_name(0),
        "recipe": recipe, "accel": accel, "mesh_cand": trimesh.MESH_CAND,
        "graph": graph, "frames": frames,
        "frame_ms_unprofiled": plain_us / frames / 1e3,
        "frame_ms_profiled": wall_us / frames / 1e3,
        "device_busy_ms_per_frame": busy_us / frames / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / wall_us),
        "hand_kernels": hand,
        "kernel_launches_per_frame": sum(e.count for e in kernels) / frames,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "ms_per_frame": _device_us(e) / frames / 1e3}
                        for e in top],
    }
    if graphed is not None:
        out["graph_host_launches_per_frame"] = \
            graphed.stats.last_host_launches
        out["graph_stats"] = graphed.stats.as_dict()
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--frame", action="store_true",
                        help="the ReSTIR frame instead of the path trace")
    parser.add_argument("--mesh", action="store_true",
                        help="the instanced-mesh frame instead")
    parser.add_argument("--mesh-frame", action="store_true",
                        help="the all-mesh ReSTIR frame instead")
    parser.add_argument("--default-frame", action="store_true",
                        help="the reference's default frame instead")
    parser.add_argument("--upscaled", action="store_true",
                        help="the default frame upscaled from 960x540")
    parser.add_argument("--mesh-pipeline", action="store_true",
                        help="the all-mesh pipeline (compact_from=1)")
    parser.add_argument("--textured-frame", action="store_true",
                        help="the default frame on the mixed textured scene")
    parser.add_argument("--options-frame", action="store_true",
                        help="the default frame with the thin lens and the "
                             "raytraced ReSTIR modes")
    parser.add_argument("--accel", default="morton",
                        choices=pipeline.ACCEL_MODES + ("clustered",),
                        help="accel_mode of the sphere frame recipes "
                             "(morton, none), or the path trace's accel "
                             "(morton, clustered)")
    parser.add_argument("--mesh-cand", type=int, default=trimesh.MESH_CAND,
                        choices=trimesh.MESH_CAND_MODES)
    parser.add_argument("--eager", action="store_true",
                        help="eager frames (default: CUDA graph replays)")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sphere_frame = args.frame or args.default_frame or args.options_frame
    if args.accel == "none" and not sphere_frame:
        parser.error("--accel none applies to --frame, --default-frame and "
                     "--options-frame")
    trimesh.MESH_CAND = args.mesh_cand
    recipe = ("options_frame" if args.options_frame
              else "textured_frame" if args.textured_frame
              else "mesh_pipeline" if args.mesh_pipeline
              else "mesh_restir_frame" if args.mesh_frame
              else "mesh_frame" if args.mesh
              else "default_frame" if args.default_frame
              else "upscaled_frame" if args.upscaled
              else "restir_frame" if args.frame else "trace_frame")
    if args.accel == "clustered" and recipe != "trace_frame":
        parser.error("--accel clustered applies to the path trace alone")
    result = profile_frames(args.frames, backend.device("cuda"), recipe,
                            args.accel, not args.eager)
    text = json.dumps(result, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)


if __name__ == "__main__":
    main()
