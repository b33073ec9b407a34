"""Benchmarks of the port, on one GPU.

The path-trace frame (the recipe of ``bench.py:bench_trace``): the demo
scene (oscillator grid 10), the per-frame Morton accel ordered from the
camera, the G-buffer and the wavefront integrator at 1920x1080, 1 spp, 8
bounces, Russian roulette on, compaction from bounce 2.

The ReSTIR frame (``--frame``): ``RenderPipeline.render_frame`` on the
same scene and camera with the reference's defaults except denoiser
"None" and SHARC off, at native 1920x1080 (so no TAA): physics, ReSTIR
DI, the path trace with the DI handoff, sharpen, bloom and tone mapping.

The mesh frame (``--mesh``, the recipe of ``bench.py:bench_mesh`` at the
reference's 8 bounces): the same scene as 438 instances of one
tessellation-4 geosphere (512 faces), no accel and no G-buffer, through
``pathtrace.trace_image`` at 1920x1080, 1 spp, 8 bounces.

The all-mesh ReSTIR frame (``--mesh-frame``): ``render_frame`` as in
``--frame`` on the scene of ``--mesh`` (an empty sphere table, so no
accel; every face of an emissive instance is a triangle light; the shadow
rays go through the mesh any-hit kernels).

The default frame (``--default-frame``): ``render_frame`` with the
reference's ``PipelineConfig()`` at 1920x1080 native: physics, ReSTIR DI,
SHARC (update every second frame, queries from bounce 2), the NRD ReBLUR
denoiser, TAA, sharpen, bloom, ACES. The upscaled frame (``--upscaled``,
the reference's ``bench.py:bench_upscaled``): the same graph rendered at
960x540 and upscaled by TAA to 1920x1080, block 32,768.

The all-mesh pipeline (``--mesh-pipeline``, the reference's
``bench.py:bench_mesh_pipeline``): the default frame graph (ReSTIR, SHARC,
ReBLUR, TAA) on the scene of ``--mesh``, untextured, rendered at 960x540
and upscaled by TAA to 1920x1080, 8 bounces, block 32,768, physics off,
and ``compact_from=1``: the bounce-1 wavefront is compacted too, into
519,168 slots, enough for the partition-mode sort.

The textured frame (``--textured-frame``): the default frame graph,
``PipelineConfig()`` at 1920x1080 native, on the mixed textured scene
``myscene.add_mesh_content(build(oscillator_grid=10), tessellation=3)``:
438 spheres and three 128-face geosphere instances (gold metal, a checker
and an alpha-tested cutout checker; packed texture sets of 2 words at
256^2), two alpha-test rounds, spheres and instances in one trace. The
reference renders this scene through this graph in its own tests
(tests/test_mesh_pipeline.py).

The options frame (``--options-frame``): ``PipelineConfig()`` at
1920x1080 on the demo scene with every exact choice of the settings
window on: the thin lens (aperture 0.05) focused at the demo camera's
distance to the scene origin (15), and ReSTIR with raytraced temporal and
spatial bias correction, the real previous surface and shared spatial
offsets. ``--accel none`` runs a sphere recipe (``--frame``,
``--default-frame``, ``--options-frame``) with ``accel_mode="none"``: no
Morton accel, so every sphere closest hit and shadow ray goes through the
brute-force kernel (B11).

``make_trace_setup(accel="clustered")`` gives the path trace the
reference's clustered accel: the xz-binned plan of ``clusters.build_plan``
and per frame ``clusters.make_accel``, so every closest hit goes through
the cluster-culled kernel (B13); ``chip_smoke.py`` runs that frame.
``DRTS_MXU_KERNEL=1`` in the environment (the reference's opt-in, read at
import by ``models.clusters``) sends every Morton closest hit and shadow
ray of any recipe through the tensor-core kernels (B12a, B12b).

``--mesh-cand {0,1,2}`` sets ``ops.trimesh.MESH_CAND`` before the mesh
frames (0 the serial walk, 1 the candidate loop, the default, 2 the fused
loop, B10).

The record (``--record``, the reference's ``bench.py:main``): six
benches at the reference's recipes and iteration counts in one JSON line
with the reference's keys (``record``): the headline path trace
(``bench_trace`` on the textured build, block 32,768, 1 warm and 8 timed
frames), the full pipeline (``bench_full_pipeline``: the frame graph at
native 1920x1080, block 32,768, 4 timed frames, its stage times and
counter report), the upscaled frame (``bench_upscaled``, 960x540 to
1920x1080, block 32,768, 4 timed), the mesh trace at 2 bounces (4 timed)
and at 8 (2 timed; ``bench_mesh``, untextured), the all-mesh pipeline
(``bench_mesh_pipeline``, 2 timed) and the port's fidelity record
(``FIDELITY_TORCH.json``). ``--fast`` keeps the headline alone. A bench
that fails lands in "errors" and the process exits 1 after printing the
line. Each bench's launches, frames and spill waves go to stderr.
``--iters`` does not apply to the record.

``--accel clustered`` runs the path trace on the clustered accel
(``make_trace_setup(accel="clustered")``: B13).

Every recipe, the record included, runs its frames as CUDA graph
replays (``pathtrace.trace_image_graph``,
``RenderPipeline.render_frame_graph``), as the reference's bench times
jitted frames: the warm frame captures, the timed frames replay;
passes_ms stays the eager frames' stage times. ``--eager`` runs every
frame eagerly instead. The frame and mesh lines also carry each timed
frame's ms between CUDA events at the frame boundaries (frame_ms_each,
frame_ms_median) and the peak device memory, and for graph frames the
callable's stats (capture seconds, host launches, the kernels' launches
the replays made, spill waves); the path trace's line keeps the
reference's keys and notes those on stderr. The record's keys are the
reference's either way.
``--device`` picks the device (default cuda).

    python -m drts_tpu_torch.bench [--iters N]
    DRTS_MXU_KERNEL=1 python -m drts_tpu_torch.bench --frame [--iters N]
    python -m drts_tpu_torch.bench --frame [--iters N]
    python -m drts_tpu_torch.bench --mesh [--mesh-cand M] [--iters N]
    python -m drts_tpu_torch.bench --mesh-frame [--mesh-cand M] [--iters N]
    python -m drts_tpu_torch.bench --default-frame [--iters N]
    python -m drts_tpu_torch.bench --upscaled [--iters N]
    python -m drts_tpu_torch.bench --mesh-pipeline [--iters N]
    python -m drts_tpu_torch.bench --textured-frame [--iters N]
    python -m drts_tpu_torch.bench --options-frame [--accel none] [--iters N]
    python -m drts_tpu_torch.bench --frame --accel none [--iters N]
    python -m drts_tpu_torch.bench --accel clustered [--iters N]
    python -m drts_tpu_torch.bench --record [--fast]
    python -m drts_tpu_torch.bench [--frame | --default-frame | --upscaled
        | --mesh [--mesh-cand M] | --mesh-frame | --mesh-pipeline
        | --textured-frame | --options-frame | --record] [--accel ACCEL]
        --eager [--iters N]

Each prints one JSON line: the path-trace frame with the keys of the
reference bench's headline (metric, value, unit, frame_ms,
rays_per_frame, device); the ReSTIR frame with frame_ms (one warm frame,
then N frames on a host clock ending in a synchronize), passes_ms (each
stage of one more frame, or with SHARC of the two frames of its update
cadence, averaged, through render_frame's ``_run`` hook, timed with CUDA
events and a synchronize per stage), rays_per_frame of the path
trace, the frame's counters, and the frames and launches per kernel of
the run and the spill waves the path trace ran (the all-mesh ReSTIR,
default, upscaled, all-mesh pipeline and textured frames alike); the mesh
frame
with
mesh_trace_8b_mray_s, mesh_trace_8b_ms, rays_per_frame and the kernel
launches of the run. All need a CUDA device and do not fall back to the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
import traceback

import numpy as np
import torch

from . import backend
from .models import clusters, myscene, pipeline, scene as scene_mod
from .ops import camera as camera_mod, gbuffer, pathtrace, restir, trimesh


@dataclasses.dataclass(frozen=True)
class TraceSetup:
    """Everything one frame of the benchmark needs. `accel` names the
    sphere accel its plan is for: "morton" (the Morton chunks) or
    "clustered" (the xz-binned clusters of the cluster-culled kernel)."""
    scene: scene_mod.SphereScene
    plan: clusters.ClusterPlan
    cam: camera_mod.Camera
    cfg: pathtrace.PathTraceConfig
    accel: str = "morton"


TRACE_ACCELS = ("morton", "clustered")


def make_trace_setup(width: int = 1920, height: int = 1080,
                     bounces: int = 8, spp: int = 1,
                     oscillator_grid: int = 10, device="cuda",
                     load_textures: bool = False,
                     accel: str = "morton") -> TraceSetup:
    if accel not in TRACE_ACCELS:
        raise ValueError(f"accel must be one of {TRACE_ACCELS}, got "
                         f"{accel!r}")
    host = myscene.build(oscillator_grid=oscillator_grid,
                         load_textures=load_textures, device=device)
    scene = host.scene
    centers, radii = scene.center.cpu().numpy(), scene.radius.cpu().numpy()
    if accel == "clustered":
        plan = clusters.build_plan(centers, radii, device=device)
    else:
        plan = clusters.build_plan_morton(centers, radii, max_members=32,
                                          device=device)
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0,
                                 aspect=width / height, device=device)
    cfg = pathtrace.PathTraceConfig(
        width=width, height=height, bounces=bounces, samples_per_pixel=spp,
        russian_roulette=True, block_size=32768, compact_from=2)
    return TraceSetup(scene=scene, plan=plan, cam=cam, cfg=cfg,
                      accel=accel)


def trace_frame(setup: TraceSetup, frame_index: int
                ) -> pathtrace.TraceOutput:
    """One frame: accel refit, G-buffer, path trace."""
    s = setup
    if s.accel == "clustered":
        accel = clusters.make_accel(s.plan, s.scene.center, s.scene.radius)
    else:
        accel = clusters.make_morton_accel(s.plan, s.scene.center,
                                           s.scene.radius,
                                           sort_origin=s.cam.position)
    gbuf = gbuffer.generate(s.scene, s.cam, s.cfg.width, s.cfg.height,
                            s.cfg.block_size, accel=accel)
    return pathtrace.trace_image(s.scene, s.cam, s.cfg, frame_index,
                                 gbuf=gbuf, accel=accel)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _mark(device):
    """A frame boundary: a CUDA event recorded on the current stream on a
    card (no synchronize), the host clock elsewhere."""
    if torch.device(device).type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _spans_ms(marks) -> list:
    """The ms between consecutive marks (after a synchronize)."""
    if isinstance(marks[0], float):
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _timing(device, marks, graph_stats) -> dict:
    """Per-frame times, peak device memory and, for graph frames, the
    callable's stats."""
    each = _spans_ms(marks)
    out = {"frame_ms_each": each,
           "frame_ms_median": float(np.median(each)) if each else None}
    if torch.device(device).type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if graph_stats is not None:
        out["graph"] = graph_stats.as_dict()
    return out


def _timed_traces(frame, iters: int, device, graphed):
    """frame(0) warm, then `iters` timed frames frame(1..iters), each
    returning a TraceOutput; `graphed` is the graph callable behind
    frame or None. Returns (stats, the last TraceOutput) as bench_trace
    describes them."""
    _reset_peak(device)
    out = frame(0)
    _sync(device)
    rays_per_frame = float(out.rays_traced)
    spill_waves = out.spill_waves
    marks = [_mark(device)]
    start = time.perf_counter()
    for i in range(iters):
        out = frame(i + 1)
        spill_waves += out.spill_waves
        marks.append(_mark(device))
    _sync(device)
    elapsed = time.perf_counter() - start
    stats = {
        "mray_s": rays_per_frame * iters / elapsed / 1e6,
        "frame_ms": elapsed / iters * 1e3,
        "rays_per_frame": rays_per_frame,
        "overflow_paths": float(
            out.counters["wavefront_overflow_paths"]),
        "frames": 1 + iters, "spill_waves": spill_waves,
        **_timing(device, marks, graphed and graphed.stats),
    }
    return stats, out


def bench_trace(width: int = 1920, height: int = 1080, bounces: int = 8,
                spp: int = 1, iters: int = 8, device="cuda",
                load_textures: bool = False, graph: bool = False,
                accel: str = "morton"):
    """One warm frame, then `iters` timed frames; with `graph`, each frame
    a replay of ``pathtrace.trace_image_graph`` (the warm frame captures
    it). Returns (stats, the last frame's TraceOutput); stats has mray_s,
    frame_ms, rays_per_frame, overflow_paths (of the last frame), frames,
    the spill waves of all of them, each timed frame's ms (CUDA events
    at the frame boundaries), the peak device memory and, with `graph`,
    the callable's stats (captures, launches, host launches); `accel` as
    make_trace_setup's."""
    setup = make_trace_setup(width, height, bounces, spp, device=device,
                             load_textures=load_textures, accel=accel)
    graphed = (pathtrace.trace_image_graph(setup.cfg, setup.plan,
                                           setup.accel) if graph else None)

    def frame(i):
        if graphed is not None:
            return graphed(setup.scene, setup.cam, i)
        return trace_frame(setup, i)
    return _timed_traces(frame, iters, device, graphed)


def make_mesh_setup(width: int = 1920, height: int = 1080, tess: int = 4,
                    bounces: int = 8, oscillator_grid: int = 10,
                    device="cuda"):
    """The mesh frame's (scene, camera, config): the demo scene as
    instances of one geosphere of `tess`."""
    host = myscene.as_mesh_scene(
        myscene.build(oscillator_grid=oscillator_grid, device=device),
        tessellation=tess)
    cam = camera_mod.make_camera(host.camera_position, host.camera_forward,
                                 horizontal_fov_deg=90.0,
                                 aspect=width / height, device=device)
    cfg = pathtrace.PathTraceConfig(
        width=width, height=height, bounces=bounces, samples_per_pixel=1,
        block_size=32768, compact_from=2)
    return host.scene, cam, cfg


def bench_mesh(width: int = 1920, height: int = 1080, tess: int = 4,
               bounces: int = 8, iters: int = 4, oscillator_grid: int = 10,
               device="cuda", graph: bool = False):
    """One warm mesh frame, then `iters` timed frames; with `graph`, each
    frame a replay of ``pathtrace.trace_image_graph`` (the warm frame
    captures it, with the mesh globals of that moment). Returns (stats,
    the last frame's TraceOutput) with bench_trace's keys."""
    scene, cam, cfg = make_mesh_setup(width, height, tess, bounces,
                                      oscillator_grid, device=device)
    graphed = pathtrace.trace_image_graph(cfg) if graph else None

    def frame(i):
        if graphed is not None:
            return graphed(scene, cam, i)
        return pathtrace.trace_image(scene, cam, cfg, i)
    return _timed_traces(frame, iters, device, graphed)


def default_frame_config(upscaled: bool = False, **overrides):
    """The reference's default frame, ``PipelineConfig()`` (1920x1080
    native); with `upscaled`, its ``bench_upscaled`` recipe: render
    960x540, output 1920x1080, block 32,768."""
    if upscaled:
        overrides = dict(dict(render_width=960, render_height=540,
                              block_size=32768), **overrides)
    return pipeline.PipelineConfig(**overrides)


def options_frame_config(**overrides):
    """``PipelineConfig()`` with every exact choice of the settings window
    on: aperture 0.05, the focus at the demo camera's distance to the
    scene origin, raytraced temporal and spatial bias correction, the real
    previous surface and shared spatial offsets."""
    focus = float(np.linalg.norm(myscene.MySceneHost.camera_position))
    return pipeline.PipelineConfig(**dict(dict(
        aperture_radius=0.05, focus_distance=focus,
        restir=restir.ReSTIRConfig(spatial_bias_correction="raytraced",
                                   temporal_bias_correction="raytraced",
                                   temporal_prev_surface="real",
                                   spatial_offset_mode="shared")),
        **overrides))


def mesh_pipeline_config(**overrides):
    """The reference's ``bench_mesh_pipeline`` recipe (for the scene of
    ``make_mesh_setup``): output 1920x1080, render 960x540, 8 bounces, 1
    spp, block 32,768, ``compact_from=1``, physics off."""
    return pipeline.PipelineConfig(**dict(dict(
        output_width=1920, output_height=1080, render_width=960,
        render_height=540, bounces=8, samples_per_pixel=1,
        block_size=32768, compact_from=1, physics_enabled=False),
        **overrides))


def make_frame_setup(width: int = 1920, height: int = 1080,
                     bounces: int = 8, oscillator_grid: int = 10,
                     device="cuda", mesh: bool = False, tess: int = 4,
                     cfg: pipeline.PipelineConfig | None = None,
                     textured: bool = False, env_map_path: str | None = None,
                     load_textures: bool = False):
    """The ReSTIR frame's pipeline, start state and camera pose (or, with
    `cfg`, that configuration's); with `mesh`, on the scene as instances
    of one geosphere of `tess`; with `textured`, on the mixed textured
    scene (add_mesh_content at tessellation 3). `env_map_path` lights the
    scene with a lat-long EXR map; `load_textures` builds the demo scene
    with the reference's texture files where they load."""
    if cfg is None:
        cfg = pipeline.restir_frame_config(width, height, bounces)
    pipe = pipeline.RenderPipeline(cfg, device)
    host = myscene.build(oscillator_grid=oscillator_grid,
                         load_textures=load_textures,
                         env_map_path=env_map_path, device=pipe.device)
    if mesh:
        host = myscene.as_mesh_scene(host, tessellation=tess)
    if textured:
        host = myscene.add_mesh_content(host, tessellation=3)
    return pipe, pipe.init_state(host), pipe.default_camera_pose(host)


def stage_timer(passes: dict, device):
    """A render_frame ``_run`` hook that records each stage's time in ms
    into `passes`: CUDA events around the stage with a synchronize on
    either side on a card, the host clock on the CPU."""
    on_card = torch.device(device).type == "cuda"

    def run(name, fn, *args):
        if not on_card:
            start = time.perf_counter()
            out = fn(*args)
            passes[name] = (time.perf_counter() - start) * 1e3
            return out
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        passes[name] = start.elapsed_time(end)
        return out
    return run


def bench_frame(width: int = 1920, height: int = 1080, bounces: int = 8,
                iters: int = 4, device="cuda", mesh: bool = False,
                cfg: pipeline.PipelineConfig | None = None,
                textured: bool = False, load_textures: bool = False,
                profile: bool = True, graph: bool = False):
    """One warm ReSTIR frame, then `iters` timed frames, then, with
    `profile`, frames timed stage by stage (one, or with SHARC one cadence
    of `sharc_update_period` frames, so that the update's cost is in,
    always eager); with `graph`, the warm and timed frames are replays of
    ``RenderPipeline.render_frame_graph`` (the warm frame captures it);
    with `mesh`, the all-mesh ReSTIR frame; with `textured`, on the mixed
    textured scene; `load_textures` as in make_frame_setup; with `cfg`,
    that configuration's frame (width, height and bounces are then the
    config's). Returns
    (stats, the last timed frame's image); stats has frame_ms, passes_ms
    (each stage's mean over the stage-timed frames), rays_per_frame (path
    trace, the first eager frame; None for graph frames without
    `profile`), the counters of the last timed frame, the number of frames
    rendered, the spill waves the path trace ran in them, each timed
    frame's ms (CUDA events at the frame boundaries), the peak device
    memory and, with `graph`, the callable's stats."""
    pipe, state, pose = make_frame_setup(width, height, bounces,
                                         device=device, mesh=mesh, cfg=cfg,
                                         textured=textured,
                                         load_textures=load_textures)
    traced = {"spill_waves": 0}

    def counted(run=None):
        """A _run hook around `run` (default: the stage itself) that keeps
        the first frame's rays traced and adds up the spill waves (a host
        int, so no sync)."""
        def hook(name, fn, *args):
            out = fn(*args) if run is None else run(name, fn, *args)
            if name == "trace":
                traced.setdefault("rays", out.rays_traced)
                traced["spill_waves"] += out.spill_waves
            return out
        return hook
    graphed = pipe.render_frame_graph() if graph else None

    def frame(state):
        if graphed is not None:
            return graphed(state, pose)
        return pipe.render_frame(state, pose, _run=counted())
    _reset_peak(device)
    state, image = frame(state)
    _sync(device)
    marks = [_mark(device)]
    start = time.perf_counter()
    for _ in range(iters):
        state, image = frame(state)
        marks.append(_mark(device))
    _sync(device)
    elapsed = time.perf_counter() - start
    timing = _timing(device, marks, graphed and graphed.stats)
    counters = {k: float(v) for k, v in state.counters.items()}
    staged = ((max(pipe.cfg.sharc_update_period, 1)
               if pipe.cfg.sharc_enabled else 1) if profile else 0)
    passes = {}
    for _ in range(staged):
        frame = {}
        state, _ = pipe.render_frame(
            state, pose, _run=counted(stage_timer(frame, device)))
        for name, ms in frame.items():
            passes[name] = passes.get(name, 0.0) + ms / staged
    if graphed is not None:
        traced["spill_waves"] += graphed.stats.spill_waves
    stats = {
        "frame_ms": elapsed / iters * 1e3,
        "frames": 1 + iters + staged,
        "passes_ms": passes,
        "rays_per_frame": (float(traced["rays"]) if "rays" in traced
                           else None),
        "counters": counters,
        "spill_waves": traced["spill_waves"],
        **timing,
    }
    return stats, image


def counter_report(counters: dict) -> dict:
    """The reference bench's counter report (``bench.py:128-147``): per
    bounce b the SHARC hit, gate and entry rates over its queries (3
    places), and every other counter rounded to 1 place."""
    hit_rates, gate_rates, entry_rates = {}, {}, {}
    for k in list(counters):
        if k.startswith("sharc_hits_b"):
            b = k[len("sharc_hits_b"):]
            q = counters.get(f"sharc_queries_b{b}", 0.0)
            if q > 0:
                hit_rates[f"b{b}"] = round(counters[k] / q, 3)
                gate_rates[f"b{b}"] = round(
                    counters.get(f"sharc_gate_b{b}", 0.0) / q, 3)
                entry_rates[f"b{b}"] = round(
                    counters.get(f"sharc_entry_b{b}", 0.0) / q, 3)
    report = {k: round(v, 1) for k, v in counters.items()
              if not k.startswith(("sharc_hits", "sharc_queries",
                                   "sharc_gate", "sharc_entry"))}
    if hit_rates:
        report["sharc_hit_rate"] = hit_rates
        report["sharc_gate_rate"] = gate_rates
        report["sharc_entry_rate"] = entry_rates
    return report


def _checked_frames(cfg, iters, device, mesh=False, profile=False,
                    graph=False):
    """bench_frame on the textured build of the demo scene; raises on a
    non-finite image and drops it. Returns the stats."""
    stats, image = bench_frame(iters=iters, device=device, mesh=mesh,
                               cfg=cfg, load_textures=True, profile=profile,
                               graph=graph)
    if not bool(torch.isfinite(image).all()):
        raise RuntimeError("non-finite image")
    return stats


def bench_full_pipeline(iters: int = 4, device="cuda", graph=False):
    """The reference's ``bench_full_pipeline``: the frame graph at native
    1920x1080, 8 bounces, 1 spp, block 32,768, on the textured build; one
    warm frame, then `iters` timed. Returns (frame ms, passes_ms rounded to
    2 places, counter_report of the last timed frame, stats): the stages
    are timed by stage_timer over one SHARC cadence after the timed
    frames; with `graph`, the warm and timed frames are graph replays."""
    cfg = default_frame_config(block_size=32768)
    stats = _checked_frames(cfg, iters, device, profile=True, graph=graph)
    passes = {k: round(v, 2) for k, v in stats["passes_ms"].items()}
    return stats["frame_ms"], passes, counter_report(stats["counters"]), \
        stats


def bench_upscaled(iters: int = 4, device="cuda", graph=False):
    """The reference's ``bench_upscaled``: default_frame_config(upscaled=
    True), 960x540 upscaled by TAA to 1920x1080, on the textured build; one
    warm frame, then `iters` timed (graph replays with `graph`). Returns
    (frame ms, stats)."""
    stats = _checked_frames(default_frame_config(upscaled=True), iters,
                            device, graph=graph)
    return stats["frame_ms"], stats


def bench_mesh_pipeline(iters: int = 2, device="cuda", graph=False):
    """The reference's ``bench_mesh_pipeline``: mesh_pipeline_config() on
    the all-mesh scene (the textured build as instances of a
    tessellation-4 geosphere); one warm frame, then `iters` timed (graph
    replays with `graph`). Returns (frame ms, stats)."""
    stats = _checked_frames(mesh_pipeline_config(), iters, device,
                            mesh=True, graph=graph)
    return stats["frame_ms"], stats


# The keys of the reference bench's record (``bench.py:main``), with and
# without DRTS_BENCH_FAST, where the fidelity record exists; "errors" comes
# only with a failed bench.
FAST_RECORD_KEYS = frozenset((
    "metric", "value", "unit", "vs_baseline", "device", "frame_ms",
    "rays_per_frame", "fidelity_recorded"))
RECORD_KEYS = FAST_RECORD_KEYS | frozenset((
    "full_pipeline_ms", "passes_ms", "counters", "passes_sum_ms",
    "full_pipeline_upscaled_ms", "mesh_trace_mray_s", "mesh_trace_ms",
    "mesh_trace_8b_mray_s", "mesh_trace_8b_ms",
    "mesh_pipeline_upscaled_ms"))

# The port's record of its fidelity runs (python -m drts_tpu_torch.fidelity
# --record FIDELITY_TORCH.json), at the root of the checkout.
FIDELITY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "FIDELITY_TORCH.json")


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def _note(msg):
    print(msg, file=sys.stderr, flush=True)


def record(device, fast: bool = False, fidelity_path: str = FIDELITY_PATH,
           note=_note, graph: bool = False):
    """The reference bench's record (``bench.py:main``): the headline
    path trace, then (unless `fast`) the full pipeline with its stage
    times and counters, the upscaled frame, the mesh trace at 2 and at 8
    bounces and the all-mesh pipeline, each in its own try, so a failure
    keeps what ran before it; then the port's fidelity record from
    `fidelity_path` where that file exists. Each bench's launches per
    kernel, frames and spill waves go to `note` as one line, ``bench:
    launches {...}`` (with `graph`, every bench's warm and timed frames
    are graph replays, and the line adds the launches the replays made,
    "graph_launches", to the eager and captured ones). Returns (record,
    errors); the errors, each prefixed with its bench's name as the
    reference does, are in the record too when there are any.

    Where it differs from the reference, on purpose: `fast` stands for
    DRTS_BENCH_FAST; "device" is the card's name; there is no compile
    cache; passes_ms is timed by stage_timer (CUDA events) over one SHARC
    cadence after the timed frames, where the reference jits each pass
    and writes -1.0 for one that fails (here a failed pass fails its bench
    into the errors); every bench raises on a non-finite image and drops
    its state before the next."""
    device = torch.device(device)
    rec = {
        "metric": "path_trace_1080p_1spp_8bounce",
        "value": 0.0,
        "unit": "Mray/s/chip",
        "vs_baseline": 0.0,
        "device": device_name(device),
    }
    errors = []

    def run(name, fn):
        backend.reset_launches()
        try:
            stats = fn()
        except Exception:
            errors.append(f"{name}: " + traceback.format_exc(limit=2))
            return
        finally:
            if device.type == "cuda":
                torch.cuda.empty_cache()
        line = {"bench": name, "frames": stats["frames"],
                "spill_waves": stats["spill_waves"],
                "launches": dict(backend.LAUNCHES)}
        if "graph" in stats:
            line["graph_launches"] = stats["graph"]["launches"]
        note("bench: launches " + json.dumps(line))

    def trace():
        note("bench: trace...")
        stats, out = bench_trace(device=device, load_textures=True,
                                 graph=graph)
        if not bool(torch.isfinite(out.radiance).all()):
            raise RuntimeError("non-finite radiance")
        mray_s, frame_ms = stats["mray_s"], stats["frame_ms"]
        rec.update(value=round(mray_s, 2),
                   vs_baseline=round(mray_s / 200.0, 4),
                   frame_ms=round(frame_ms, 2),
                   rays_per_frame=int(stats["rays_per_frame"]))
        note(f"bench: trace {mray_s:.1f} Mray/s ({frame_ms:.1f} ms)")
        return stats

    def full_pipeline():
        note("bench: full pipeline...")
        full_ms, passes, counters, stats = bench_full_pipeline(
            device=device, graph=graph)
        rec["full_pipeline_ms"] = round(full_ms, 2)
        rec["passes_ms"] = passes
        rec["counters"] = counters
        rec["passes_sum_ms"] = round(
            sum(v for v in passes.values() if v > 0), 2)
        note(f"bench: full pipeline {full_ms:.1f} ms")
        return stats

    def upscaled():
        note("bench: upscaled (reference-default DLSS-SR Auto)...")
        up_ms, stats = bench_upscaled(device=device, graph=graph)
        rec["full_pipeline_upscaled_ms"] = round(up_ms, 2)
        note(f"bench: upscaled pipeline {up_ms:.1f} ms")
        return stats

    def mesh(bounces, iters, prefix):
        note(f"bench: instanced-mesh trace @{bounces} bounces...")
        stats, out = bench_mesh(bounces=bounces, iters=iters, device=device,
                                graph=graph)
        if not bool(torch.isfinite(out.radiance).all()):
            raise RuntimeError("non-finite radiance")
        rec[f"{prefix}_mray_s"] = round(stats["mray_s"], 2)
        rec[f"{prefix}_ms"] = round(stats["frame_ms"], 2)
        note(f"bench: mesh trace {bounces}b {stats['mray_s']:.2f} Mray/s "
             f"({stats['frame_ms']:.1f} ms)")
        return stats

    def mesh_pipeline():
        note("bench: mesh full pipeline (reference-default upscale)...")
        ms, stats = bench_mesh_pipeline(device=device, graph=graph)
        rec["mesh_pipeline_upscaled_ms"] = round(ms, 2)
        note(f"bench: mesh pipeline {ms:.1f} ms")
        return stats

    # Headline first, so that a later failure cannot lose it.
    run("trace", trace)
    if not fast:
        run("full_pipeline", full_pipeline)
        run("upscaled", upscaled)
        run("mesh", lambda: mesh(2, 4, "mesh_trace"))
        run("mesh8", lambda: mesh(8, 2, "mesh_trace_8b"))
        run("mesh_pipeline", mesh_pipeline)
    if os.path.exists(fidelity_path):
        try:
            with open(fidelity_path) as fh:
                rec["fidelity_recorded"] = json.load(fh)
        except Exception:
            errors.append("fidelity_record: "
                          + traceback.format_exc(limit=1))
    if errors:
        rec["errors"] = errors
    return rec, errors


def _watchdog(*_):
    print(json.dumps({"error": "bench watchdog expired"}), flush=True)
    os._exit(3)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=8,
                        help="timed frames (the record keeps the "
                             "reference's counts)")
    parser.add_argument("--record", action="store_true",
                        help="the reference bench's record: all six "
                             "benches in one JSON line")
    parser.add_argument("--fast", action="store_true",
                        help="with --record, the headline alone (the "
                             "reference's DRTS_BENCH_FAST)")
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
                        help="the all-mesh pipeline, 540p upscaled to "
                             "1080p, compact_from=1")
    parser.add_argument("--textured-frame", action="store_true",
                        help="the default frame on the mixed textured "
                             "scene")
    parser.add_argument("--options-frame", action="store_true",
                        help="the default frame with the thin lens and the "
                             "raytraced ReSTIR modes")
    parser.add_argument("--accel", default="morton",
                        choices=pipeline.ACCEL_MODES + ("clustered",),
                        help="accel_mode of the sphere frame recipes "
                             "(morton, none), or the path trace's accel "
                             "(morton, clustered)")
    parser.add_argument("--mesh-cand", type=int, default=trimesh.MESH_CAND,
                        choices=trimesh.MESH_CAND_MODES,
                        help="the mesh closest-hit form (ops.trimesh."
                             "MESH_CAND)")
    parser.add_argument("--eager", action="store_true",
                        help="every frame eagerly (default: CUDA graph "
                             "replays, any recipe and the record)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)
    sphere_frame = args.frame or args.default_frame or args.options_frame
    trace = not (sphere_frame or args.record or args.mesh or args.mesh_frame
                 or args.upscaled or args.mesh_pipeline
                 or args.textured_frame)
    if args.accel == "none" and not sphere_frame:
        parser.error("--accel none applies to --frame, --default-frame and "
                     "--options-frame")
    if args.accel == "clustered" and not trace:
        parser.error("--accel clustered applies to the path trace alone")
    if args.fast and not args.record:
        parser.error("--fast applies to --record")
    graph = not args.eager
    if args.record and (sphere_frame or args.mesh or args.mesh_frame
                        or args.upscaled or args.mesh_pipeline
                        or args.textured_frame
                        or args.mesh_cand != trimesh.MESH_CAND):
        parser.error("--record runs the reference's recipes: no frame "
                     "flag or --mesh-cand with it")
    dev = backend.device(args.device)
    if args.record:
        # A bench that hangs the card exits with code 3 after 45 minutes
        # (the reference's watchdog), set here and not at import.
        previous = signal.signal(signal.SIGALRM, _watchdog)
        signal.alarm(45 * 60)
        try:
            rec, errors = record(dev, fast=args.fast,
                                 fidelity_path=FIDELITY_PATH, graph=graph)
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, previous)
        print(json.dumps(rec), flush=True)
        if errors:
            sys.exit(1)
        return
    trimesh.MESH_CAND = args.mesh_cand
    if args.mesh:
        backend.reset_launches()
        stats, out = bench_mesh(iters=args.iters, device=dev,
                                graph=graph)
        if not bool(torch.isfinite(out.radiance).all()):
            raise RuntimeError("non-finite radiance")
        print(json.dumps({
            "metric": "mesh_trace_1080p_1spp_8bounce",
            "mesh_trace_8b_mray_s": stats["mray_s"],
            "mesh_trace_8b_ms": stats["frame_ms"],
            "rays_per_frame": int(stats["rays_per_frame"]),
            "overflow_paths": stats["overflow_paths"],
            "frames": args.iters + 1, "mesh_cand": args.mesh_cand,
            **{k: stats[k] for k in ("frame_ms_each", "frame_ms_median",
                                     "peak_memory_bytes", "graph",
                                     "spill_waves") if k in stats},
            "launches": dict(backend.LAUNCHES),
            "device": device_name(dev),
        }), flush=True)
        return
    if (args.frame or args.mesh_frame or args.default_frame or args.upscaled
            or args.mesh_pipeline or args.textured_frame
            or args.options_frame):
        cfg = None
        metric = ("mesh_restir_frame_1080p_8bounce" if args.mesh_frame
                  else "restir_frame_1080p_8bounce")
        if args.default_frame or args.upscaled:
            cfg = default_frame_config(upscaled=args.upscaled)
            metric = ("upscaled_frame_540p_to_1080p_8bounce" if args.upscaled
                      else "default_frame_1080p_8bounce")
        if args.mesh_pipeline:
            cfg = mesh_pipeline_config()
            metric = "mesh_pipeline_540p_to_1080p_8bounce"
        if args.textured_frame:
            cfg = default_frame_config()
            metric = "textured_frame_1080p_8bounce"
        if args.options_frame:
            cfg = options_frame_config()
            metric = "options_frame_1080p_8bounce"
        if args.accel != "morton":
            if cfg is None:
                cfg = pipeline.restir_frame_config()
            cfg = dataclasses.replace(cfg, accel_mode=args.accel)
            metric += f"_accel_{args.accel}"
        backend.reset_launches()
        stats, image = bench_frame(iters=args.iters, device=dev,
                                   mesh=args.mesh_frame or args.mesh_pipeline,
                                   cfg=cfg, textured=args.textured_frame,
                                   graph=graph)
        if not bool(torch.isfinite(image).all()):
            raise RuntimeError("non-finite image")
        print(json.dumps({
            "metric": metric, "value": stats["frame_ms"], "unit": "ms",
            **stats, "mesh_cand": args.mesh_cand, "accel": args.accel,
            "launches": dict(backend.LAUNCHES),
            "device": device_name(dev),
        }), flush=True)
        return
    backend.reset_launches()
    kw = {"graph": graph}
    if args.accel != "morton":
        kw["accel"] = args.accel
    stats, out = bench_trace(iters=args.iters, device=dev, **kw)
    if not np.isfinite(out.radiance.cpu().numpy()).all():
        raise RuntimeError("non-finite radiance")
    # The line keeps the reference's headline keys in either form; the
    # frame timings (and a graph frame's stats and launches) go to stderr.
    extra = {}
    noted = {k: stats[k] for k in ("frame_ms_each", "frame_ms_median",
                                   "peak_memory_bytes", "spill_waves",
                                   "graph") if k in stats}
    if graph:
        noted["launches"] = dict(backend.LAUNCHES)
    _note("bench: " + json.dumps(noted))
    if args.accel != "morton":
        extra["accel"] = args.accel
    print(json.dumps({
        "metric": "path_trace_1080p_1spp_8bounce",
        "value": stats["mray_s"],
        "unit": "Mray/s/chip",
        "frame_ms": stats["frame_ms"],
        "rays_per_frame": int(stats["rays_per_frame"]),
        **extra,
        "device": device_name(dev),
    }), flush=True)


if __name__ == "__main__":
    main()
