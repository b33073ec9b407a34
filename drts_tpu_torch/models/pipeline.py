"""The render pipeline: the frame orchestrator (port of
``drts_tpu/models/pipeline.py``).

``state', image = pipeline.render_frame(state, pose)`` runs one App::Tick
(App.cpp:144-643): physics step -> scene pose refresh -> per-frame Morton
accel -> G-buffer -> ReSTIR DI (light preparation, ReGIR grid, initial,
temporal, spatial, final shading) -> path trace with the DI handoff ->
sharpen -> bloom -> tone map. History (reservoirs, previous depth and
normal) is threaded through ``FrameState``.

The port takes the reference's frame graph with the denoiser set to
"None" and SHARC (RTXGI) off, at native resolution, where ``taa_mode=
"auto"`` runs no TAA. The constructor raises NotImplementedError for the
options that wait for later slices: SHARC, a denoiser, TAA, debug views,
a thin lens, a focus distance other than 1 and ``accel_mode="none"``.
There is no counterpart of the reference's ``intersect.pallas_enabled()``
gate: the accel is built every frame and every pass takes its kernel. An
all-mesh scene (``myscene.as_mesh_scene``: an empty sphere table) has no
cluster plan and no accel: its physics poses go to the mesh instances,
whose per-call tables the mesh path builds itself.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import backend
from ..ops import (camera as camera_mod, gbuffer, light as light_mod,
                   pathtrace, physics, post, restir)
from ..utils import rng as rng_mod
from . import clusters, myscene, scene as scene_mod


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline topology, with the reference's names and defaults
    (the defaults include options the port does not run yet: a
    RenderPipeline built from them raises)."""
    output_width: int = 1920
    output_height: int = 1080
    render_width: int = 1920
    render_height: int = 1080
    bounces: int = 8
    samples_per_pixel: int = 1
    russian_roulette: bool = True
    throughput_threshold: float = 1e-3
    denoiser: str = "NRDReBLUR"
    denoiser_max_history: int = 30
    denoiser_clamp_gamma: float = 2.5
    denoiser_specular_virtual: bool = True
    upscaling: bool = True
    taa_mode: str = "auto"
    taa_history_filter: str = "bilinear"
    taa_clip_gamma: float = 1.0
    taa_clip_gamma_motion: float = 0.2
    taa_clip_motion_px: float = 0.25
    taa_blend_alpha: float = 0.1
    bloom_enabled: bool = True
    bloom_strength: float = 0.05
    sharpen_enabled: bool = True
    sharpness: float = 0.5
    chromatic_aberration_strength: float = 0.0
    tone_map_operator: str = "ACESFilmic"
    exposure: float = 1.0
    hdr_enabled: bool = False
    paper_white_nits: float = 200.0
    hdr_color_rotation: str = "HDTV_to_UHDTV"
    aperture_radius: float = 0.0
    focus_distance: float = 1.0
    jitter_enabled: bool = True
    physics_enabled: bool = True
    horizontal_fov_deg: float = 90.0
    block_size: int = 16384
    compact_from: int = 2
    sharc_query_from: int = 2
    halton_period: int = 64
    restir_enabled: bool = True
    restir: restir.ReSTIRConfig = dataclasses.field(
        default_factory=restir.ReSTIRConfig)
    accel_mode: str = "morton"
    debug_view: str = "None"
    sharc_enabled: bool = True
    # The reference's SHARCConfig; the cache is not ported yet, so any
    # value other than None comes with sharc_enabled and raises.
    sharc: object = None
    sharc_downscale: int = 4
    sharc_update_period: int = 2
    texture_bounces: int = 2


def restir_frame_config(width: int = 1920, height: int = 1080,
                        bounces: int = 8, **overrides) -> PipelineConfig:
    """The ReSTIR frame: the reference defaults with denoiser "None" and
    SHARC off at native resolution (so no TAA), block 32,768 and
    compaction from bounce 2, as the reference's bench recipe."""
    return PipelineConfig(
        output_width=width, output_height=height, render_width=width,
        render_height=height, upscaling=False, bounces=bounces,
        denoiser="None", sharc_enabled=False, block_size=32768,
        compact_from=2, **overrides)


@dataclasses.dataclass(frozen=True)
class FrameState:
    """All cross-frame state. ``denoiser``, ``taa`` and ``sharc`` are the
    reference's history fields; they stay None until those passes are
    ported."""
    frame_index: torch.Tensor        # scalar int64
    bodies: physics.RigidBodies
    scene: scene_mod.SphereScene
    reservoirs: restir.Reservoirs
    prev_depth: torch.Tensor         # (RH, RW) previous linear depth
    prev_normal: torch.Tensor        # (RH, RW, 3) previous shading normal
    prev_surface_rows: torch.Tensor  # (1, 1, 7) placeholder (basic mode)
    earth_gravity: torch.Tensor      # scalar bool toggles
    star_gravity: torch.Tensor
    counters: dict = dataclasses.field(default_factory=dict)
    denoiser: object = None
    taa: object = None
    sharc: object = None


@dataclasses.dataclass(frozen=True)
class DynamicSettings:
    """Per-frame tunable scalars (the ImGui sliders that change no kernel
    topology, App.cpp:2128-2207)."""
    exposure: torch.Tensor
    bloom_strength: torch.Tensor
    sharpness: torch.Tensor


def default_dynamic(cfg: PipelineConfig, device="cuda") -> DynamicSettings:
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return DynamicSettings(exposure=f32(cfg.exposure),
                           bloom_strength=f32(cfg.bloom_strength),
                           sharpness=f32(cfg.sharpness))


@dataclasses.dataclass(frozen=True)
class CameraPose:
    """Dynamic camera inputs (position and orientation)."""
    position: torch.Tensor  # (3,)
    forward: torch.Tensor   # (3,)
    up: torch.Tensor        # (3,)


def _check_supported(c: PipelineConfig) -> None:
    use_taa = {"auto": c.upscaling or c.denoiser != "None",
               "on": True, "off": False}[c.taa_mode]
    waits = [
        (c.sharc_enabled, "SHARC (sharc_enabled)"),
        (c.sharc is not None, "a SHARC config"),
        (c.denoiser != "None", f"the {c.denoiser} denoiser"),
        (use_taa, "the TAA upscale"),
        (c.debug_view != "None", f"the {c.debug_view} debug view"),
        (c.aperture_radius > 0.0, "the thin-lens camera"),
        (c.focus_distance != 1.0, "a focus distance other than 1"),
        (c.accel_mode != "morton", f"accel_mode={c.accel_mode!r}"),
    ]
    for bad, what in waits:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")
    if c.restir_enabled:
        restir.check_config(c.restir)


class RenderPipeline:
    """Static config, Halton jitter table and the cluster plan."""

    def __init__(self, cfg: PipelineConfig, device="cuda"):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = backend.device(device)
        # Jitter phases: 8 x the upscale ratio squared, at least
        # halton_period (the DLSS convention the reference uses).
        ratio2 = ((cfg.output_width * cfg.output_height)
                  / max(cfg.render_width * cfg.render_height, 1))
        period = max(cfg.halton_period, int(round(8 * ratio2)))
        self.jitter_table = torch.from_numpy(
            rng_mod.halton_jitter(period)).to(self.device)
        self.cluster_plan = None  # built by build_plan / init_state
        self._planned = False

    # -- state management ---------------------------------------------------

    def build_plan(self, host: myscene.MySceneHost) -> None:
        """Build the static cluster plan (the BLAS-build analogue)."""
        centers = host.scene.center.cpu().numpy()
        self._planned = True
        if centers.shape[0] == 0:
            # All-mesh scene: no sphere sweep, so no sphere accel.
            self.cluster_plan = None
            return
        self.cluster_plan = clusters.build_plan_morton(
            centers, host.scene.radius.cpu().numpy(), max_members=32,
            device=self.device)

    def _counter_keys(self):
        c = self.cfg
        keys = ["wavefront_overflow_paths"]
        if c.restir_enabled:
            keys += ["lights_dropped", "lights_dropped_power_frac"]
            if c.restir.local_light_mode == "ReGIR_RIS":
                keys += ["regir_occupancy"]
        return keys

    def init_state(self, host: myscene.MySceneHost | None = None,
                   seed: int = 0) -> FrameState:
        if host is None:
            host = myscene.build(seed=seed, device=self.device)
        self.build_plan(host)
        c, dev = self.cfg, self.device
        return FrameState(
            frame_index=torch.zeros((), dtype=torch.int64, device=dev),
            bodies=host.bodies, scene=host.scene,
            reservoirs=restir.init_reservoirs(c.render_height,
                                              c.render_width, dev),
            prev_depth=torch.full((c.render_height, c.render_width), 1e8,
                                  device=dev),
            prev_normal=torch.zeros((c.render_height, c.render_width, 3),
                                    device=dev),
            prev_surface_rows=torch.zeros((1, 1, 7), device=dev),
            earth_gravity=torch.tensor(False, device=dev),
            star_gravity=torch.tensor(False, device=dev),
            counters={k: torch.zeros((), device=dev)
                      for k in self._counter_keys()})

    def default_camera_pose(self, host: myscene.MySceneHost | None = None
                            ) -> CameraPose:
        pos = host.camera_position if host else (0.0, 0.0, -15.0)
        fwd = host.camera_forward if host else (0.0, 0.0, 1.0)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=self.device)
        return CameraPose(position=f32(pos), forward=f32(fwd),
                          up=f32((0.0, 1.0, 0.0)))

    def reset_history(self, state: FrameState) -> FrameState:
        """m_resetHistory (App.cpp:667-679): clears the reservoirs."""
        c = self.cfg
        return dataclasses.replace(
            state,
            reservoirs=restir.init_reservoirs(c.render_height,
                                              c.render_width, self.device),
            prev_surface_rows=torch.zeros_like(state.prev_surface_rows))

    # -- per-frame ----------------------------------------------------------

    def _camera(self, state: FrameState, pose: CameraPose,
                prev_pose: CameraPose | None = None) -> camera_mod.Camera:
        c = self.cfg
        if c.jitter_enabled:
            jitter = self.jitter_table[state.frame_index
                                       % self.jitter_table.shape[0]]
        else:
            jitter = torch.zeros(2, device=self.device)
        aspect = c.render_width / c.render_height
        cam = camera_mod.make_camera(
            pose.position, pose.forward, pose.up,
            horizontal_fov_deg=c.horizontal_fov_deg, aspect=aspect,
            jitter=jitter, device=self.device)
        if prev_pose is not None:
            prev = camera_mod.make_camera(
                prev_pose.position, prev_pose.forward, prev_pose.up,
                horizontal_fov_deg=c.horizontal_fov_deg, aspect=aspect,
                device=self.device)
            cam = dataclasses.replace(
                cam, prev_position=prev.position, prev_right=prev.right,
                prev_up=prev.up, prev_forward=prev.forward)
        return cam

    # -- frame stages ---------------------------------------------------------

    def _stage_update(self, state: FrameState, pose: CameraPose, dt,
                      prev_pose: CameraPose | None = None):
        """Physics, scene pose refresh, camera and the per-frame accel
        (App.cpp:556-557,972; the TLAS-update analogue, App.cpp:605-608)."""
        if self.cfg.physics_enabled:
            bodies = physics.step(state.bodies, dt, state.earth_gravity,
                                  state.star_gravity)
        else:
            bodies = state.bodies
        if (state.scene.center.shape[0] == 0
                and state.scene.mesh_instances is not None):
            # All-mesh scene: the physics poses refit the mesh instances,
            # not the (empty) sphere table.
            scene = myscene.sync_mesh_pose(state.scene, bodies.position,
                                           bodies.rotation)
        else:
            scene = scene_mod.advance_pose(state.scene, bodies.position,
                                           bodies.rotation)
        cam = self._camera(state, pose, prev_pose)
        accel = None
        if self.cluster_plan is not None:
            accel = clusters.make_morton_accel(
                self.cluster_plan, scene.center, scene.radius,
                sort_origin=cam.position)
        return bodies, scene, cam, accel

    def _stage_gbuffer(self, scene, cam, accel):
        c = self.cfg
        return gbuffer.generate(scene, cam, c.render_width, c.render_height,
                                c.block_size, accel=accel)

    def _restir_prepare(self, scene, cam, frame_index):
        """Light preparation and the ReGIR grid (RTXDI.ixx:141-241 head)."""
        lights = light_mod.prepare(scene)
        grid = restir.build_regir_grid(lights, cam.position, self.cfg.restir,
                                       frame_index)
        return lights, grid

    def _restir_initial(self, gbuf, scene, lights, grid, frame_index, accel):
        c = self.cfg
        surface = restir.make_surface(gbuf)
        cur = restir.initial_sampling(surface, scene, lights, grid,
                                      c.restir, frame_index, c.block_size,
                                      accel=accel)
        return surface, cur

    def _restir_temporal(self, state, cur, surface, lights, gbuf, reset,
                         frame_index):
        c = self.cfg
        hist = state.reservoirs
        if reset:
            hist = restir.init_reservoirs(c.render_height, c.render_width,
                                          self.device)
        return restir.temporal_resampling(
            cur, hist, surface, lights, gbuf.motion, state.prev_depth,
            state.prev_normal, c.restir, frame_index)

    def _restir_spatial(self, cur, surface, lights, frame_index):
        return restir.spatial_resampling(cur, surface, lights,
                                         self.cfg.restir, frame_index)

    def _restir_final(self, cur, surface, scene, lights, accel):
        return restir.final_shading(cur, surface, scene, lights,
                                    self.cfg.block_size, accel=accel)

    def _pt_cfg(self) -> pathtrace.PathTraceConfig:
        c = self.cfg
        return pathtrace.PathTraceConfig(
            width=c.render_width, height=c.render_height, bounces=c.bounces,
            samples_per_pixel=c.samples_per_pixel,
            russian_roulette=c.russian_roulette,
            throughput_threshold=c.throughput_threshold,
            block_size=c.block_size, compact_from=c.compact_from)

    def _stage_trace(self, scene, cam, gbuf, di_total, frame_index, accel):
        return pathtrace.trace_image(
            scene, cam, self._pt_cfg(), frame_index, gbuf=gbuf,
            di_radiance=di_total, di_in_radiance=True, accel=accel)

    def _stage_taa(self, color):
        """No TAA on the ported path (the constructor refuses it); a render
        size other than the output size is resized bilinearly."""
        c = self.cfg
        if (c.output_height, c.output_width) != (c.render_height,
                                                 c.render_width):
            color = post.resize_bilinear(color, c.output_height,
                                         c.output_width)
        return color

    def _stage_postfx(self, color, dyn: DynamicSettings | None = None):
        """Sharpen + bloom + tone map (App.cpp:1498-1514), then the
        display-space chromatic aberration."""
        c = self.cfg
        if dyn is None:
            dyn = default_dynamic(c, self.device)
        if c.sharpen_enabled:
            color = post.sharpen(color, dyn.sharpness)
        if c.bloom_enabled:
            color = post.bloom(color, dyn.bloom_strength)
        color = post.tonemap(color, c.tone_map_operator, dyn.exposure,
                             hdr=c.hdr_enabled,
                             paper_white_nits=c.paper_white_nits,
                             color_rotation=c.hdr_color_rotation)
        return post.chromatic_aberration(color,
                                         c.chromatic_aberration_strength)

    def render_frame(self, state: FrameState, pose: CameraPose,
                     dt=1.0 / 60.0, prev_pose: CameraPose | None = None,
                     reset: bool = False,
                     dyn: DynamicSettings | None = None, _run=None):
        """One App::Tick (update + render + post).

        ``_run(name, fn, *args)`` wraps every frame-graph stage (the
        PIX-scoped-event seam, App.cpp:598); ``bench.bench_frame`` times
        stages through it. Returns (new_state, image (OH, OW, 3) in
        [0, 1])."""
        if self.cluster_plan is None and not self._planned:
            raise RuntimeError("call init_state or build_plan first")
        c = self.cfg
        run = _run if _run is not None else (lambda name, fn, *a: fn(*a))
        fi = state.frame_index

        bodies, scene, cam, accel = run(
            "update", lambda s, p: self._stage_update(s, p, dt, prev_pose),
            state, pose)
        gbuf = run("gbuffer", self._stage_gbuffer, scene, cam, accel)

        di_total = None
        reservoirs = state.reservoirs
        frame_counters = {}
        if c.restir_enabled:
            lights, grid = run(
                "restir_prepare",
                lambda s, cm: self._restir_prepare(s, cm, fi), scene, cam)
            surface, cur = run(
                "restir_initial",
                lambda g, s, li, gr, a: self._restir_initial(g, s, li, gr,
                                                             fi, a),
                gbuf, scene, lights, grid, accel)
            if c.restir.temporal_enabled:
                cur = run(
                    "restir_temporal",
                    lambda st, cu, su, li, g: self._restir_temporal(
                        st, cu, su, li, g, reset, fi),
                    state, cur, surface, lights, gbuf)
            if c.restir.spatial_enabled:
                cur = run(
                    "restir_spatial",
                    lambda cu, su, li: self._restir_spatial(cu, su, li, fi),
                    cur, surface, lights)
            di_diffuse, di_specular = run(
                "restir_final", self._restir_final, cur, surface, scene,
                lights, accel)
            di_total = di_diffuse + di_specular
            reservoirs = cur
            # MAX_LIGHTS cap accounting and ReGIR occupancy (the fraction
            # of grid slots holding a live reservoir).
            frame_counters["lights_dropped"] = lights.dropped_lights
            frame_counters["lights_dropped_power_frac"] = \
                lights.dropped_power_frac
            n_cells = c.restir.regir_cells_per_axis ** 3
            frame_counters["regir_occupancy"] = torch.mean(
                (grid.weight[:n_cells] > 0).to(torch.float32))

        out = run("trace",
                  lambda s, cm, g, di, a: self._stage_trace(s, cm, g, di, fi,
                                                            a),
                  scene, cam, gbuf, di_total, accel)
        color = run("taa", self._stage_taa, out.radiance)
        image = run("post", self._stage_postfx, color, dyn)

        frame_counters.update(out.counters)
        counters = {k: torch.as_tensor(frame_counters.get(k, 0.0),
                                       dtype=torch.float32,
                                       device=self.device)
                    for k in self._counter_keys()}
        new_state = FrameState(
            frame_index=state.frame_index + 1, bodies=bodies, scene=scene,
            reservoirs=reservoirs,
            prev_depth=torch.where(torch.isfinite(gbuf.linear_depth),
                                   gbuf.linear_depth, 1e8),
            prev_normal=out.primary_normal,
            prev_surface_rows=state.prev_surface_rows,
            earth_gravity=state.earth_gravity,
            star_gravity=state.star_gravity, counters=counters)
        return new_state, image

