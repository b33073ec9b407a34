"""The render pipeline: the frame orchestrator (port of
``drts_tpu/models/pipeline.py``).

``state', image = pipeline.render_frame(state, pose)`` runs one App::Tick
(App.cpp:144-643): physics step -> scene pose refresh -> per-frame Morton
accel -> G-buffer -> ReSTIR DI (light preparation, ReGIR grid, initial,
temporal, spatial, final shading) -> SHARC update (every
``sharc_update_period`` frames) -> path trace with the DI handoff and the
SHARC query -> denoise (ReBLUR, ReLAX or DLSS-RR's core) -> TAA upscale ->
sharpen -> bloom -> tone map -> debug view. History (reservoirs, previous
depth and normal, denoiser, TAA and SHARC state) is threaded through
``FrameState``; ``PipelineConfig()`` is the reference's default frame.

Every option of the reference's settings window renders: the thin lens
(``aperture_radius`` > 0: per-pixel aperture samples in the G-buffer) and
the focus distance (the current and the previous camera are built with
it), ``accel_mode="none"`` (no sphere accel: every sphere closest hit and
shadow ray goes through the brute-force kernel, B11), and every ReSTIR
mode of ``restir.ReSTIRConfig``; the constructor raises ValueError only
for names the reference does not know. With
``temporal_prev_surface="real"`` in a pairwise or raytraced temporal mode,
``FrameState.prev_surface_rows`` carries the previous G-buffer's
``restir.pack_prev_material`` rows. ``compact_from`` goes
unchanged to the path trace and the SHARC update trace (1 compacts and
sorts the bounce-1 wavefront too, the reference's all-mesh pipeline
bench). There is no counterpart of the reference's
``intersect.pallas_enabled()`` gate: the accel is built every frame and
every pass takes its kernel. An all-mesh scene (``myscene.as_mesh_scene``:
an empty sphere table) has no cluster plan and no accel: its physics poses
go to the mesh instances, whose per-call tables the mesh path builds
itself.

The SHARC cadence is decided on the host: ``FrameState.frame_count`` is a
Python int beside the device's ``frame_index``, so the skip frames read
nothing back from the card.

``render_frame(..., group=...)`` renders the frame sharded over the ranks
of a ``torch.distributed`` group (``drts_tpu_torch.parallel``): each rank
holds its shards of ``FrameState`` between frames (``placement``: the
frame buffers by rows, the SHARC cache by slot range, the rest whole),
renders its row band (a stage of a fixed footprint with a halo from its
neighbours, a history fetch at pixel + motion from that history gathered
for the stage), splats into its slot range and resolves it, and returns
its band of the image's output rows. The exchanges outside the stages
are the stages "gather_sharc_mirror", "reduce_trace_counters" and
"store_shards". Without a group the frame makes exactly the launches it
makes on one device.

``render_frame_graph()`` runs the frame as CUDA graph replays
(``FrameGraph``, drts_tpu_torch/graphs.py), the sharded frame too on an
NCCL group: its collectives are captured in the pieces with the kernels.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .. import backend, config as config_mod, graphs
from ..ops import (camera as camera_mod, debugviz, denoise, gbuffer,
                   light as light_mod, pathtrace, physics, post, restir,
                   sharc as sharc_mod, taa)
from ..parallel import mesh as mesh_mod
from ..utils import rng as rng_mod
from ..utils.checkpoint import leaves
from . import clusters, myscene, scene as scene_mod


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline topology, with the reference's names and defaults:
    ``PipelineConfig()`` is the reference's default frame (SHARC, ReBLUR,
    TAA at native resolution); ``from_settings`` derives it from the
    settings window's ``config.GraphicsSettings``."""
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
    sharc: sharc_mod.SHARCConfig = dataclasses.field(
        default_factory=sharc_mod.SHARCConfig)
    sharc_downscale: int = 4
    sharc_update_period: int = 2
    texture_bounces: int = 2

    @classmethod
    def from_settings(cls, s: config_mod.GraphicsSettings,
                      output_width: int | None = None,
                      output_height: int | None = None) -> "PipelineConfig":
        """The topology of `s` (the settings window's GraphicsSettings):
        the output size defaults to the settings' render size, and an
        upscaler other than None renders at ``taa.render_size_for`` of
        the super-resolution mode unless that mode is Native."""
        ow = output_width or s.render_width
        oh = output_height or s.render_height
        if (s.post.upscaler != config_mod.Upscaler.NONE
                and s.post.super_resolution_mode
                != config_mod.SuperResolutionMode.NATIVE):
            rw, rh = taa.render_size_for(ow, oh,
                                         s.post.super_resolution_mode.value)
        else:
            rw, rh = ow, oh
        r = s.restir_di
        return cls(
            output_width=ow, output_height=oh,
            render_width=rw, render_height=rh,
            restir_enabled=r.is_enabled,
            restir=restir.ReSTIRConfig(
                regir_cells_per_axis=r.regir_cells_per_axis,
                regir_cell_size=r.regir_cell_size,
                regir_build_samples=r.regir_build_samples,
                local_light_mode=r.local_light_mode.value,
                local_light_samples=r.local_light_samples,
                brdf_samples=r.brdf_samples,
                temporal_enabled=r.is_temporal_resampling_enabled,
                spatial_enabled=r.is_spatial_resampling_enabled,
                max_history=r.max_history_length,
                boiling_filter_strength=r.boiling_filter_strength,
                spatial_samples=r.spatial_samples,
                spatial_radius=r.spatial_radius,
                spatial_bias_correction=r.spatial_bias_correction,
                temporal_bias_correction=r.temporal_bias_correction,
                temporal_prev_surface=r.temporal_prev_surface,
                spatial_offset_mode=r.spatial_offset_mode),
            sharc_enabled=s.rtxgi == config_mod.RTXGITechnique.SHARC,
            sharc=sharc_mod.SHARCConfig(
                capacity_log2=s.sharc.capacity_log2,
                scene_scale=s.sharc.scene_scale,
                accumulation_frames=s.sharc.accumulation_frames,
                max_stale_frames=s.sharc.max_stale_frames,
                roughness_threshold=s.sharc.roughness_threshold,
                anti_firefly=s.sharc.is_anti_firefly_enabled),
            sharc_downscale=s.sharc.downscale_factor,
            bounces=s.raytracing.bounces,
            samples_per_pixel=s.raytracing.samples_per_pixel,
            russian_roulette=s.raytracing.is_russian_roulette_enabled,
            throughput_threshold=s.raytracing.throughput_threshold,
            denoiser=s.post.denoiser.value,
            denoiser_max_history=s.post.denoiser_max_history,
            denoiser_clamp_gamma=s.post.denoiser_clamp_gamma,
            denoiser_specular_virtual=s.post.denoiser_specular_virtual,
            upscaling=(rw, rh) != (ow, oh),
            bloom_enabled=s.post.is_bloom_enabled,
            bloom_strength=s.post.bloom_strength,
            sharpen_enabled=s.post.is_sharpening_enabled,
            sharpness=s.post.sharpness,
            chromatic_aberration_strength=(
                s.post.chromatic_aberration_strength),
            tone_map_operator=s.post.tone_map_operator.value,
            exposure=s.post.exposure,
            hdr_enabled=s.post.is_hdr_enabled,
            paper_white_nits=s.post.paper_white_nits,
            hdr_color_rotation=s.post.hdr_color_rotation.value,
            aperture_radius=s.camera.aperture_radius,
            focus_distance=s.camera.focus_distance,
            jitter_enabled=s.camera.is_jitter_enabled,
            horizontal_fov_deg=s.camera.horizontal_field_of_view,
        )


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
    """All cross-frame state, the reference's fields; ``frame_count`` is
    the host's copy of ``frame_index`` (the SHARC cadence reads it)."""
    frame_index: torch.Tensor        # scalar int64
    bodies: physics.RigidBodies
    scene: scene_mod.SphereScene
    denoiser: denoise.DenoiserState
    taa: taa.TAAState
    reservoirs: restir.Reservoirs
    prev_depth: torch.Tensor         # (RH, RW) previous linear depth
    prev_normal: torch.Tensor        # (RH, RW, 3) previous shading normal
    # (RH, RW, 7) restir.pack_prev_material rows of the previous frame for
    # the real previous surface; a (1, 1, 7) placeholder otherwise.
    prev_surface_rows: torch.Tensor
    sharc: sharc_mod.SHARCState
    earth_gravity: torch.Tensor      # scalar bool toggles
    star_gravity: torch.Tensor
    counters: dict = dataclasses.field(default_factory=dict)
    frame_count: int = 0


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


DENOISERS = ("None", "NRDReBLUR", "NRDReLAX", "DLSSRayReconstruction")
TAA_MODES = ("auto", "on", "off")
ACCEL_MODES = ("morton", "none")


def _check_supported(c: PipelineConfig) -> None:
    for name, value, allowed in (
            ("denoiser", c.denoiser, DENOISERS),
            ("taa_mode", c.taa_mode, TAA_MODES),
            ("taa_history_filter", c.taa_history_filter,
             taa.HISTORY_FILTERS),
            ("debug_view", c.debug_view, debugviz.MODES)):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got "
                             f"{value!r}")
    if c.accel_mode not in ACCEL_MODES:
        raise ValueError(f"accel_mode must be one of {ACCEL_MODES}, got "
                         f"{c.accel_mode!r}")
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
        if centers.shape[0] == 0 or self.cfg.accel_mode == "none":
            # All-mesh scene (no sphere sweep) or no accel wanted: the
            # sphere sweeps go through the brute-force kernel.
            self.cluster_plan = None
            return
        self.cluster_plan = clusters.build_plan_morton(
            centers, host.scene.radius.cpu().numpy(), max_members=32,
            device=self.device)

    def _use_real_prev_surface(self) -> bool:
        """Whether FrameState carries the previous frame's surface rows
        (the real previous surface of pairwise temporal reuse)."""
        c = self.cfg
        return (c.restir_enabled and c.restir.temporal_enabled
                and c.restir.temporal_bias_correction in ("pairwise",
                                                          "raytraced")
                and c.restir.temporal_prev_surface == "real")

    def _counter_keys(self):
        c = self.cfg
        keys = ["wavefront_overflow_paths"]
        if c.restir_enabled:
            keys += ["lights_dropped", "lights_dropped_power_frac"]
            if c.restir.local_light_mode == "ReGIR_RIS":
                keys += ["regir_occupancy"]
        if c.sharc_enabled:
            keys.append("sharc_splat_dropped_rows")
            for b in range(1, c.bounces + 1):
                keys += [f"sharc_hits_b{b}", f"sharc_queries_b{b}",
                         f"sharc_gate_b{b}", f"sharc_entry_b{b}"]
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
            denoiser=denoise.init_state(c.render_height, c.render_width,
                                        dev),
            taa=taa.init_state(c.output_height, c.output_width, dev),
            reservoirs=restir.init_reservoirs(c.render_height,
                                              c.render_width, dev),
            prev_depth=torch.full((c.render_height, c.render_width), 1e8,
                                  device=dev),
            prev_normal=torch.zeros((c.render_height, c.render_width, 3),
                                    device=dev),
            prev_surface_rows=torch.zeros(
                (c.render_height, c.render_width, 7)
                if self._use_real_prev_surface() else (1, 1, 7),
                device=dev),
            sharc=sharc_mod.init_state(c.sharc, dev),
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
        """m_resetHistory (App.cpp:667-679): clears the denoiser and TAA
        history, the reservoirs and the SHARC cache."""
        c, dev = self.cfg, self.device
        return dataclasses.replace(
            state,
            denoiser=denoise.init_state(c.render_height, c.render_width,
                                        dev),
            taa=taa.init_state(c.output_height, c.output_width, dev),
            reservoirs=restir.init_reservoirs(c.render_height,
                                              c.render_width, dev),
            prev_surface_rows=torch.zeros_like(state.prev_surface_rows),
            sharc=sharc_mod.init_state(c.sharc, dev))

    # -- per-frame ----------------------------------------------------------

    def _camera(self, state: FrameState, pose: CameraPose,
                prev_pose: CameraPose | None = None) -> camera_mod.Camera:
        c = self.cfg
        if c.jitter_enabled:
            # A gather on the device (indexing by a 0-d tensor can read it
            # back to the host).
            jitter = torch.index_select(
                self.jitter_table, 0,
                (state.frame_index % self.jitter_table.shape[0]).reshape(1)
            )[0]
        else:
            jitter = torch.zeros(2, device=self.device)
        aspect = c.render_width / c.render_height
        # |forward| = the focus distance, for the previous camera too (its
        # frame scales the motion vectors' projection).
        cam = camera_mod.make_camera(
            pose.position, pose.forward, pose.up,
            horizontal_fov_deg=c.horizontal_fov_deg, aspect=aspect,
            jitter=jitter, aperture_radius=c.aperture_radius,
            focus_distance=c.focus_distance, device=self.device)
        if prev_pose is not None:
            prev = camera_mod.make_camera(
                prev_pose.position, prev_pose.forward, prev_pose.up,
                horizontal_fov_deg=c.horizontal_fov_deg, aspect=aspect,
                focus_distance=c.focus_distance, device=self.device)
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

    def _stage_gbuffer(self, scene, cam, accel, frame_index=0, rows=None):
        c = self.cfg
        return gbuffer.generate(scene, cam, c.render_width, c.render_height,
                                c.block_size, accel=accel,
                                thin_lens=c.aperture_radius > 0.0,
                                frame_index=frame_index, rows=rows)

    def _restir_prepare(self, scene, cam, frame_index):
        """Light preparation and the ReGIR grid (RTXDI.ixx:141-241 head);
        the grid exists in ReGIR_RIS mode only (RTXDI.ixx:218)."""
        lights = light_mod.prepare(scene)
        grid = None
        if self.cfg.restir.local_light_mode == "ReGIR_RIS":
            grid = restir.build_regir_grid(lights, cam.position,
                                           self.cfg.restir, frame_index)
        return lights, grid

    def _restir_initial(self, gbuf, scene, lights, grid, frame_index, accel,
                        row0=0):
        c = self.cfg
        surface = restir.make_surface(gbuf)
        cur = restir.initial_sampling(surface, scene, lights, grid,
                                      c.restir, frame_index, c.block_size,
                                      accel=accel, row0=row0)
        return surface, cur

    def _restir_temporal(self, state, cur, surface, lights, gbuf, reset,
                         frame_index, scene=None, accel=None, cam=None,
                         band=None):
        c = self.cfg
        hist = state.reservoirs
        if isinstance(reset, torch.Tensor):
            # A device flag (the graph frame's): the fresh history where it
            # is set, selected on the device.
            fresh = dict(leaves(restir.init_reservoirs(
                state.prev_depth.shape[0], c.render_width, self.device)))
            hist = mesh_mod.map_leaves(
                lambda p, t: torch.where(reset, fresh[p], t), hist)
        elif reset:
            hist = restir.init_reservoirs(state.prev_depth.shape[0],
                                          c.render_width, self.device)
        prev_material = prev_cam_pos = None
        if self._use_real_prev_surface():
            prev_material = state.prev_surface_rows
            if isinstance(reset, torch.Tensor):
                prev_material = torch.where(reset, 0.0, prev_material)
            elif reset:
                prev_material = torch.zeros_like(prev_material)
            prev_cam_pos = cam.prev_position if cam is not None else None
        return restir.temporal_resampling(
            cur, hist, surface, lights, gbuf.motion, state.prev_depth,
            state.prev_normal, c.restir, frame_index, scene=scene,
            accel=accel, block_size=c.block_size,
            prev_material=prev_material, prev_camera_position=prev_cam_pos,
            band=band)

    def _restir_spatial(self, cur, surface, lights, frame_index,
                        frame_count, scene=None, accel=None, band=None,
                        offsets=None):
        return restir.spatial_resampling(
            cur, surface, lights, self.cfg.restir, frame_index, scene=scene,
            accel=accel, block_size=self.cfg.block_size,
            frame_count=frame_count, band=band, offsets=offsets)

    def shared_offsets(self, frame_count: int) -> torch.Tensor | None:
        """The shared spatial offsets of frame `frame_count` as a
        (spatial_samples, 2) int64 tensor of (dx, dy) on the host
        (``restir.shared_offsets``), or None where the frame takes none."""
        r = self.cfg.restir
        if not (self.cfg.restir_enabled and r.spatial_enabled
                and r.spatial_offset_mode == "shared"):
            return None
        return torch.tensor(restir.shared_offsets(frame_count, r),
                            dtype=torch.int64)

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
            block_size=c.block_size, compact_from=c.compact_from,
            texture_bounces=c.texture_bounces,
            sharc_query_from=c.sharc_query_from)

    def _stage_sharc(self, state, scene, cam, di_total, accel, frame_index,
                     sh=None):
        """SHARC update trace + resolve at the downscaled size
        (Raytracing.ixx:114-148), every sharc_update_period frames by the
        host's frame count; a skip frame keeps the cache and counts zero
        dropped rows. Sharded (`sh`): this rank's band of the downscaled
        rows (the DI resized to them from a halo), the splat
        reduce-scattered into the slot ranges, this rank's range resolved;
        the cache comes back as the range."""
        c = self.cfg
        sharc_state = state.sharc
        if sh is not None:
            sharc_state = sh.slot_range(sharc_state)
        if state.frame_count % max(c.sharc_update_period, 1) != 0:
            return sharc_state, {"sharc_splat_dropped_rows": torch.zeros(
                (), dtype=torch.float32, device=self.device)}
        su_cfg = dataclasses.replace(
            self._pt_cfg(),
            width=max(1, c.render_width // c.sharc_downscale),
            height=max(1, c.render_height // c.sharc_downscale))
        band = di_small = slots = None
        if sh is not None:
            band = mesh_mod.Band.of(sh.group, su_cfg.height)
            slots = sh.slots
            if di_total is not None:
                di_small = post.resize_band(di_total, sh.render, band,
                                            su_cfg.width)
        return pathtrace.sharc_update_trace(
            scene, cam, sharc_state, c.sharc, su_cfg, frame_index,
            di_radiance=di_total, accel=accel, band=band, slots=slots,
            di_small=di_small)

    def _stage_trace(self, scene, cam, gbuf, sharc_state, di_total,
                     frame_index, accel, rows=None):
        c = self.cfg
        return pathtrace.trace_image(
            scene, cam, self._pt_cfg(), frame_index, gbuf=gbuf,
            sharc_state=sharc_state if c.sharc_enabled else None,
            sharc_cfg=c.sharc if c.sharc_enabled else None,
            di_radiance=di_total, di_in_radiance=c.denoiser == "None",
            accel=accel, rows=rows)

    def _reduce_trace(self, out, group):
        """The sharded trace's counters, rays and spill waves summed over
        the ranks (its pixels stay the band's). The waves are summed as the
        device count ``spill_count``, which a caller that reports them
        reads: no host read inside the frame; ``spill_waves`` stays this
        rank's own."""
        sums = mesh_mod.all_reduce_counters(
            {**out.counters, "rays_traced": out.rays_traced,
             "spill_waves": out.spill_count}, group)
        spill_count = sums.pop("spill_waves")
        rays_traced = sums.pop("rays_traced")
        return dataclasses.replace(out, rays_traced=rays_traced,
                                   counters=sums, spill_count=spill_count)

    def _stage_denoise(self, state, out, gbuf, cam, di_diffuse, di_specular,
                       reset, band=None):
        """Demodulated denoise + compose (Raytracing.hlsl:400-413 +
        NRDComposition). Returns (denoiser state, colour, the TAA
        confidence of DLSS-RR or None). On a band, `state.denoiser` holds
        its rows (the history fetch gathers the leaves it reads)."""
        # Indirect radiance split into demodulated diffuse and specular
        # channels, plus the direct light per channel.
        indirect = torch.clamp(out.radiance - out.primary_radiance, min=0.0)
        hd = torch.where(torch.isfinite(out.hit_distance), out.hit_distance,
                         0.0)
        diffuse_chan = torch.where(out.is_diffuse[..., None], indirect, 0.0)
        specular_chan = torch.where(out.is_diffuse[..., None], 0.0, indirect)
        if di_diffuse is not None:
            diffuse_chan = diffuse_chan + di_diffuse
            specular_chan = specular_chan + di_specular
        d_diff, d_spec = denoise.demodulate(diffuse_chan, specular_chan,
                                            out.primary_albedo,
                                            out.primary_f_env)
        diff4 = torch.cat([d_diff, hd[..., None]], dim=-1)
        spec4 = torch.cat([d_spec, hd[..., None]], dim=-1)
        c = self.cfg
        tuned = dict(max_accumulated_frames=c.denoiser_max_history,
                     clamp_gamma=c.denoiser_clamp_gamma,
                     specular_virtual=c.denoiser_specular_virtual)
        if c.denoiser == "NRDReLAX":
            den_fn, den_cfg = denoise.denoise_relax, denoise.DenoiseConfig(
                **tuned)
        elif c.denoiser == "DLSSRayReconstruction":
            # Joint mode: a lighter spatial core; TAA gets the denoiser's
            # history confidence.
            den_fn, den_cfg = denoise.denoise_relax, denoise.DenoiseConfig(
                relax_atrous_iterations=3, **tuned)
        else:
            den_fn, den_cfg = denoise.denoise, denoise.DenoiseConfig(**tuned)
        rw, rh = c.render_width, c.render_height

        def prev_px_of(xv):
            prev_ndc, _ = camera_mod.project_to_ndc(cam, xv, previous=True)
            cur_ndc, _ = camera_mod.project_to_ndc(cam, xv, previous=False)
            return (camera_mod.ndc_to_pixel(prev_ndc, rw, rh),
                    camera_mod.ndc_to_pixel(cur_ndc, rw, rh))

        motion_spec = denoise.virtual_specular_motion(
            gbuf.motion, out.primary_position, gbuf.ray_direction,
            out.hit_distance, prev_px_of)
        den_state, f_diff, f_spec = den_fn(
            state.denoiser, diff4, spec4, gbuf.motion, out.primary_normal,
            gbuf.linear_depth, out.primary_valid, gbuf.mat.roughness, reset,
            den_cfg, motion_specular=motion_spec, band=band)
        color = denoise.compose(out.primary_radiance, f_diff, f_spec,
                                out.primary_albedo, out.primary_f_env,
                                out.primary_valid)
        confidence = (den_state.history_length / 30.0
                      if c.denoiser == "DLSSRayReconstruction" else None)
        return den_state, color, confidence

    def _stage_taa(self, state, color, gbuf, cam, reset, confidence=None,
                   sh=None):
        """TAA upscale (the DLSS-SR / XeSS slot, App.cpp:1644-1708); with
        no TAA, a render size other than the output size is resized
        bilinearly. Sharded (`sh`): the render band in, the output band
        out (``taa.upscale``)."""
        c = self.cfg
        taa_state = state.taa
        use_taa = {"auto": c.upscaling or c.denoiser != "None",
                   "on": True, "off": False}[c.taa_mode]
        if use_taa:
            taa_state, color = taa.upscale(
                state.taa, color, gbuf.motion, cam.jitter, c.output_height,
                c.output_width, reset,
                cfg=taa.TAAConfig(history_filter=c.taa_history_filter,
                                  clip_gamma=c.taa_clip_gamma,
                                  clip_gamma_motion=c.taa_clip_gamma_motion,
                                  clip_motion_px=c.taa_clip_motion_px,
                                  blend_alpha=c.taa_blend_alpha),
                confidence=confidence,
                band=sh.render if sh is not None else None,
                out_band=sh.output if sh is not None else None)
        elif (c.output_height, c.output_width) != (c.render_height,
                                                   c.render_width):
            color = self._to_output(color, sh)
        return taa_state, color

    def _to_output(self, img, sh=None):
        """A render-size image resized to the output size (bilinear), as
        the output band's rows of the render band's on the sharded frame."""
        c = self.cfg
        if sh is None:
            return post.resize_bilinear(img, c.output_height, c.output_width)
        return post.resize_band(img, sh.render, sh.output, c.output_width)

    def _stage_postfx(self, color, dyn: DynamicSettings | None = None,
                      band=None):
        """Sharpen + bloom + tone map (App.cpp:1498-1514), then the
        display-space chromatic aberration; on an output band, each
        neighbour-reading pass with its halo."""
        c = self.cfg
        if dyn is None:
            dyn = default_dynamic(c, self.device)
        if c.sharpen_enabled:
            color = post.sharpen(color, dyn.sharpness, band)
        if c.bloom_enabled:
            color = post.bloom(color, dyn.bloom_strength, band=band)
        color = post.tonemap(color, c.tone_map_operator, dyn.exposure,
                             hdr=c.hdr_enabled,
                             paper_white_nits=c.paper_white_nits,
                             color_rotation=c.hdr_color_rotation)
        return post.chromatic_aberration(
            color, c.chromatic_aberration_strength, band)

    def _stage_post(self, state, color, gbuf, cam, reset, confidence=None,
                    dyn: DynamicSettings | None = None):
        """TAA upscale + sharpen, bloom and tone map in one call
        (PostProcessGraphics, App.cpp:1460-1525); render_frame runs the
        two halves as the stages "taa" and "post"."""
        taa_state, color = self._stage_taa(state, color, gbuf, cam, reset,
                                           confidence)
        return taa_state, self._stage_postfx(color, dyn)

    def _stage_debug(self, image, gbuf, cam, grid, den_state, sh=None):
        """The diagnostic views (DIFinalShading.hlsl:69-75,
        Raytracing.hlsl:279-284, App.cpp:1522-1524)."""
        c = self.cfg
        surf = gbuf.surf
        if (c.debug_view == "ReGIRCells" and c.restir_enabled
                and grid is not None):
            dbg = debugviz.regir_cells(grid, surf.position, surf.valid,
                                       c.restir.regir_cells_per_axis)
            return self._to_output(dbg, sh)
        if c.debug_view == "SHARC" and c.sharc_enabled:
            front = torch.where(surf.is_front_face[..., None],
                                surf.geometric_normal, -surf.geometric_normal)
            dbg = debugviz.sharc_voxels(surf.position, front, cam.position,
                                        surf.valid, c.sharc)
            return self._to_output(dbg, sh)
        if c.debug_view == "NRDValidation" and c.denoiser != "None":
            resize = None
            if (c.output_height, c.output_width) != (c.render_height,
                                                     c.render_width):
                resize = lambda x: self._to_output(x, sh)  # noqa: E731
            return debugviz.validation_overlay(
                image, den_state.history_length, resize=resize)
        return image

    # -- the sharded frame -------------------------------------------------

    def placement(self, state: FrameState, n: int) -> dict:
        """{dotted path: mesh.ROWS | SLOTS | REPLICATED} of `state` on n
        ranks: ``mesh.frame_state_placement`` of the one-device state's
        shapes (`state` may hold either them or a rank's shards), with the
        render and output heights and the SHARC capacity. The frame
        buffers (denoiser, TAA, reservoirs, previous depth, normal and
        surface rows, SHARC) follow the rule; the scene, physics,
        toggles and counters stay replicated whatever their shapes."""
        c = self.cfg
        cap = 1 << c.sharc.capacity_log2
        rows_of = {"taa": c.output_height, "sharc": cap}
        for name in _RENDER_BUFFERS:
            rows_of[name] = c.render_height
        if not self._use_real_prev_surface():
            del rows_of["prev_surface_rows"]   # the (1, 1, 7) placeholder

        def one_device(path, leaf):
            rows = rows_of.get(path.split(".")[0])
            if rows is None:
                return leaf
            return torch.empty((rows,) + tuple(leaf.shape[1:]),
                               dtype=leaf.dtype, device="meta")
        kinds = mesh_mod.frame_state_placement(
            mesh_mod.map_leaves(one_device, state),
            (c.render_height, c.output_height), (cap,), n)
        return {p: k if p.split(".")[0] in rows_of else mesh_mod.REPLICATED
                for p, k in kinds.items()}

    def shard_state(self, state: FrameState, group) -> FrameState:
        """A one-device state cut to this rank's shards (``placement``)."""
        return mesh_mod.shard_state(
            state, group, self.placement(state, dist.get_world_size(group)))

    def gather_state(self, state: FrameState, group) -> FrameState:
        """The one-device state from the ranks' shards, on every rank."""
        return mesh_mod.gather_state(
            state, group, self.placement(state, dist.get_world_size(group)))

    def _shards(self, state, group) -> "_Shards":
        c = self.cfg
        n = dist.get_world_size(group)
        return _Shards(
            group=group, placement=self.placement(state, n),
            render=mesh_mod.Band.of(group, c.render_height),
            output=mesh_mod.Band.of(group, c.output_height),
            slots=mesh_mod.Band.of(group, 1 << c.sharc.capacity_log2))

    def render_frame(self, state: FrameState, pose: CameraPose,
                     dt=1.0 / 60.0, prev_pose: CameraPose | None = None,
                     reset: bool = False,
                     dyn: DynamicSettings | None = None, _run=None,
                     group=None, offsets=None):
        """One App::Tick (update + render + post).

        ``_run(name, fn, *args)`` wraps every frame-graph stage (the
        PIX-scoped-event seam, App.cpp:598); ``bench.bench_frame`` times
        stages through it. With a ``group`` (every rank of it calls with
        its shards of the same state, or the whole one-device state) the
        frame is sharded (module docstring): it returns this rank's
        shards of the new state (``placement``) and its band of the
        image's output rows. ``offsets`` (the graph frame's device input)
        are the shared spatial offsets of this frame (``shared_offsets``),
        read on the device; without, the host's frame count gives them.
        Returns (new_state, image (OH, OW, 3) in [0, 1])."""
        if self.cluster_plan is None and not self._planned:
            raise RuntimeError("call init_state or build_plan first")
        c = self.cfg
        run = _run if _run is not None else (lambda name, fn, *a: fn(*a))
        fi = state.frame_index
        sh = band = rows = out_band = None
        if group is not None:
            sh = self._shards(state, group)
            band, out_band, rows = sh.render, sh.output, sh.render.span()
            state = sh.band_rows(state)

        bodies, scene, cam, accel = run(
            "update", lambda s, p: self._stage_update(s, p, dt, prev_pose),
            state, pose)
        gbuf = run("gbuffer", lambda s, cm, a: self._stage_gbuffer(
            s, cm, a, fi, rows), scene, cam, accel)

        di_total = di_diffuse = di_specular = grid = None
        reservoirs = state.reservoirs
        frame_counters = {}
        if c.restir_enabled:
            lights, grid = run(
                "restir_prepare",
                lambda s, cm: self._restir_prepare(s, cm, fi), scene, cam)
            surface, cur = run(
                "restir_initial",
                lambda g, s, li, gr, a: self._restir_initial(
                    g, s, li, gr, fi, a, rows[0] if rows else 0),
                gbuf, scene, lights, grid, accel)
            if c.restir.temporal_enabled:
                cur = run(
                    "restir_temporal",
                    lambda st, cu, su, li, g, s2, a2, cm:
                    self._restir_temporal(st, cu, su, li, g, reset, fi, s2,
                                          a2, cm, band),
                    state, cur, surface, lights, gbuf, scene, accel, cam)
            if c.restir.spatial_enabled:
                cur = run(
                    "restir_spatial",
                    lambda cu, su, li, s2, a2: self._restir_spatial(
                        cu, su, li, fi, state.frame_count, s2, a2, band,
                        offsets),
                    cur, surface, lights, scene, accel)
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
            if grid is not None:
                n_cells = c.restir.regir_cells_per_axis ** 3
                frame_counters["regir_occupancy"] = torch.mean(
                    (grid.weight[:n_cells] > 0).to(torch.float32))

        # SHARC: the update pass at the downscaled size, then the main
        # trace queries the fresh cache (Raytracing.ixx:114-148); sharded,
        # through the whole query mirror, gathered once.
        sharc_state = query = state.sharc
        if c.sharc_enabled:
            sharc_state, sharc_counters = run(
                "sharc_update",
                lambda st, s, cm, di, a: self._stage_sharc(st, s, cm, di, a,
                                                           fi, sh),
                state, scene, cam, di_total, accel)
            frame_counters.update(sharc_counters)
            query = sharc_state
            if sh is not None:
                query = run("gather_sharc_mirror", sharc_mod.query_mirror,
                            sharc_state, sh.slots)

        out = run("trace",
                  lambda s, cm, g, sh_, di, a: self._stage_trace(
                      s, cm, g, sh_, di, fi, a, rows),
                  scene, cam, gbuf, query, di_total, accel)
        if sh is not None:
            out = run("reduce_trace_counters",
                      lambda o: self._reduce_trace(o, group), out)

        den_state, confidence = state.denoiser, None
        if c.denoiser != "None":
            den_state, color, confidence = run(
                "denoise",
                lambda st, o, g, cm, dd, ds: self._stage_denoise(
                    st, o, g, cm, dd, ds, reset, band),
                state, out, gbuf, cam, di_diffuse, di_specular)
        else:
            color = out.radiance
        taa_state, color = run(
            "taa", lambda st, cl, g, cm, cf: self._stage_taa(
                st, cl, g, cm, reset, cf, sh),
            state, color, gbuf, cam, confidence)
        image = run("post", lambda cl, d: self._stage_postfx(cl, d, out_band),
                    color, dyn)
        if c.debug_view != "None":
            image = self._stage_debug(image, gbuf, cam, grid, den_state, sh)

        frame_counters.update(out.counters)
        counters = {k: (frame_counters[k].to(torch.float32)
                        if k in frame_counters
                        else torch.zeros((), device=self.device))
                    for k in self._counter_keys()}
        new_state = FrameState(
            frame_index=state.frame_index + 1, bodies=bodies, scene=scene,
            denoiser=den_state, taa=taa_state, reservoirs=reservoirs,
            prev_depth=torch.where(torch.isfinite(gbuf.linear_depth),
                                   gbuf.linear_depth, 1e8),
            prev_normal=out.primary_normal,
            prev_surface_rows=(restir.pack_prev_material(gbuf)
                               if self._use_real_prev_surface()
                               else state.prev_surface_rows),
            sharc=sharc_state,
            earth_gravity=state.earth_gravity,
            star_gravity=state.star_gravity, counters=counters,
            frame_count=state.frame_count + 1)
        if sh is not None:
            new_state = run("store_shards", sh.at_rest, new_state)
        return new_state, image

    def render_frame_graph(self) -> "FrameGraph":
        """The counterpart of the reference's ``render_frame_jit``: a
        callable ``(state, pose, dt, prev_pose=None, reset=False,
        dyn=None) -> (state, image)`` that runs each frame as CUDA graph
        replays (``FrameGraph``)."""
        return FrameGraph(self)


def graph_refusal(group, device) -> str | None:
    """Why a frame on `device` has no graph form, or None. The graphs hold
    every one-device frame and the sharded frame on an NCCL group, whose
    collectives the capture records; on CPU tensors any group runs the
    pieces eagerly (``graphs.run_pieces``). A gloo group on CUDA tensors
    is refused: gloo moves them through the host, which a capture cannot
    hold."""
    if group is None or torch.device(device).type != "cuda":
        return None
    backend_name = dist.get_backend(group)
    if backend_name == "nccl":
        return None
    return (f"a {backend_name} group on CUDA tensors (its collectives go "
            f"through the host; the graph frame takes NCCL)")


class FrameGraph:
    """``RenderPipeline.render_frame`` as CUDA graphs (see graphs.py).

    On CUDA tensors the first call captures one variant per phase of the
    cycle (the SHARC cadence: an update and a skip frame; without SHARC
    two alike frames), each after one eager warm-up frame on a side
    stream, all in one memory pool, and every call replays the variant of
    its state's ``frame_count``. ``dt``, ``reset``, the poses, the
    dynamic settings and the shared spatial offsets are device inputs the
    call writes before the replay (``reset`` is a device flag: the history
    selects its fresh value on the device; ``prev_pose=None`` is the pose
    itself, which the eager frame equals bit for bit; the offsets are
    computed on the host from the state's ``frame_count``, as the eager
    frame computes them).

    The state ping-pongs: each phase reads the buffers the phase before
    it wrote (its graph's outputs), and the last phase of the cycle copies
    its new state into the first phase's inputs inside its graph (one
    device copy of the state a cycle). A call copies into the inputs only
    a state it did not return (the first frame, a resume, a state from
    elsewhere). The returned image lives until the next call, the
    returned state until the call after it (each phase owns its buffers):
    clone what you keep longer.

    With a `group` the frame is the sharded one (``render_frame(group=)``):
    the capture records its NCCL collectives (halos, gathers, the SHARC
    splat's reduce-scatter, the counters' all-reduce) in every piece but
    the spill waves, which issue none, so each rank keeps its own spill
    decision, as on one device. A call takes the rank's shards or the
    one-device state (cut to the shards first), and returns the rank's
    shards and its band of the image's output rows. The callable keeps
    the group of its first call.

    On CPU tensors a call runs the eager frame with the same inputs as
    the pieces the capture would make (``graphs.run_pieces``). Raises
    ValueError for a frame without a graph form (``graph_refusal``: a
    gloo group on the card), a call with another group than the first's,
    or a global changed since the capture (``graphs.Choices``), and
    graphs.CaptureError when a capture fails; there is no eager fallback
    on the card. ``stats`` (graphs.GraphStats) counts frames, spill
    waves, host launches and the kernels' launches."""

    def __init__(self, pipe: RenderPipeline):
        self.pipe = pipe
        c = pipe.cfg
        period = max(c.sharc_update_period, 1) if c.sharc_enabled else 1
        self.cycle = period if period >= 2 else 2
        self.stats = graphs.GraphStats()
        self._dyn = default_dynamic(c, pipe.device)
        self._inputs = None     # graphs.Inputs: poses, dt, reset, dyn
        self._states = []       # each phase's input state
        self._frames = []       # each phase's graphs.Captured
        self._choices = graphs.Choices()
        self._group = _NO_CALL  # the group of the first call

    def _check(self, state, group):
        why = graph_refusal(group, state.frame_index.device)
        if why is not None:
            raise ValueError(f"no graph form of this frame: {why}")
        if self._group is _NO_CALL:
            self._group = group
        elif group is not self._group:
            raise ValueError("the frame was made for another group (or "
                             "none); make a new callable")
        self._choices.check(state.scene)

    @staticmethod
    def _device_inputs(inp, dev):
        """The call's inputs as the frame reads them: dt and reset as 0-d
        device tensors, the offsets on the device."""
        def as_dev(x, dtype):
            if isinstance(x, torch.Tensor):
                return x.to(device=dev, dtype=dtype)
            return torch.full((), x, dtype=dtype, device=dev)
        out = dict(inp, dt=as_dev(inp["dt"], torch.float32),
                   reset=as_dev(inp["reset"], torch.bool))
        if inp["offsets"] is not None:
            out["offsets"] = inp["offsets"].to(dev)
        return out

    def _run(self, state, inp):
        return self.pipe.render_frame(
            state, inp["pose"], inp["dt"], prev_pose=inp["prev_pose"],
            reset=inp["reset"], dyn=inp["dyn"], offsets=inp["offsets"],
            group=self._group)

    def __call__(self, state: FrameState, pose: CameraPose,
                 dt=1.0 / 60.0, prev_pose: CameraPose | None = None,
                 reset=False, dyn: DynamicSettings | None = None,
                 group=None):
        self._check(state, group)
        if group is not None:
            # The shards as they rest between frames (the captured
            # buffers' shapes).
            state = self.pipe._shards(state, group).at_rest(state)
        dev = state.frame_index.device
        # A missing prev_pose is the pose; a missing dyn the defaults.
        inp = {"pose": pose,
               "prev_pose": prev_pose if prev_pose is not None else pose,
               "dt": dt, "reset": reset,
               "dyn": dyn if dyn is not None else self._dyn,
               "offsets": self.pipe.shared_offsets(state.frame_count)}
        if not graphs.on_card(dev):
            dev_inp = self._device_inputs(inp, dev)
            (new_state, image), waves = graphs.run_pieces(
                lambda: self._run(state, dev_inp))
            self.stats.frames += 1
            self.stats.spill_waves += waves
            return new_state, image
        if not self._frames:
            self._capture(state, self._device_inputs(inp, dev))
        phase = state.frame_count % self.cycle
        # The frame writes its counters and never reads them: the inputs
        # take the captured ones (a static change can change their keys).
        state = dataclasses.replace(state,
                                    counters=self._states[phase].counters)
        writes = self._inputs.write(inp)
        writes += graphs.write_tree(self._states[phase], state)
        before = self.stats.host_launches
        self.stats.host_launches += writes
        self._frames[phase].replay(self.stats)
        self.stats.last_host_launches = self.stats.host_launches - before
        new_state, image = self._frames[phase].outputs
        return dataclasses.replace(new_state,
                                   frame_count=state.frame_count + 1), image

    def _capture(self, state, inp):
        """Warm up and capture every phase, in cycle order, in one pool."""
        self._inputs = graphs.Inputs(inp)
        state = dataclasses.replace(state, counters={
            k: torch.zeros((), device=self.pipe.device)
            for k in self.pipe._counter_keys()})
        first = dataclasses.replace(graphs.clone_tree(state), frame_count=0)
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream()
        ins = first
        for phase in range(self.cycle):
            ins = dataclasses.replace(ins, frame_count=phase)
            graphs.write_tree(ins, state)
            last = phase == self.cycle - 1

            def frame(ins=ins, last=last):
                new_state, image = self._run(ins, self._inputs.tree)
                if last:
                    # Close the cycle: the next phase 0 reads `first`.
                    graphs.write_tree(first, new_state)
                    new_state = first
                return new_state, image

            graphs.warm_up(lambda ins=ins: self._run(ins, self._inputs.tree),
                           stream)
            captured = graphs.Captured.capture(frame, pool, stream)
            self.stats.captured(phase, captured)
            self._states.append(ins)
            self._frames.append(captured)
            ins = captured.outputs[0]


# FrameGraph's group before its first call.
_NO_CALL = object()

# The FrameState fields of render-height rows (``RenderPipeline.placement``).
_RENDER_BUFFERS = ("denoiser", "reservoirs", "prev_depth", "prev_normal",
                   "prev_surface_rows")


@dataclasses.dataclass(frozen=True)
class _Shards:
    """One rank's view of the sharded frame: its group, the state's
    placement and its render-row, output-row and SHARC-slot bands."""
    group: object
    placement: dict
    render: mesh_mod.Band
    output: mesh_mod.Band
    slots: mesh_mod.Band

    def _band_of(self, path):
        """The band of a frame buffer's leaf (None: not a buffer)."""
        top = path.split(".")[0]
        if top == "taa":
            return self.output
        if top == "sharc":
            return self.slots
        return self.render if top in _RENDER_BUFFERS else None

    def band_rows(self, state):
        """`state` with each per-row frame buffer as this rank's rows: cut
        where it holds the whole frame (a replicated buffer, or the
        one-device state), as it is where it holds the rank's band. The
        stages read history at pixel + motion through ``Band.full``; the
        SHARC stage takes its slot range itself (``slot_range``)."""
        def cut(path, leaf):
            b = self._band_of(path)
            if b is None or b is self.slots or leaf.ndim < 2 \
                    or leaf.shape[0] != b.height:
                return leaf
            return leaf[b.start:b.end]
        return mesh_mod.map_leaves(cut, state)

    def slot_range(self, sharc_state):
        """The SHARC cache as this rank's slot range."""
        b = self.slots
        return mesh_mod.map_tensors(
            lambda t: t[b.start:b.end] if t.shape[0] == b.height else t,
            sharc_state)

    def at_rest(self, state):
        """The new state as the placement keeps it between frames: per-row
        and per-slot leaves as this rank's band or range; a frame buffer
        the rule replicates (its height does not divide by n), computed by
        bands, gathered whole (one all-gather per band kind, in a fixed
        order)."""
        keep, gather = {}, {}
        for path, leaf in leaves(state):
            b = self._band_of(path)
            if b is None or not isinstance(leaf, torch.Tensor) \
                    or leaf.ndim == 0:
                continue
            if self.placement.get(path) != mesh_mod.REPLICATED:
                if leaf.shape[0] == b.height and b.rows != b.height:
                    keep[path] = leaf[b.start:b.end]
            elif leaf.shape[0] == b.rows and b.rows != b.height:
                gather.setdefault(id(b), []).append((path, leaf))
        for b in (self.render, self.output, self.slots):
            got = gather.get(id(b), [])
            if got:
                full = b.gather_tree([leaf for _, leaf in got])
                keep.update({p: t for (p, _), t in zip(got, full)})
        return mesh_mod.map_leaves(lambda p, t: keep.get(p, t), state)
