"""Configuration: hierarchical settings with min/max clamping and a JSON
round trip (port of ``drts_tpu/config.py``).

The reference's config layer (MyAppData.h:133-446 and JSONHelpers.h): the
same defaults, the same clamp-on-load ``check()`` and the same
enum-by-name serialization, so a settings file written by either package
reads the same in the other. Pure Python: no torch here.
``models/pipeline.PipelineConfig.from_settings`` turns the settings into
the pipeline's static topology; ``session.DYNAMIC_KEYS`` names the
per-frame scalars.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from dataclasses import dataclass, field
from typing import Any


class Denoiser(enum.Enum):
    """Source/Denoiser.ixx façade enum."""
    NONE = "None"
    DLSS_RAY_RECONSTRUCTION = "DLSSRayReconstruction"  # joint denoise+upscale
    NRD_REBLUR = "NRDReBLUR"
    NRD_RELAX = "NRDReLAX"


class Upscaler(enum.Enum):
    """Source/Upscaler.ixx façade enum (DLSS/XeSS -> our TAA upscaler)."""
    NONE = "None"
    DLSS = "DLSS"
    XESS = "XeSS"


class SuperResolutionMode(enum.Enum):
    """MyAppData.h SuperResolutionMode."""
    AUTO = "Auto"
    NATIVE = "Native"
    QUALITY = "Quality"
    BALANCED = "Balanced"
    PERFORMANCE = "Performance"
    ULTRA_PERFORMANCE = "UltraPerformance"


class RTXGITechnique(enum.Enum):
    """Source/RTXGI.ixx façade enum."""
    NONE = "None"
    SHARC = "SHARC"


class ColorPrimaryRotation(enum.Enum):
    """DirectXTK ToneMapPostProcess::ColorPrimaryRotation
    (MyAppData.h:126-128, App.cpp:2216-2225)."""
    HDTV_TO_UHDTV = "HDTV_to_UHDTV"
    DCI_P3_D65_TO_UHDTV = "DCI_P3_D65_to_UHDTV"
    HDTV_TO_DCI_P3_D65 = "HDTV_to_DCI_P3_D65"


class LocalLightSamplingMode(enum.Enum):
    """ReSTIRDI_LocalLightSamplingMode (MyAppData.h:35-39)."""
    UNIFORM = "Uniform"
    POWER_RIS = "Power_RIS"
    REGIR_RIS = "ReGIR_RIS"


class ToneMapOperator(enum.Enum):
    """DirectXTK12 ToneMapPostProcess operators (App.cpp:1731-1757)."""
    SATURATE = "Saturate"
    REINHARD = "Reinhard"
    ACES_FILMIC = "ACESFilmic"


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


@dataclass(frozen=True)
class CameraSettings:
    """MyAppData.h:173-179 + thin-lens depth of field (Camera.ixx:25,
    Camera.hlsli:43-54: ApertureRadius/focus-distance camera constants)."""
    is_jitter_enabled: bool = True
    horizontal_field_of_view: float = 90.0  # degrees, clamp [30, 120]
    aperture_radius: float = 0.0            # world units; 0 = pinhole
    focus_distance: float = 1.0             # |forward| scale (focus plane)

    def check(self) -> "CameraSettings":
        return dataclasses.replace(
            self, horizontal_field_of_view=_clamp(
                self.horizontal_field_of_view, 30.0, 120.0),
            aperture_radius=_clamp(self.aperture_radius, 0.0, 1.0),
            focus_distance=_clamp(self.focus_distance, 0.1, 1e4))


@dataclass(frozen=True)
class RaytracingSettings:
    """MyAppData.h:183-188 defaults: 8 bounces, 1 spp, RR on."""
    is_russian_roulette_enabled: bool = True
    bounces: int = 8                  # clamp [0, 8] (MaxBounces)
    samples_per_pixel: int = 1        # clamp [1, 16] (MaxSamplesPerPixel)
    throughput_threshold: float = 1e-3

    MAX_BOUNCES = 8
    MAX_SAMPLES_PER_PIXEL = 16

    def check(self) -> "RaytracingSettings":
        return dataclasses.replace(
            self,
            bounces=_clamp(self.bounces, 0, self.MAX_BOUNCES),
            samples_per_pixel=_clamp(self.samples_per_pixel, 1,
                                     self.MAX_SAMPLES_PER_PIXEL),
            throughput_threshold=_clamp(self.throughput_threshold, 0.0, 1.0))


@dataclass(frozen=True)
class ReSTIRDISettings:
    """MyAppData.h:190-253 (RTXDI/ReSTIR DI block)."""
    is_enabled: bool = True
    # ReGIR presampling grid
    regir_cell_size: float = 1.0
    regir_cells_per_axis: int = 16
    regir_build_samples: int = 8
    # initial sampling (MyAppData.h:212: local-light mode, default ReGIR)
    local_light_mode: LocalLightSamplingMode = LocalLightSamplingMode.REGIR_RIS
    local_light_samples: int = 8
    brdf_samples: int = 1
    # temporal / spatial resampling
    is_temporal_resampling_enabled: bool = True
    is_spatial_resampling_enabled: bool = True
    max_history_length: int = 20
    boiling_filter_strength: float = 0.2
    spatial_samples: int = 1
    spatial_radius: float = 30.0
    # "basic" | "pairwise" | "raytraced" (RTXDI spatial bias correction,
    # Source/RTXDI.ixx:73-139).
    spatial_bias_correction: str = "basic"
    # Same 3-way switch for temporal reuse (MyAppData.h:226-239).
    temporal_bias_correction: str = "basic"
    # "pseudo" | "real" previous-surface reconstruction for the pairwise/
    # raytraced temporal modes (ops/restir.ReSTIRConfig
    # .temporal_prev_surface; RTXDIAppBridge.hlsli:293-348 previousFrame).
    temporal_prev_surface: str = "pseudo"
    # "per_pixel" | "shared" neighbor addressing (see
    # ops/restir.ReSTIRConfig.spatial_offset_mode).
    spatial_offset_mode: str = "per_pixel"

    def check(self) -> "ReSTIRDISettings":
        return dataclasses.replace(
            self,
            regir_cells_per_axis=_clamp(self.regir_cells_per_axis, 4, 64),
            regir_build_samples=_clamp(self.regir_build_samples, 1, 32),
            local_light_samples=_clamp(self.local_light_samples, 0, 32),
            brdf_samples=_clamp(self.brdf_samples, 0, 8),
            max_history_length=_clamp(self.max_history_length, 1, 64),
            boiling_filter_strength=_clamp(self.boiling_filter_strength,
                                           0.0, 1.0),
            spatial_samples=_clamp(self.spatial_samples, 0, 8),
            spatial_radius=_clamp(self.spatial_radius, 1.0, 64.0),
            spatial_bias_correction=(
                self.spatial_bias_correction
                if self.spatial_bias_correction in ("basic", "pairwise",
                                                    "raytraced")
                else "basic"),
            temporal_bias_correction=(
                self.temporal_bias_correction
                if self.temporal_bias_correction in ("basic", "pairwise",
                                                     "raytraced")
                else "basic"),
            temporal_prev_surface=(
                self.temporal_prev_surface
                if self.temporal_prev_surface in ("pseudo", "real")
                else "pseudo"),
            spatial_offset_mode=(
                self.spatial_offset_mode
                if self.spatial_offset_mode in ("per_pixel", "shared")
                else "per_pixel"))


@dataclass(frozen=True)
class SHARCSettings:
    """MyAppData.h:255-273 defaults: downscale 4, scene scale 50,
    capacity 2^22 (SHARC.ixx:48)."""
    is_enabled: bool = True
    capacity_log2: int = 22
    downscale_factor: int = 4
    scene_scale: float = 50.0
    roughness_threshold: float = 0.4
    is_anti_firefly_enabled: bool = True
    accumulation_frames: int = 10
    max_stale_frames: int = 64

    def check(self) -> "SHARCSettings":
        return dataclasses.replace(
            self,
            capacity_log2=_clamp(self.capacity_log2, 16, 24),
            downscale_factor=_clamp(self.downscale_factor, 1, 8),
            scene_scale=_clamp(self.scene_scale, 1.0, 1000.0),
            roughness_threshold=_clamp(self.roughness_threshold, 0.0, 1.0),
            accumulation_frames=_clamp(self.accumulation_frames, 1, 64),
            max_stale_frames=_clamp(self.max_stale_frames, 1, 256))


@dataclass(frozen=True)
class PostProcessingSettings:
    """MyAppData.h:278-336: NRD/DLSS-RR denoise, SR Auto, bloom 0.05, ACES."""
    denoiser: Denoiser = Denoiser.NRD_REBLUR
    upscaler: Upscaler = Upscaler.DLSS
    super_resolution_mode: SuperResolutionMode = SuperResolutionMode.AUTO
    is_sharpening_enabled: bool = True
    sharpness: float = 0.5
    is_bloom_enabled: bool = True
    bloom_strength: float = 0.05
    tone_map_operator: ToneMapOperator = ToneMapOperator.ACES_FILMIC
    exposure: float = 1.0
    # HDR10 output (App.cpp:1737-1744): ST.2084 + Rec.2020 rotation +
    # paper-white scaling instead of the SDR operator + sRGB encode.
    is_hdr_enabled: bool = False
    paper_white_nits: float = 200.0
    hdr_color_rotation: ColorPrimaryRotation = ColorPrimaryRotation.HDTV_TO_UHDTV
    # Denoiser tuning (NRD common/ReBLUR settings the reference mutates
    # through its UI, App.cpp:1584-1637): history cap, anti-ghosting
    # clamp width (0 disables), specular virtual-point reprojection.
    denoiser_max_history: int = 30
    denoiser_clamp_gamma: float = 2.5
    denoiser_specular_virtual: bool = True
    # Lateral chromatic aberration (reference README "Post-Processing >
    # Chromatic Aberration"; no shader ships in the snapshot — see
    # ops/post.chromatic_aberration). 0 disables.
    chromatic_aberration_strength: float = 0.0

    def check(self) -> "PostProcessingSettings":
        return dataclasses.replace(
            self,
            chromatic_aberration_strength=_clamp(
                self.chromatic_aberration_strength, 0.0, 0.05),
            sharpness=_clamp(self.sharpness, 0.0, 1.0),
            bloom_strength=_clamp(self.bloom_strength, 0.0, 1.0),
            exposure=_clamp(self.exposure, 1e-3, 1e3),
            paper_white_nits=_clamp(self.paper_white_nits, 80.0, 1000.0),
            denoiser_max_history=_clamp(self.denoiser_max_history, 1, 64),
            denoiser_clamp_gamma=_clamp(self.denoiser_clamp_gamma,
                                        0.0, 16.0))


@dataclass(frozen=True)
class GraphicsSettings:
    """Top-level graphics settings (MyAppData.h Graphics struct)."""
    render_width: int = 1920
    render_height: int = 1080
    is_vsync_enabled: bool = False
    camera: CameraSettings = field(default_factory=CameraSettings)
    raytracing: RaytracingSettings = field(default_factory=RaytracingSettings)
    restir_di: ReSTIRDISettings = field(default_factory=ReSTIRDISettings)
    rtxgi: RTXGITechnique = RTXGITechnique.SHARC
    sharc: SHARCSettings = field(default_factory=SHARCSettings)
    post: PostProcessingSettings = field(default_factory=PostProcessingSettings)

    def check(self) -> "GraphicsSettings":
        """Clamp-on-load (MyAppData.h Check():340-373)."""
        return dataclasses.replace(
            self,
            render_width=_clamp(self.render_width, 16, 16384),
            render_height=_clamp(self.render_height, 16, 16384),
            camera=self.camera.check(),
            raytracing=self.raytracing.check(),
            restir_di=self.restir_di.check(),
            sharc=self.sharc.check(),
            post=self.post.check())


# ----------------------------------------------------------------------------
# JSON round-trip (JSONHelpers.h equivalents)


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


def _from_jsonable(cls, data: Any) -> Any:
    if dataclasses.is_dataclass(cls) and isinstance(data, dict):
        kwargs = {}
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
        defaults = cls()
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            current = getattr(defaults, f.name)
            kwargs[f.name] = _coerce(type(current), current, data[f.name])
        return dataclasses.replace(defaults, **kwargs)
    return data


def _coerce(typ, default, value):
    if dataclasses.is_dataclass(typ):
        return _from_jsonable(typ, value)
    if isinstance(default, enum.Enum):
        try:
            return type(default)(value)
        except ValueError:
            return default  # unknown enum name -> keep default (clamp-like)
    if isinstance(default, bool):
        return bool(value)
    if isinstance(default, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


@dataclass(frozen=True)
class ControlsSettings:
    """MyAppData.h:392-414 Controls.json: fly-camera speeds. Movement is
    world units per second, rotation radians per keypress-equivalent."""
    camera_movement_speed: float = 10.0
    camera_rotation_speed: float = 0.5

    def check(self) -> "ControlsSettings":
        return dataclasses.replace(
            self,
            camera_movement_speed=_clamp(self.camera_movement_speed,
                                         0.0, 1000.0),
            camera_rotation_speed=_clamp(self.camera_rotation_speed,
                                         0.0, 2.0))


def load_controls(path: str) -> ControlsSettings:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        data = {}
    if not isinstance(data, dict):
        data = {}  # valid JSON, wrong shape: defaults, like a bad file
    return _from_jsonable(ControlsSettings, data).check()


def save_settings(settings: GraphicsSettings, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_to_jsonable(settings), f, indent=2)


def load_settings(path: str) -> GraphicsSettings:
    """Load + clamp (Settings::Load semantics, MyAppData.h:416-431).
    Missing/unknown fields fall back to defaults."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError):
        data = {}
    if not isinstance(data, dict):
        data = {}  # valid JSON, wrong shape: defaults, like a bad file
    return _from_jsonable(GraphicsSettings, data).check()
