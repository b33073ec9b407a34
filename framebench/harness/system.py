"""The system under test: the port's Session (one card) or its sharded
graph frame (a rank of several), built from a configuration file on the
demo scene at t = 0, and what the reference is handed: its own scene
start, the program's beside it, and the frame's constants.

A configuration file holds:

- ``settings``: dotted GraphicsSettings keys and values, applied in order
  to the defaults (the settings window's keys);
- ``output``: [width, height] of the output image;
- ``overrides``: PipelineConfig fields the settings do not reach;
- ``scene``: ``layout_seed`` (the oscillator field's layout and
  materials, 0), ``oscillator_grid`` (10: the demo's field) and
  ``geosphere_tessellation`` (null: analytic spheres; n: every sphere an
  instance of one geosphere of that tessellation);
- ``ranks``: 1, or the row bands of the sharded frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..reference import render, scene as ref_scene


def _np(t):
    return t.detach().to("cpu").double().numpy() if t.is_floating_point() \
        else t.detach().to("cpu").numpy()


def build(config: dict, device):
    """(pipeline, scene host, Session or None) of the configuration, the
    demo scene at t = 0: a Session stepping CUDA graph frames for one
    rank; for bands, the pipeline alone (each rank drives its own graph
    frame)."""
    from drts_tpu_torch import config as config_mod, session as session_mod
    from drts_tpu_torch.models import myscene, pipeline

    settings = config_mod.GraphicsSettings()
    for key, value in config.get("settings", {}).items():
        settings = session_mod.set_by_path(settings, key, value)
    sc = config.get("scene", {})
    host = myscene.build(seed=int(sc.get("layout_seed", 0)),
                         oscillator_grid=int(sc.get("oscillator_grid", 10)),
                         device=device)
    tess = sc.get("geosphere_tessellation")
    if tess:
        host = myscene.as_mesh_scene(host, tessellation=int(tess))
    ow, oh = config["output"]
    overrides = dict(config.get("overrides", {}))
    if int(config.get("ranks", 1)) == 1:
        sess = session_mod.Session(settings, output_width=ow,
                                   output_height=oh, host=host,
                                   config_overrides=overrides, device=device,
                                   graph=True)
        return sess.pipe, host, sess
    cfg = pipeline.PipelineConfig.from_settings(settings, output_width=ow,
                                                output_height=oh)
    cfg = dataclasses.replace(cfg, **overrides)
    return pipeline.RenderPipeline(cfg, device), host, None


def jitter_period(cfg) -> int:
    """The camera jitter's Halton period: 8 x the upscale ratio squared,
    at least the configuration's halton_period (the DLSS convention)."""
    ratio2 = (cfg.output_width * cfg.output_height) / max(
        cfg.render_width * cfg.render_height, 1)
    return max(cfg.halton_period, int(round(8 * ratio2)))


def program_start(host) -> dict:
    """The program's scene start as host arrays, keyed as the reference's
    (``reference.scene.demo_start``): what the check compares it with."""
    scene, b = host.scene, host.bodies
    mats = scene.materials
    return {
        "radius": _np(b.radius),
        "base_color": _np(mats.base_color)[:, :3],
        "emission": _np(mats.emissive_strength)[:, None]
        * _np(mats.emissive_color),
        "metallic": _np(mats.metallic), "roughness": _np(mats.roughness),
        "ior": _np(mats.ior), "transmission": _np(mats.transmission),
        "bodies": {
            "position": _np(b.position), "velocity": _np(b.velocity),
            "rotation": _np(b.rotation),
            "angular_velocity": _np(b.angular_velocity),
            "mass": _np(b.mass), "inv_mass": _np(b.inv_mass),
            "radius": _np(b.radius), "is_oscillator": _np(b.is_oscillator),
            "attracted_to_earth": _np(b.attracted_to_earth),
            "earth_gravity": np.array(False), "star_gravity": np.array(False),
            "spring_rest_y": float(b.spring_rest_y),
            "earth_index": int(b.earth_index),
            "star_index": int(b.star_index)},
    }


def inputs(host, cfg, config: dict, dt: float) -> dict:
    """What the reference is handed: the scene's start as the reference
    builds it from the demo's layout (never the program's arrays), the
    program's start beside it for the check to compare, and the frame's
    constants from the configuration. Taken before the first frame."""
    if (cfg.tone_map_operator != "ACESFilmic" or cfg.hdr_enabled
            or cfg.chromatic_aberration_strength != 0.0
            or cfg.aperture_radius != 0.0 or cfg.debug_view != "None"):
        raise ValueError("the reference renders the pinhole camera and the "
                         "SDR ACES display pass alone")
    sc = config.get("scene", {})
    out = ref_scene.demo_start(int(sc.get("layout_seed", 0)),
                               int(sc.get("oscillator_grid", 10)))
    out.update({
        "program_start": program_start(host),
        "geosphere_tessellation": sc.get("geosphere_tessellation"),
        "dt": float(dt),
        "jitter": render.halton_jitter(jitter_period(cfg)),
        "render_size": (cfg.render_width, cfg.render_height),
        "output_size": (cfg.output_width, cfg.output_height),
        "hfov_deg": float(cfg.horizontal_fov_deg),
        "physics": bool(cfg.physics_enabled),
        "post": {"sharpness": float(cfg.sharpness) if cfg.sharpen_enabled
                 else 0.0,
                 "bloom_strength": float(cfg.bloom_strength)
                 if cfg.bloom_enabled else 0.0,
                 "exposure": float(cfg.exposure)},
    })
    return out


def camera_start(host) -> dict:
    return {"position": list(host.camera_position),
            "forward": list(host.camera_forward)}
