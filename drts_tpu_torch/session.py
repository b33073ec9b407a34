"""Runtime settings changes, the settings-window analogue (port of
``drts_tpu/session.py``).

The reference's settings window changes ~40 GraphicsSettings live
(App.cpp:1875-2273); heavy changes wait for the frame boundary
(App.cpp:166-175) and most set ``m_resetHistory`` (App.cpp:667-679). A
``Session.set`` answers how it applied a change:

* ``"dynamic"``: exposure, bloom strength and sharpness ride the
  ``DynamicSettings`` tensors, and the next frame takes them;
* ``"static"``: any other topology change (bounces, denoiser, ReSTIR or
  SHARC parameters) rebuilds the pipeline and its cluster plan, keeps the
  temporal state and resets the history on the next frame;
* ``"realloc"``: a change of buffer shapes (render or output size, SHARC
  capacity, upscaler, super-resolution mode) allocates a fresh
  ``FrameState`` and carries the simulation across: the frame index and
  the host's frame count, the rigid bodies, the scene and the gravity
  toggles.

A Session steps through ``RenderPipeline.render_frame_graph`` (CUDA
graph replays on the card), the counterpart of the reference's jitted
step: ``dt``, ``reset``, the poses and the dynamic settings are device
inputs of the captured frame, and a static or realloc change drops the
callable, so the next step captures again (lazily, as the reference
compiles again). ``Session(..., graph=False)`` runs the frame eagerly
instead. ``Session`` is what the CLI drives (``app.py``: ``--mutate``,
``--watch-settings``, ``set`` and ``--eager``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import torch

from . import backend, config as config_mod
from .models import myscene, pipeline

# Settings whose value feeds DynamicSettings: they change nothing but a
# scalar (the settings window's "immediate" sliders).
DYNAMIC_KEYS = {"post.exposure", "post.bloom_strength", "post.sharpness"}

# Static keys whose change needs a fresh FrameState (buffer shapes or
# capacities change), not just a history reset.
REALLOC_KEYS = {"render_width", "render_height", "sharc.capacity_log2",
                "post.upscaler", "post.super_resolution_mode"}

# Settings keys that CLI config_overrides may pin: a runtime `set` of the
# settings key releases the pin so that the change takes effect.
_OVERRIDE_FOR_KEY = {
    "raytracing.bounces": "bounces",
    "raytracing.samples_per_pixel": "samples_per_pixel",
    "post.denoiser": "denoiser",
}


def _parse_value(current: Any, text: Any) -> Any:
    """Coerce a CLI string to the type of the current settings field."""
    if not isinstance(text, str):
        return text
    if isinstance(current, enum.Enum):
        return type(current)(text)
    if isinstance(current, bool):
        return text.lower() in ("1", "true", "on", "yes")
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    return text


def set_by_path(settings: config_mod.GraphicsSettings, key: str, value):
    """A new GraphicsSettings with the dotted-path ``key`` replaced and
    clamped. Raises KeyError for an unknown field (the settings window
    shows only real settings)."""
    parts = key.split(".")

    def rec(node, parts):
        name = parts[0]
        if not any(f.name == name for f in dataclasses.fields(node)):
            raise KeyError(f"unknown setting: {key}")
        cur = getattr(node, name)
        if len(parts) == 1:
            return dataclasses.replace(node,
                                       **{name: _parse_value(cur, value)})
        return dataclasses.replace(node, **{name: rec(cur, parts[1:])})

    return rec(settings, parts).check()


class Session:
    """A live render session whose settings change between frames.
    ``device`` defaults to the card (``backend.device`` raises where there
    is none)."""

    def __init__(self, settings: config_mod.GraphicsSettings,
                 output_width: int | None = None,
                 output_height: int | None = None,
                 host=None, seed: int = 0,
                 config_overrides: dict | None = None, device="cuda",
                 graph: bool = True):
        self.settings = settings.check()
        self.graph = graph
        self._frame = None      # the graph callable, made at the next step
        self.output_width = output_width
        self.output_height = output_height
        self.config_overrides = dict(config_overrides or {})
        self.device = backend.device(device)
        self.host = (host if host is not None
                     else myscene.build(seed=seed, device=self.device))
        self.pipe = self._make_pipeline()
        self.state = self.pipe.init_state(self.host)
        self.dyn = pipeline.default_dynamic(self.pipe.cfg, self.pipe.device)
        self._pending_reset = False
        self.frame_count = 0

    # -- construction --------------------------------------------------------

    def _make_pipeline(self) -> pipeline.RenderPipeline:
        cfg = pipeline.PipelineConfig.from_settings(
            self.settings, output_width=self.output_width,
            output_height=self.output_height)
        if self.config_overrides:
            cfg = dataclasses.replace(cfg, **self.config_overrides)
        return pipeline.RenderPipeline(cfg, self.device)

    def default_pose(self) -> pipeline.CameraPose:
        return self.pipe.default_camera_pose(self.host)

    # -- mutation (the settings-window entry point) --------------------------

    def set(self, key: str, value) -> str:
        """Apply one setting change. Returns how it was applied:
        "dynamic", "static" (history reset on the next frame) or "realloc"
        (fresh temporal state)."""
        self.settings = set_by_path(self.settings, key, value)
        self.config_overrides.pop(_OVERRIDE_FOR_KEY.get(key, ""), None)
        if key in DYNAMIC_KEYS:
            field = key.split(".")[-1]
            self.dyn = dataclasses.replace(self.dyn, **{field: torch.tensor(
                getattr(self.settings.post, field), dtype=torch.float32,
                device=self.pipe.device)})
            return "dynamic"

        old_cfg = self.pipe.cfg
        self.pipe = self._make_pipeline()
        self._frame = None
        cfg = self.pipe.cfg
        if key in REALLOC_KEYS or cfg.render_width != old_cfg.render_width \
                or cfg.render_height != old_cfg.render_height:
            # Buffer shapes changed: reallocate, carrying the simulation
            # (scene, physics, frame counters) across, as
            # OnRenderSizeChanged does.
            fresh = self.pipe.init_state(self.host)
            self.state = dataclasses.replace(
                fresh, frame_index=self.state.frame_index,
                bodies=self.state.bodies, scene=self.state.scene,
                earth_gravity=self.state.earth_gravity,
                star_gravity=self.state.star_gravity,
                frame_count=self.state.frame_count)
            self.dyn = pipeline.default_dynamic(cfg, self.pipe.device)
            return "realloc"
        # Same shapes: keep the state, reset the temporal history on the
        # next frame (m_resetHistory). A change into or out of the real
        # previous surface changes that one buffer's shape; it holds no
        # history to keep.
        self.pipe.build_plan(self.host)
        rows = ((cfg.render_height, cfg.render_width, 7)
                if self.pipe._use_real_prev_surface() else (1, 1, 7))
        if tuple(self.state.prev_surface_rows.shape) != rows:
            self.state = dataclasses.replace(
                self.state, prev_surface_rows=torch.zeros(
                    rows, device=self.pipe.device))
        self._pending_reset = True
        return "static"

    def reload_settings(self, path: str) -> list[str]:
        """Reload the settings file: diff it against the current settings
        and apply each changed key (the file-watch analogue of the
        settings window). Returns the changed keys."""
        new = config_mod.load_settings(path)
        changed = []

        def diff(prefix, a, b):
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                key = f"{prefix}{f.name}"
                if dataclasses.is_dataclass(va) and not isinstance(va, type):
                    diff(key + ".", va, vb)
                elif va != vb:
                    changed.append(key)

        diff("", self.settings, new)
        for key in changed:
            val = new
            for part in key.split("."):
                val = getattr(val, part)
            self.set(key, val)
        return changed

    # -- stepping -------------------------------------------------------------

    def step(self, pose: pipeline.CameraPose | None = None,
             dt: float = 1.0 / 60.0,
             prev_pose: pipeline.CameraPose | None = None):
        """Render one frame (a pending history reset applies to it).
        Returns the (OH, OW, 3) image in [0, 1] on the session's device;
        with ``graph``, the next step rewrites it (and ``state`` the step
        after): clone what you keep."""
        if pose is None:
            pose = self.default_pose()
        reset = self._pending_reset
        self._pending_reset = False
        render = self.pipe.render_frame
        if self.graph:
            if self._frame is None:
                self._frame = self.pipe.render_frame_graph()
            render = self._frame
        self.state, image = render(
            self.state, pose, dt,
            prev_pose=prev_pose if prev_pose is not None else pose,
            reset=reset, dyn=self.dyn)
        self.frame_count += 1
        return image
