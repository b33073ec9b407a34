"""Camera constants, pinhole and thin-lens ray generation and
reprojection (port of ``drts_tpu/ops/camera.py``).

The scaled right/up/forward frame follows the reference: |forward| = focus
distance, |right| = tan(hfov/2)*|forward|, |up| = |right| / aspect
(Camera.ixx:138-153), and rays are
``normalize(NDC.x * right + NDC.y * up + forward)`` (Camera.hlsli:27-41).
``CameraController`` and ``apply_input_key`` are the CLI's fly camera.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend
from ..utils import math as m
from . import brdf


@dataclasses.dataclass(frozen=True)
class Camera:
    """Device camera constants (Camera.hlsli:5-26), current + previous."""
    position: torch.Tensor       # (3,)
    right: torch.Tensor          # (3,) scaled
    up: torch.Tensor             # (3,) scaled
    forward: torch.Tensor        # (3,) scaled
    prev_position: torch.Tensor  # (3,)
    prev_right: torch.Tensor
    prev_up: torch.Tensor
    prev_forward: torch.Tensor
    jitter: torch.Tensor         # (2,) pixel-fraction jitter
    aperture_radius: torch.Tensor  # scalar
    near_depth: torch.Tensor     # scalar
    far_depth: torch.Tensor      # scalar


def make_camera(position, forward=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0),
                horizontal_fov_deg: float = 90.0, aspect: float = 16 / 9,
                jitter=(0.0, 0.0), aperture_radius: float = 0.0,
                near_depth: float = 1e-3, far_depth: float = 1e8,
                focus_distance: float = 1.0, device="cuda") -> Camera:
    """Camera constants, as CameraController::SetLens builds them
    (Camera.ixx:138-153), with the previous frame equal to this one.
    ``focus_distance`` scales the whole frame (|forward| = focus distance,
    the thin lens's focal plane; pinhole directions are normalized, so it
    does not change them). ``aspect`` = width / height; ``device``
    defaults to the card."""
    device = backend.device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def scalar(x):
        # The lens constants (numbers, or the jitter's pair) are made once:
        # a frame captured as a CUDA graph copies nothing from the host.
        if isinstance(x, torch.Tensor):
            return f32(x)
        return m.const(tuple(x) if isinstance(x, (tuple, list)) else x,
                       device=device)

    position = f32(position)
    f = m.normalize(f32(forward))
    if focus_distance != 1.0:
        # (x * 1 is x: the unit focus skips a launch.)
        f = f * focus_distance
    r = m.normalize(m.cross(f32(up), f))
    u = m.cross(m.normalize(f), r)
    # float32 scale factors, rounded exactly as the reference's numpy ones.
    tan_half = np.tan(np.radians(horizontal_fov_deg) / 2).astype(np.float32)
    scale = tan_half * np.float32(focus_distance)
    r = r * float(scale)
    u = u * float(scale / np.float32(aspect))
    return Camera(position=position, right=r, up=u, forward=f,
                  prev_position=position, prev_right=r, prev_up=u,
                  prev_forward=f, jitter=scalar(jitter),
                  aperture_radius=scalar(aperture_radius),
                  near_depth=scalar(near_depth), far_depth=scalar(far_depth))


def pixel_ndc(width: int, height: int, jitter, rows=None):
    """Per-pixel (H, W, 2) NDC grid with camera jitter (Math::CalculateUV/NDC).
    ``rows`` = (start, end) gives a band of the height-row frame: its
    (end - start, W, 2) grid, each pixel's NDC as in the whole frame."""
    dev = jitter.device
    r0, r1 = rows if rows is not None else (0, height)
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(r0, r1, dtype=torch.float32, device=dev)
    xy = torch.stack(torch.meshgrid(px, py, indexing="xy"), dim=-1)
    dims = m.const((width, height), device=dev)
    return m.calculate_ndc(m.calculate_uv(xy, dims, jitter))


def generate_pinhole_rays(cam: Camera, ndc):
    """Camera.hlsli:32-41 GeneratePinholeRay over (..., 2) NDC.

    Returns (origin, direction, t_min, t_max)."""
    d = ndc[..., 0:1] * cam.right + ndc[..., 1:2] * cam.up + cam.forward
    d = m.normalize(d)
    inv_cos = 1.0 / m.dot(m.normalize(cam.forward), d)
    origin = cam.position.expand(d.shape)
    return origin, d, cam.near_depth * inv_cos, cam.far_depth * inv_cos


def generate_thin_lens_rays(cam: Camera, ndc, random2):
    """Camera.hlsli:43-54 GenerateThinLensRay (depth of field): each ray
    leaves its own aperture point and passes through the pinhole ray's
    point on the focal plane. Returns (origin, direction, t_min, t_max),
    the origin per ray."""
    disk = brdf.sample_uniform_disk(random2)
    r_n = m.normalize(cam.right)
    u_n = m.normalize(cam.up)
    offset = (r_n * disk[..., 0:1] + u_n * disk[..., 1:2]) \
        * cam.aperture_radius
    target = ndc[..., 0:1] * cam.right + ndc[..., 1:2] * cam.up + cam.forward
    d = m.normalize(target - offset)
    inv_cos = 1.0 / m.dot(m.normalize(cam.forward), d)
    return (cam.position + offset, d, cam.near_depth * inv_cos,
            cam.far_depth * inv_cos)


def project_to_ndc(cam: Camera, world_pos, previous: bool = False):
    """World position -> (NDC xy, view depth) under this (or the previous)
    camera, for motion vectors (GBufferGeneration.hlsl:62-91)."""
    pos = cam.prev_position if previous else cam.position
    r = cam.prev_right if previous else cam.right
    u = cam.prev_up if previous else cam.up
    f = cam.prev_forward if previous else cam.forward
    p = world_pos - pos
    rr, uu, ff = m.dot(r, r), m.dot(u, u), m.dot(f, f)
    z = m.dot(p, f) / ff
    x = m.dot(p, r) / rr
    y = m.dot(p, u) / uu
    z_safe = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    return torch.stack([x / z_safe, y / z_safe], dim=-1), z * torch.sqrt(ff)


def ndc_to_pixel(ndc, width: int, height: int):
    """Inverse of Math::CalculateNDC -> pixel coordinates (float)."""
    dev, dt = ndc.device, ndc.dtype
    uv = ((ndc - m.const((-1.0, 1.0), dt, dev))
          / m.const((2.0, -2.0), dt, dev))
    return uv * m.const((width, height), dt, dev) - 0.5


class CameraController:
    """Quaternion fly camera, the reference's CameraController
    (Camera.ixx:38-178): translate in the local frame, yaw about world up,
    pitch about local right, roll about forward (Camera.ixx:109). Its
    state is numpy float64 on the host, as input handling is
    (ProcessInput, App.cpp:812-970); ``pose`` hands the pipeline a
    float32 ``CameraPose`` on a device."""

    def __init__(self, position=(0.0, 0.0, -15.0), forward=(0.0, 0.0, 1.0),
                 up=(0.0, 1.0, 0.0)):
        self.position = np.asarray(position, np.float64)
        f = np.asarray(forward, np.float64)
        self._forward = f / np.linalg.norm(f)
        u = np.asarray(up, np.float64)
        r = np.cross(u, self._forward)
        self._right = r / np.linalg.norm(r)
        self._up = np.cross(self._forward, self._right)

    @property
    def forward(self):
        return self._forward.copy()

    @property
    def right(self):
        return self._right.copy()

    @property
    def up(self):
        return self._up.copy()

    def translate(self, displacement) -> None:
        """Move in the local frame (right, up, forward), Camera.ixx:105."""
        d = np.asarray(displacement, np.float64)
        self.position = (self.position + d[0] * self._right
                         + d[1] * self._up + d[2] * self._forward)

    @staticmethod
    def _rotate(v, axis, angle):
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        return (v * c + np.cross(axis, v) * s
                + axis * np.dot(axis, v) * (1.0 - c))

    def rotate(self, yaw: float = 0.0, pitch: float = 0.0,
               roll: float = 0.0) -> None:
        """Camera.ixx:109: yaw about world +Y, pitch about local right,
        roll about local forward (the reference's signs)."""
        for axis, angle in (((0.0, 1.0, 0.0), yaw),
                            (self._right, -pitch),
                            (self._forward, -roll)):
            if angle:
                axis = np.asarray(axis, np.float64)
                self._forward = self._rotate(self._forward, axis, angle)
                self._right = self._rotate(self._right, axis, angle)
        self._forward /= np.linalg.norm(self._forward)
        self._right -= self._forward * np.dot(self._right, self._forward)
        self._right /= np.linalg.norm(self._right)
        self._up = np.cross(self._forward, self._right)

    def look_at(self, target) -> None:
        f = np.asarray(target, np.float64) - self.position
        self._forward = f / np.linalg.norm(f)
        r = np.cross((0.0, 1.0, 0.0), self._forward)
        if np.linalg.norm(r) < 1e-6:
            r = np.array([1.0, 0.0, 0.0])
        self._right = r / np.linalg.norm(r)
        self._up = np.cross(self._forward, self._right)

    def pose(self, device="cuda"):
        """The pipeline's CameraPose, float32 tensors on `device`."""
        from ..models.pipeline import CameraPose
        device = backend.device(device)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)
        return CameraPose(position=f32(self.position),
                          forward=f32(self._forward), up=f32(self._up))


# Key bindings of the CLI fly camera (the terminal stand-in for the
# reference's ProcessInput WASD and mouse, App.cpp:812-970): translation
# in the local frame, ijkl/uo look, r reset, p screenshot, x quit.
KEY_HELP = ("w/s fwd/back  a/d left/right  q/e down/up  "
            "j/l yaw  i/k pitch  u/o roll  r reset  p screenshot  x quit")


def apply_input_key(controller: CameraController, key: str,
                    move_step: float = 1.0,
                    turn_step: float = np.deg2rad(5.0)) -> str:
    """Apply one key to the controller. Returns the action taken:
    'move' | 'turn' | 'reset' | 'screenshot' | 'quit' | '' (ignored)."""
    moves = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0),
             "d": (1, 0, 0), "q": (0, -1, 0), "e": (0, 1, 0)}
    turns = {"j": (-1, 0, 0), "l": (1, 0, 0), "i": (0, 1, 0),
             "k": (0, -1, 0), "u": (0, 0, -1), "o": (0, 0, 1)}
    k = key.lower()
    if k in moves:
        controller.translate(np.asarray(moves[k], np.float64) * move_step)
        return "move"
    if k in turns:
        yaw, pitch, roll = (np.asarray(turns[k], np.float64) * turn_step)
        controller.rotate(yaw=yaw, pitch=pitch, roll=roll)
        return "turn"
    if k == "r":
        return "reset"
    if k == "p":
        return "screenshot"
    if k == "x":
        return "quit"
    return ""
