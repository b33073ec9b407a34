"""Camera constants, pinhole and thin-lens ray generation and
reprojection (port of ``drts_tpu/ops/camera.py``).

The scaled right/up/forward frame follows the reference: |forward| = focus
distance, |right| = tan(hfov/2)*|forward|, |up| = |right| / aspect
(Camera.ixx:138-153), and rays are
``normalize(NDC.x * right + NDC.y * up + forward)`` (Camera.hlsli:27-41).
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
                  prev_forward=f, jitter=f32(jitter),
                  aperture_radius=f32(aperture_radius),
                  near_depth=f32(near_depth), far_depth=f32(far_depth))


def pixel_ndc(width: int, height: int, jitter):
    """Per-pixel (H, W, 2) NDC grid with camera jitter (Math::CalculateUV/NDC)."""
    dev = jitter.device
    px = torch.arange(width, dtype=torch.float32, device=dev)
    py = torch.arange(height, dtype=torch.float32, device=dev)
    xy = torch.stack(torch.meshgrid(px, py, indexing="xy"), dim=-1)
    dims = torch.tensor([width, height], dtype=torch.float32, device=dev)
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
    uv = ((ndc - torch.tensor([-1.0, 1.0], dtype=dt, device=dev))
          / torch.tensor([2.0, -2.0], dtype=dt, device=dev))
    return uv * torch.tensor([width, height], dtype=dt, device=dev) - 0.5
