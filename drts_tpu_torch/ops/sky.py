"""Environment light evaluation (port of ``drts_tpu/ops/sky.py``).

``GetEnvironmentLightColor`` (ShadingHelpers.hlsli:11-30): the lat-long
texture where there is one (looked up along the direction rotated by the
environment's rotation), else a constant color where its alpha >= 0, else
the procedural sky gradient
``Color::FromSrgb(lerp(1, (0.5, 0.7, 1), (dir.y + 1) / 2))``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import backend
from ..utils import math as m


@dataclasses.dataclass(frozen=True)
class EnvironmentLight:
    """Environment light state (Scene.ixx:64-94 EnvironmentLightBase)."""
    color: torch.Tensor     # (4,); alpha < 0 -> procedural sky
    rotation: torch.Tensor  # (4,) quaternion applied to the lookup direction
    texture: torch.Tensor | None = None      # (H, W, 3) lat-long radiance
    # Quarter-size mip (post.generate_mips, the MipmapGeneration.hlsl
    # role): wide-footprint (deep-bounce) lookups read it.
    texture_low: torch.Tensor | None = None


def make_environment_light(color=(0.0, 0.0, 0.0, -1.0),
                           rotation=m.QUAT_IDENTITY, texture=None,
                           device="cuda") -> EnvironmentLight:
    """`texture` is an (H, W, 3) lat-long map (numpy or tensor) or None;
    its quarter-size mip is built where H and W are multiples of 4."""
    device = backend.device(device)
    texture_low = None
    if texture is not None:
        from . import post
        texture = torch.as_tensor(texture, dtype=torch.float32,
                                  device=device)
        h, w = texture.shape[0], texture.shape[1]
        if h % 4 == 0 and w % 4 == 0:
            texture_low = post.generate_mips(texture, 2)[-1]
    return EnvironmentLight(
        color=torch.as_tensor(color, dtype=torch.float32, device=device),
        rotation=torch.as_tensor(rotation, dtype=torch.float32,
                                 device=device),
        texture=texture, texture_low=texture_low)


def procedural_sky(direction):
    """ShadingHelpers.hlsli:29 gradient fallback (sRGB-encoded lerp)."""
    t = (direction[..., 1:2] + 1.0) * 0.5
    one = torch.ones(3, dtype=direction.dtype, device=direction.device)
    top = m.const((0.5, 0.7, 1.0), direction.dtype, direction.device)
    return m.from_srgb(m.lerp(one, top, t))


def _sample_latlong_bilinear(texture, direction):
    """Bilinear lookup of an (H, W, 3) lat-long map along unit directions:
    U wraps, the row is clamped before the fraction (at the poles an
    unclamped fraction would blend the two outermost rows), and a
    direction that is not finite reads texel (0, 0)'s corner."""
    h, w = texture.shape[0], texture.shape[1]
    uv = torch.nan_to_num(m.to_latlong(direction), nan=0.0, posinf=0.0,
                          neginf=0.0)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    fx = (x - x0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = y0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = texture.reshape(h * w, -1)
    c00 = flat[y0i * w + x0i]
    c10 = flat[y0i * w + x1i]
    c01 = flat[y1i * w + x0i]
    c11 = flat[y1i * w + x1i]
    return m.lerp(m.lerp(c00, c10, fx), m.lerp(c01, c11, fx), fy)


def environment_color(env: EnvironmentLight, direction, wide: bool = False):
    """The environment light along (..., 3) world directions. `wide`
    marks wide-footprint callers (bounces past the path tracer's
    texture_bounces): they read the quarter-size mip where there is
    one."""
    tex = env.texture
    if wide and env.texture_low is not None:
        tex = env.texture_low
    if tex is not None:
        d = m.normalize(m.quat_rotate(env.rotation, direction))
        return _sample_latlong_bilinear(tex, d)
    has_color = env.color[3] >= 0.0
    return torch.where(has_color, env.color[:3], procedural_sky(direction))
