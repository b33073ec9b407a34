"""The demo's rigid-body step, plain PyTorch in any precision.

Written from the formulas the demo states (PhysX.h:13-35 and
MyScene.ixx:351-396): a spring restoring force on the oscillator field,
universal gravitation toward the earth on the moon (and, when toggled, on
everything), a fixed 10 m/s^2 pull toward the star when toggled,
semi-implicit Euler, then four Jacobi iterations of the restitution
impulse over all sphere pairs with a mass-weighted penetration projection,
and the rotation integrated from the world-frame angular velocity. The
step is clamped to 1/60 s. Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

GRAVITATIONAL_CONSTANT = 6.674e-11
STAR_PULL = 10.0
RESTITUTION = 0.6
MAX_TIMESTEP = 1.0 / 60.0
SPRING_PERIOD = 3.0


def _length(v):
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=0.0))


def _normalize(v, eps=1e-20):
    return v / torch.clamp(_length(v), min=eps)[..., None]


def _quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def quat_rotate(q, v):
    """Rotate v by the unit quaternion q = (x, y, z, w)."""
    qv = q[..., :3]
    t = 2.0 * torch.linalg.cross(qv.expand_as(v), v, dim=-1)
    return v + q[..., 3:4] * t + torch.linalg.cross(qv.expand_as(t), t,
                                                    dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def step(b: dict, dt: float) -> dict:
    """One step of the bodies `b` (dict of tensors: position, velocity,
    rotation, angular_velocity, mass, inv_mass, radius, is_oscillator,
    attracted_to_earth, earth_gravity, star_gravity; numbers
    spring_rest_y, earth_index, star_index). Returns the new dict."""
    pos, vel = b["position"], b["velocity"]
    k = pos.shape[0]
    dev, dt_ = pos.device, pos.dtype
    dt = min(float(dt), MAX_TIMESTEP)
    dynamic = b["inv_mass"] > 0
    ids = torch.arange(k, device=dev)

    omega_sq = (2.0 * math.pi / SPRING_PERIOD) ** 2
    a = torch.zeros_like(pos)
    spring = b["is_oscillator"] & dynamic
    a[:, 1] = torch.where(spring, -omega_sq * (pos[:, 1] - b["spring_rest_y"]),
                          torch.zeros((), dtype=dt_, device=dev))

    e = b["earth_index"]
    to_earth = pos[e][None, :] - pos
    r = torch.clamp(_length(to_earth), min=1e-6)
    g = GRAVITATIONAL_CONSTANT * b["mass"][e] / (r * r)
    earth_on = (b["attracted_to_earth"]
                | (b["earth_gravity"] & (ids != e))) & dynamic
    a = a + torch.where(earth_on[:, None], (g / r)[:, None] * to_earth,
                        torch.zeros((), dtype=dt_, device=dev))
    s = b["star_index"]
    to_star = pos[s][None, :] - pos
    star_on = b["star_gravity"] & (ids != s) & dynamic
    a = a + torch.where(star_on[:, None], STAR_PULL * _normalize(to_star),
                        torch.zeros((), dtype=dt_, device=dev))

    vel = torch.where(dynamic[:, None], vel + a * dt, vel)
    pos = torch.where(dynamic[:, None], pos + vel * dt, pos)

    w = b["inv_mass"]
    eye = torch.eye(k, dtype=torch.bool, device=dev)
    w_sum = w[:, None] + w[None, :]
    for _ in range(4):
        diff = pos[:, None, :] - pos[None, :, :]
        dist = torch.clamp(_length(diff), min=1e-9)
        n = diff / dist[..., None]
        overlap = (b["radius"][:, None] + b["radius"][None, :]) - dist
        active = (overlap > 0.0) & ~eye & (w_sum > 0)
        vn = ((vel[:, None, :] - vel[None, :, :]) * n).sum(-1)
        approaching = active & (vn < 0.0)
        zero = torch.zeros((), dtype=dt_, device=dev)
        j = torch.where(approaching, -(1.0 + RESTITUTION) * vn
                        / torch.clamp(w_sum, min=1e-12), zero)
        vel = vel + ((j * w[:, None])[..., None] * n).sum(1)
        corr = torch.where(active, overlap / torch.clamp(w_sum, min=1e-12),
                           zero)
        pos = pos + ((corr * w[:, None])[..., None] * n).sum(1) * 0.5

    q = b["rotation"]
    omega_q = torch.cat([b["angular_velocity"],
                         torch.zeros_like(b["angular_velocity"][:, :1])], -1)
    q = _normalize(q + 0.5 * _quat_mul(omega_q, q) * dt)
    return dict(b, position=pos, velocity=vel, rotation=q)


def advance(b: dict, steps: int, dt: float, keep=()) -> dict:
    """`steps` steps from `b`; returns {n: bodies after n steps} for each
    n in `keep`."""
    out = {}
    for n in range(1, steps + 1):
        b = step(b, dt)
        if n in keep:
            out[n] = b
    return out
