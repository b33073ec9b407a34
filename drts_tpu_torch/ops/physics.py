"""Rigid-body dynamics for sphere scenes (port of ``drts_tpu/ops/physics.py``).

The force model ports the formulas of PhysX.h:13-35 (universal gravitation,
simple harmonic motion) and the per-frame force pass of MyScene.ixx:351-396
(spring restoring force on the oscillator field, earth gravity on the moon
and, when toggled, on everything, and a fixed 10 m/s^2 star pull when
toggled). Contacts are a dense (K, K) masked impulse solver, as in the
reference: for K ~ 440 the all-pairs form is a few elementwise kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..utils import math as m

GRAVITATIONAL_CONSTANT = 6.674e-11  # PhysX.h:14
STAR_PULL = 10.0                    # MyScene.ixx:391 (eACCELERATION)
RESTITUTION = 0.6                   # MyScene.ixx:99 material
MAX_TIMESTEP = 1.0 / 60.0           # MyScene.ixx:395
SPRING_PERIOD = 3.0                 # MyScene.ixx:48 (Spring::Period)


def gravitational_mass(r, t):
    """UniversalGravitation::CalculateMass (PhysX.h:17):
    M = 4 pi^2 r^3 / (G t^2)."""
    return 4.0 * np.pi ** 2 * r ** 3 / (GRAVITATIONAL_CONSTANT * t * t)


def gravitational_acceleration(mass, r):
    """UniversalGravitation::CalculateAccelerationMagnitude (PhysX.h:20)."""
    return GRAVITATIONAL_CONSTANT * mass / (r * r)


def first_cosmic_speed(mass, r):
    """UniversalGravitation::CalculateFirstCosmicSpeed (PhysX.h:23)."""
    return np.sqrt(GRAVITATIONAL_CONSTANT * mass / r)


def spring_constant(mass, period):
    """SimpleHarmonicMotion::Spring::CalculateConstant (PhysX.h:28)."""
    return 4.0 * math.pi ** 2 * mass / (period * period)


@dataclasses.dataclass(frozen=True)
class RigidBodies:
    """SoA rigid-body state over K spheres."""
    position: torch.Tensor          # (K, 3)
    velocity: torch.Tensor          # (K, 3)
    rotation: torch.Tensor          # (K, 4) quaternion
    angular_velocity: torch.Tensor  # (K, 3) world-frame rad/s
    mass: torch.Tensor              # (K,); 0 = static collider
    inv_mass: torch.Tensor          # (K,)
    radius: torch.Tensor            # (K,)
    is_oscillator: torch.Tensor     # (K,) bool: spring force applies
    spring_rest_y: float            # rest height (Spring::PositionY)
    attracted_to_earth: torch.Tensor  # (K,) bool: always-on earth gravity
    earth_index: int
    star_index: int


def _accelerations(b: RigidBodies, earth_gravity, star_gravity):
    """Force model of MyScene::Tick (MyScene.ixx:351-396), as accelerations."""
    k = b.position.shape[0]
    dev = b.position.device
    dynamic = b.inv_mass > 0

    # Spring: F = -k x with k = 4 pi^2 m / T^2 -> a = -(2 pi / T)^2 * x.
    omega_sq = (2.0 * math.pi / SPRING_PERIOD) ** 2
    disp_y = b.position[:, 1] - b.spring_rest_y
    zeros = torch.zeros(k, dtype=torch.float32, device=dev)
    a_spring = torch.where(
        (b.is_oscillator & dynamic)[:, None],
        torch.stack([zeros, -omega_sq * disp_y, zeros], dim=-1), 0.0)

    # Earth gravity: on the moon always; on everything but the earth when
    # toggled (MyScene.ixx:378-385).
    ids = torch.arange(k, device=dev)
    to_earth = b.position[b.earth_index][None, :] - b.position
    r = torch.clamp(m.length(to_earth), min=1e-6)
    g_mag = gravitational_acceleration(b.mass[b.earth_index], r)
    earth_on = (b.attracted_to_earth
                | (earth_gravity & (ids != b.earth_index))) & dynamic
    a_earth = torch.where(earth_on[:, None],
                          (g_mag / r)[:, None] * to_earth, 0.0)

    # Star pull: 10 m/s^2 toward the star when toggled (MyScene.ixx:387-392).
    to_star = b.position[b.star_index][None, :] - b.position
    star_on = star_gravity & (ids != b.star_index) & dynamic
    a_star = torch.where(star_on[:, None], STAR_PULL * m.normalize(to_star),
                         0.0)
    return a_spring + a_earth + a_star


def _resolve_contacts(b: RigidBodies, position, velocity,
                      iterations: int = 4):
    """Jacobi iterations of the restitution impulse
    j = -(1+e) (v_rel.n) / (w_i + w_j) over all sphere pairs, then a
    mass-weighted penetration projection (PhysX's PGS role)."""
    k = position.shape[0]
    w = b.inv_mass
    eye = torch.eye(k, dtype=torch.bool, device=position.device)
    w_sum = w[:, None] + w[None, :]
    pos, vel = position, velocity
    for _ in range(iterations):
        diff = pos[:, None, :] - pos[None, :, :]          # (K, K, 3)
        dist = torch.clamp(m.length(diff), min=1e-9)      # (K, K)
        n = diff / dist[..., None]
        overlap = (b.radius[:, None] + b.radius[None, :]) - dist
        active = (overlap > 0.0) & ~eye & (w_sum > 0)

        rel_v = vel[:, None, :] - vel[None, :, :]
        vn = m.dot(rel_v, n)
        approaching = active & (vn < 0.0)
        j_imp = torch.where(approaching,
                            -(1.0 + RESTITUTION) * vn
                            / torch.clamp(w_sum, min=1e-12), 0.0)
        vel = vel + torch.sum((j_imp * w[:, None])[..., None] * n, dim=1)

        corr = torch.where(active, overlap / torch.clamp(w_sum, min=1e-12),
                           0.0)
        pos = pos + torch.sum((corr * w[:, None])[..., None] * n, dim=1) * 0.5
    return pos, vel


def step(b: RigidBodies, dt, earth_gravity=False, star_gravity=False,
         contact_iterations: int = 4) -> RigidBodies:
    """One physics step (PhysX::Tick + MyScene::Tick force pass); dt is
    clamped to MAX_TIMESTEP (MyScene.ixx:395). `dt` is a number or a 0-d
    float32 tensor on the bodies' device (a frame captured as a CUDA graph
    reads it at every replay, as the reference traces it). Returns the new
    state."""
    if not isinstance(dt, torch.Tensor):
        # A fill on the device, not a copy from the host.
        dt = torch.full((), float(dt), dtype=torch.float32,
                        device=b.position.device)
    dt = torch.clamp(dt, max=MAX_TIMESTEP)
    accel = _accelerations(b, earth_gravity, star_gravity)
    dynamic = (b.inv_mass > 0)[:, None]
    velocity = torch.where(dynamic, b.velocity + accel * dt, b.velocity)
    position = torch.where(dynamic, b.position + velocity * dt, b.position)
    position, velocity = _resolve_contacts(b, position, velocity,
                                           contact_iterations)
    rotation = m.quat_integrate(b.rotation, b.angular_velocity, dt)
    return dataclasses.replace(b, position=position, velocity=velocity,
                               rotation=rotation)
