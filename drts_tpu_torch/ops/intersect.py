"""Ray-sphere closest hit and any hit (port of ``drts_tpu/ops/intersect.py``).

``intersect_spheres`` packs the rays planar and hands them to a kernel in
``intersect_kernels``: the Morton-table kernel (B1) when a MortonAccel is
passed, or its tensor-core form (B12a) when the accel carries the
tensor-core kernels' A-matrices (``mxu_a``, built under the MXU opt-in
``models/clusters._USE_MXU``); the
cluster-culled kernel (B13) when a ClusteredAccel is; the brute-force
kernel (B11) when none is. ``intersect_spheres_any`` is the shadow ray:
the any-hit kernel (B2) over the Morton table and its chunk bounds (B12b
with ``mxu_a``), or, with a ClusteredAccel or no accel, the hit bit of
the closest hit (B13, B11) where its object is not the excluded one.
The reference's 8x128 screen-tile ray order is a TPU block-culling aid;
results do not depend on it, and these kernels cull per ray or per warp
(B1, B2, B12, B13) or not at all (B11), so rays keep pixel order
(neighbouring lanes of a warp still share most of their work).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import clusters as clusters_mod
from ..utils import math as m
from . import intersect_kernels as ik


@dataclasses.dataclass(frozen=True)
class SphereHit:
    """Per-ray hit record (the reference's HitInfo, Shaders/HitInfo.hlsli)."""
    hit: torch.Tensor       # (...,) bool
    t: torch.Tensor         # (...,) distance (inf on miss)
    index: torch.Tensor     # (...,) int64 sphere index (0 on miss)
    position: torch.Tensor  # (..., 3) world hit position


def pack_rays(origin, direction, t_min, t_max):
    """Flat (N, 3)/(N,) rays -> contiguous planar (8, N) float32
    [ox oy oz dx dy dz tmin tmax]."""
    return torch.cat([origin.T, direction.T, t_min[None], t_max[None]]
                     ).to(torch.float32).contiguous()


def pack_spheres(centers, radii):
    """(K, 3) + (K,) -> planar (4, K) [cx cy cz r]."""
    return torch.cat([centers.T, radii[None]]).to(torch.float32).contiguous()


def _flat(x, lead, n: int, device):
    """`x`, a tensor or a number broadcastable to `lead`, as an (n,)
    float32 row on `device`; a number is filled there (no host copy)."""
    return torch.broadcast_to(m.as_f32(x, device), lead).reshape(n)


def intersect_spheres(origin, direction, t_min, t_max, centers, radii,
                      block_size: int = 16384, accel=None) -> SphereHit:
    """Closest hit of rays against all spheres.

    origin/direction: (..., 3); t_min/t_max broadcastable to (...,) with
    t_min >= 0; centers (K, 3); radii (K,). With a MortonAccel the hit t is
    truncated down (the packed encoding); models/scene.surface_attributes
    refines it, with the normal and the rest of the surface. With a
    ClusteredAccel or none it is exact.
    ``block_size`` sizes the plain versions' ray blocks."""
    lead = origin.shape[:-1]
    n = origin[..., 0].numel()

    def flat(x):
        return _flat(x, lead, n, origin.device)

    rays = pack_rays(origin.reshape(n, 3), direction.reshape(n, 3),
                     flat(t_min), flat(t_max))
    if isinstance(accel, clusters_mod.MortonAccel):
        if accel.mxu_a is not None:
            t_best, idx = ik.intersect_morton_mxu(
                rays, accel.table, accel.bounds, accel.mxu_a, block_size)
        else:
            t_best, idx = ik.intersect_morton(rays, accel.table,
                                              accel.bounds, block_size)
    elif isinstance(accel, clusters_mod.ClusteredAccel):
        t_best, idx = ik.intersect_clustered(
            rays, accel.bounds_tbl, accel.members_tbl, accel.n_clusters,
            accel.max_members, block_size)
        # The reference's clamp (drts_tpu/ops/intersect.py:180-187).
        idx = torch.clamp(idx, max=centers.shape[0] - 1)
    elif accel is None:
        t_best, idx = ik.intersect_brute(rays, pack_spheres(centers, radii),
                                         block_size)
    else:
        raise TypeError(f"unsupported accel {type(accel).__name__}")
    return _make_hit(origin, direction, t_best.reshape(lead),
                     idx.reshape(lead).long())


def intersect_spheres_any(origin, direction, t_min, t_max,
                          block_size: int = 16384, exclude_index=None,
                          accel=None, centers=None, radii=None):
    """Any hit (shadow / visibility ray): True where a sphere other than
    the ray's `exclude_index` object (the target light; None excludes
    nothing) has its hit t in [t_min, t_max].

    With a MortonAccel this is the any-hit kernel over its table (the
    reference's ``_anyhit_kernel``, or ``_anyhit_mxu_kernel`` when the
    accel carries ``mxu_a``). With a ClusteredAccel or no accel it is the
    reference's other function: the closest hit over `centers`, `radii`
    (B13 over the accel's tables, B11 without), and a ray is blocked where
    that closest sphere is not the excluded one."""
    if accel is None or isinstance(accel, clusters_mod.ClusteredAccel):
        if centers is None or radii is None:
            raise ValueError("the any-hit through the closest hit needs "
                             "centers and radii, which were not given")
        hit = intersect_spheres(origin, direction, t_min, t_max, centers,
                                radii, block_size, accel=accel)
        if exclude_index is not None:
            return hit.hit & (hit.index != exclude_index)
        return hit.hit
    if not isinstance(accel, clusters_mod.MortonAccel):
        raise TypeError(f"unsupported accel {type(accel).__name__}")
    lead = origin.shape[:-1]
    n = origin[..., 0].numel()

    def flat(x):
        return _flat(x, lead, n, origin.device)

    rays = pack_rays(origin.reshape(n, 3), direction.reshape(n, 3),
                     flat(t_min), flat(t_max))
    exclude = flat(-1.0 if exclude_index is None else exclude_index)
    rays9 = torch.cat([rays, exclude[None]]).contiguous()
    if accel.mxu_a is not None:
        occ = ik.occlusion_morton_mxu(rays9, accel.table, accel.bounds,
                                      accel.mxu_a, block_size)
    else:
        occ = ik.occlusion_morton(rays9, accel.table, accel.bounds,
                                  block_size)
    return occ.reshape(lead)


def _make_hit(origin, direction, t_best, idx) -> SphereHit:
    hit = torch.isfinite(t_best)
    t_safe = torch.where(hit, t_best, 0.0)
    position = origin + direction * t_safe[..., None]
    return SphereHit(hit=hit, t=t_best, index=idx, position=position)


def safe_spawn_point(position, flat_normal, direction):
    """Offset a secondary-ray origin off the surface along the geometric
    normal, signed by travel direction (the analytic-sphere analogue of
    SelfIntersectionAvoidance::OffsetSpawnPoint)."""
    eps = 1e-4 * torch.clamp(m.length(position, keepdims=True), min=1.0)
    side = m.sign_not_zero(m.dot(direction, flat_normal))[..., None]
    return position + flat_normal * side * eps
