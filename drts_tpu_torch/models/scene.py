"""Scene representation (port of ``drts_tpu/models/scene.py``): sphere
instances and triangle-mesh instances with current and previous poses,
per-object materials, the environment light, and the packed per-object
attribute table.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import sky
from ..utils import math as m
from . import geometry
from .material import Materials


@dataclasses.dataclass(frozen=True)
class MeshInstances:
    """Triangle-mesh instances (the reference's geosphere BLAS instancing,
    Scene.ixx:225-284): rigid transforms with a uniform scale. Their
    material rows sit at [K, K+M) of scene.materials, after the K sphere
    materials, so the combined hit-index space is [0, K) spheres |
    [K, K+M) mesh instances."""
    center: torch.Tensor         # (M, 3)
    rotation: torch.Tensor       # (M, 4) quaternion, object->world
    prev_center: torch.Tensor    # (M, 3)
    prev_rotation: torch.Tensor  # (M, 4)
    scale: torch.Tensor          # (M,)


@dataclasses.dataclass(frozen=True)
class SphereScene:
    """All scene state a render pass reads (SURVEY.md §1 L2).

    ``textures`` are the packed texture sets (models/texpack.
    PackedTextures) or None: one quad-duplicated row gather per hit
    replaces the reference's six map samples. ``mesh`` (an ops.trimesh.
    TriMesh) with ``mesh_instances`` is traced by the closest-hit and
    visibility paths."""
    center: torch.Tensor         # (K, 3)
    rotation: torch.Tensor       # (K, 4) quaternion, object->world
    prev_center: torch.Tensor    # (K, 3)
    prev_rotation: torch.Tensor  # (K, 4)
    radius: torch.Tensor         # (K,)
    materials: Materials         # (K+M,) rows when mesh instances exist
    env: sky.EnvironmentLight
    textures: object = None
    mesh: object = None
    mesh_instances: MeshInstances | None = None
    # Alpha-test re-trace rounds (IsOpaque); 0 = all opaque.
    alpha_test_rounds: int = 0

    @property
    def object_count(self) -> int:
        return self.center.shape[0]


def advance_pose(scene: SphereScene, new_center, new_rotation) -> SphereScene:
    """Per-frame pose update, keeping the previous pose for motion vectors
    (the functional form of Scene::Refresh, Scene.ixx:185-219)."""
    return dataclasses.replace(
        scene, prev_center=scene.center, prev_rotation=scene.rotation,
        center=new_center, rotation=new_rotation)


@dataclasses.dataclass(frozen=True)
class HitSurface:
    """Shading-ready surface attributes (RaytracingHelpers.hlsli:57-133),
    computed analytically for sphere instances."""
    valid: torch.Tensor             # (...,) bool
    position: torch.Tensor          # (..., 3)
    geometric_normal: torch.Tensor  # (..., 3) outward unit normal
    shading_normal: torch.Tensor    # (..., 3) front-flipped
    tangent: torch.Tensor           # (..., 3)
    uv: torch.Tensor                # (..., 2)
    is_front_face: torch.Tensor     # (...,)
    distance: torch.Tensor          # (...,)
    object_index: torch.Tensor      # (...,) int
    material: Materials             # per-ray gathered material
    # (..., 3) previous - current object-space offset at the hit: the
    # interpolated per-vertex motion of a deforming mesh, in the current
    # pose's object axes scaled to world units (zero on other lanes);
    # None when no mesh deforms. The G-buffer adds it before the previous
    # pose (GBufferGeneration.hlsl:62-91).
    prev_offset: torch.Tensor | None = None


# Packed per-object attribute table, one row per object. Columns:
# 0:3 center | 3 radius | 4:8 rotation | 8:11 prev_center |
# 11:15 prev_rotation | 15:18 base_color rgb | 18 alpha | 19:22 emission |
# 22 metallic | 23 roughness | 24 ior | 25 transmission |
# 26 base_color_map | 27 normal_map | 28 metallic_map | 29 roughness_map |
# 30 alpha_cutoff | 31 emissive_color_map | 32 transmission_map.
# Rows [K, K+M) are mesh instances: radius 0, centre and rotation the
# instance transform, so the G-buffer's rigid-motion reprojection works
# unchanged and surface_attributes' Newton step leaves a mesh t alone.


def object_table(scene: SphereScene) -> torch.Tensor:
    mat = scene.materials
    center, radius, rotation = scene.center, scene.radius, scene.rotation
    prev_center, prev_rotation = scene.prev_center, scene.prev_rotation
    if scene.mesh_instances is not None:
        mi = scene.mesh_instances
        center = torch.cat([center, mi.center])
        radius = torch.cat([radius, torch.zeros_like(mi.scale)])
        rotation = torch.cat([rotation, mi.rotation])
        prev_center = torch.cat([prev_center, mi.prev_center])
        prev_rotation = torch.cat([prev_rotation, mi.prev_rotation])
    cols = [
        center, radius[:, None], rotation,
        prev_center, prev_rotation,
        mat.base_color[:, :3], mat.base_color[:, 3:4], mat.emission(),
        mat.metallic[:, None], mat.roughness[:, None], mat.ior[:, None],
        mat.transmission[:, None],
        mat.base_color_map[:, None].float(),
        mat.normal_map[:, None].float(),
        mat.metallic_map[:, None].float(),
        mat.roughness_map[:, None].float(),
        mat.alpha_cutoff[:, None],
        mat.emissive_color_map[:, None].float(),
        mat.transmission_map[:, None].float(),
    ]
    return torch.cat(cols, dim=-1)


def surface_attributes(scene: SphereScene, hit, ray_direction,
                       table: torch.Tensor | None = None) -> HitSurface:
    """Shading attributes from a SphereHit (HitInfo::Initialize,
    HitInfo.hlsli:96-134), all per-object values from one table gather.

    The hit distance is Newton-refined: the Morton kernel returns t with
    its low mantissa bits truncated (the packed closest-hit encoding), and
    one Newton step on f(t) = |o + t d - c|^2 - r^2 recovers full float32
    precision. It is a no-op (f = 0) for exact-t producers."""
    if table is None:
        table = object_table(scene)
    # One row gather (the reference's fetch_rows, a one-hot MXU matmul at
    # frame scale on the TPU, with the same result).
    row = table[hit.index]
    center = row[..., 0:3]
    radius = row[..., 3]

    p_c = hit.position - center
    f = m.dot(p_c, p_c) - radius * radius
    df = 2.0 * m.dot(ray_direction, p_c)
    refine = hit.hit & (radius > 0.0) & (torch.abs(df) > 1e-12)
    delta = torch.where(refine, -f / torch.where(refine, df, 1.0), 0.0)
    t = hit.t + delta
    position = hit.position + ray_direction * delta[..., None]

    normal = m.normalize(position - center)
    is_front = m.dot(normal, ray_direction) < 0.0
    shading_normal = torch.where(is_front[..., None], normal, -normal)
    if scene.textures is not None:
        # The instance-rotated lat-long parametrization (the geosphere's
        # UV layout, MyScene.ixx:53-88).
        rot = row[..., 4:8]
        obj_normal = m.quat_rotate(m.quat_conj(rot), normal)
        uv = m.to_latlong(obj_normal)
        tangent = m.quat_rotate(rot, geometry.sphere_tangent(obj_normal))
    else:
        # No texture maps in flight: the lat-long UV is unused.
        uv = torch.zeros(hit.t.shape + (2,), dtype=torch.float32,
                         device=hit.t.device)
        tangent, _ = m.orthonormal_basis(shading_normal)

    material = Materials(
        base_color=torch.cat([row[..., 15:18], row[..., 18:19]], dim=-1),
        emissive_strength=torch.ones_like(hit.t),
        emissive_color=row[..., 19:22],
        metallic=row[..., 22],
        roughness=row[..., 23],
        ior=row[..., 24],
        transmission=row[..., 25],
        alpha_cutoff=row[..., 30],
        base_color_map=row[..., 26].to(torch.int32),
        emissive_color_map=row[..., 31].to(torch.int32),
        metallic_map=row[..., 28].to(torch.int32),
        roughness_map=row[..., 29].to(torch.int32),
        normal_map=row[..., 27].to(torch.int32),
        transmission_map=row[..., 32].to(torch.int32),
    )
    return HitSurface(
        valid=hit.hit, position=position, geometric_normal=normal,
        shading_normal=shading_normal, tangent=tangent, uv=uv,
        is_front_face=is_front, distance=t, object_index=hit.index,
        material=material)
