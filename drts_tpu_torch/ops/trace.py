"""Scene-level closest hit and visibility (port of
``drts_tpu/ops/trace.py``): spheres and instanced triangle meshes merged
by closest t into one shading-ready HitSurface, alpha-tested hits rejected
by re-tracing past them for a bounded number of rounds; and the any-hit
visibility ray over spheres and mesh instances.

Hit-index space: [0, K) sphere instances, [K, K+M) mesh instances; both
resolve through the same packed object table (models/scene.py).

The alpha test multiplies the material's alpha by its base-colour map's
alpha at level 0 ("nearest0"). A deforming mesh (``TriMesh.
vertex_motion``) gives its hits a ``prev_offset``: the per-vertex motion
at the hit's barycentrics, scaled by the instance scale.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import scene as scene_mod
from ..utils import math as m
from . import intersect, shading, trimesh


def _where_nd(mask, a, b):
    mask = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(mask, a, b)


def _closest_hit(scene, origin, direction, t_min, t_max, block_size, accel):
    """Spheres and mesh instances, merged by closest t. Returns (SphereHit
    with the combined index, TriHit or None)."""
    lead = origin.shape[:-1]
    dev = origin.device
    if scene.center.shape[0] == 0:
        # All-mesh scene (models/myscene.as_mesh_scene): no sphere sweep.
        hit = intersect.SphereHit(
            hit=torch.zeros(lead, dtype=torch.bool, device=dev),
            t=torch.full(lead, float("inf"), device=dev),
            index=torch.zeros(lead, dtype=torch.int64, device=dev),
            position=origin)
    else:
        hit = intersect.intersect_spheres(origin, direction, t_min, t_max,
                                          scene.center, scene.radius,
                                          block_size, accel=accel)
    if scene.mesh is None:
        return hit, None
    mi = scene.mesh_instances
    k = scene.center.shape[0]
    t_max = m.as_f32(t_max, dev)
    # Mesh hits only count when closer than the best sphere hit.
    bound = torch.where(hit.hit, hit.t, torch.broadcast_to(t_max, lead))
    tri = trimesh.intersect_instances(origin, direction, t_min, bound,
                                      scene.mesh, mi.center, mi.rotation,
                                      mi.scale, block_size=block_size)
    t = torch.where(tri.hit, tri.t, hit.t)
    idx = torch.where(tri.hit, k + tri.instance, hit.index)
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    merged = intersect.SphereHit(
        hit=hit.hit | tri.hit, t=t, index=idx,
        position=origin + direction * t_safe[..., None])
    return merged, tri


def _surface_of(scene, hit, tri, ray_direction, table):
    """HitSurface of the merged hit; mesh lanes get interpolated vertex
    attributes (HitInfo::Initialize for triangles)."""
    surf = scene_mod.surface_attributes(scene, hit, ray_direction, table)
    if tri is None:
        return surf
    mi = scene.mesh_instances
    n_sh, uv_m, tan_m = trimesh.interpolate_attributes(scene.mesh, tri,
                                                       mi.rotation)
    # Geometric (face) normal for self-intersection avoidance.
    e1 = scene.mesh.e1[tri.face]
    e2 = scene.mesh.e2[tri.face]
    gn = m.normalize(m.quat_rotate(mi.rotation[tri.instance],
                                   m.cross(e1, e2)))
    is_front = m.dot(gn, ray_direction) < 0.0
    n_sh = torch.where(m.dot(n_sh, ray_direction)[..., None] < 0.0, n_sh,
                       -n_sh)
    mm = tri.hit
    surf = dataclasses.replace(
        surf,
        geometric_normal=_where_nd(mm, gn, surf.geometric_normal),
        shading_normal=_where_nd(mm, n_sh, surf.shading_normal),
        tangent=_where_nd(mm, tan_m, surf.tangent),
        uv=_where_nd(mm, uv_m, surf.uv),
        is_front_face=torch.where(mm, is_front, surf.is_front_face))
    vm_table = scene.mesh.vertex_motion
    if vm_table is not None:
        # Deforming mesh (GBufferGeneration.hlsl:62-91): the previous-minus-
        # current object motion at the hit's barycentrics, summed in the
        # reference's order, in world units of the current pose's axes
        # (the G-buffer's previous pose applies the rotation).
        corners = scene.mesh.faces[tri.face]
        b1, b2 = tri.barycentrics[..., 0:1], tri.barycentrics[..., 1:2]
        vm = (vm_table[corners[..., 0]] * (1.0 - b1 - b2)
              + vm_table[corners[..., 1]] * b1
              + vm_table[corners[..., 2]] * b2)
        vm = vm * mi.scale[tri.instance][..., None]
        surf = dataclasses.replace(
            surf, prev_offset=_where_nd(mm, vm, torch.zeros_like(vm)))
    return surf


def _merge_surface(mask, a, b):
    """Field by field, a where mask else b (the material included; an
    absent prev_offset stays absent)."""
    def merge(x, y):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: merge(getattr(x, f.name),
                                            getattr(y, f.name))
                              for f in dataclasses.fields(x)})
        if x is None:
            return None
        return _where_nd(mask, x, y)
    return merge(a, b)


def trace_scene(scene, origin, direction, t_min, t_max,
                block_size: int = 16384, accel=None, table=None,
                alpha_rounds: int = 0) -> scene_mod.HitSurface:
    """Closest hit against the whole scene -> HitSurface.

    ``alpha_rounds`` > 0 enables alpha-tested transparency (IsOpaque,
    ShadingHelpers.hlsli:105-159): hits whose material alpha falls below
    the material's cutoff are discarded and the ray is re-traced from just
    past them, up to that many rounds. With textures the alpha is the
    material's times its base-colour map's, read at level 0 through the
    map's set id (``"nearest0"``: cutout silhouettes must not blur)."""
    if table is None:
        table = scene_mod.object_table(scene)
    hit, tri = _closest_hit(scene, origin, direction, t_min, t_max,
                            block_size, accel)
    surf = _surface_of(scene, hit, tri, direction, table)

    for _ in range(alpha_rounds):
        alpha = surf.material.base_color[..., 3]
        if scene.textures is not None:
            alpha = alpha * shading.sample_packed(
                scene.textures, surf.material.base_color_map, surf.uv,
                "nearest0").alpha
        rejected = surf.valid & (alpha < surf.material.alpha_cutoff)
        t_min2 = torch.where(rejected,
                             surf.distance * (1.0 + 1e-4) + 1e-4, 0.0)
        t_max2 = torch.where(
            rejected, torch.broadcast_to(m.as_f32(t_max, origin.device),
                                         rejected.shape), -1.0)
        hit2, tri2 = _closest_hit(scene, origin, direction, t_min2, t_max2,
                                  block_size, accel)
        surf2 = _surface_of(scene, hit2, tri2, direction, table)
        surf = _merge_surface(rejected, surf2, surf)
    return surf


def occluded_scene(scene, origin, direction, max_dist, exclude_index,
                   block_size: int = 16384, accel=None):
    """Conservative any-hit visibility (RAB_GetConservativeVisibility):
    blocked where a sphere other than `exclude_index`, or any mesh
    instance, lies within [0, max_dist]. The mesh half takes no exclude
    index: a triangle light's own face is kept out by the caller's
    max_dist."""
    if scene.center.shape[0] == 0:
        occ = torch.zeros(max_dist.shape, dtype=torch.bool,
                          device=max_dist.device)
    else:
        occ = intersect.intersect_spheres_any(
            origin, direction, torch.zeros_like(max_dist), max_dist,
            block_size, exclude_index=exclude_index, accel=accel,
            centers=scene.center, radii=scene.radius)
    if scene.mesh is not None:
        mi = scene.mesh_instances
        occ = occ | trimesh.intersect_instances_any(
            origin, direction, torch.zeros_like(max_dist), max_dist,
            scene.mesh, mi.center, mi.rotation, mi.scale,
            block_size=block_size)
    return occ
