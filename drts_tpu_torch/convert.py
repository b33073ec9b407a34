"""Turn the JAX package's state, given as numpy arrays, into the port's.

Each function reads the reference object's fields by name (any object with
those attributes will do, e.g. the reference dataclass after mapping
``np.asarray`` over its leaves), so this module needs no JAX. Covered:
``SphereScene`` with its ``Materials``, environment light (and its
lat-long map), ``PackedTextures``, ``TriMesh`` and ``MeshInstances``,
``Camera``,
``ClusterPlan``, ``MortonAccel``, ``RigidBodies``, ``Lights``,
``ReGIRGrid``, ``Reservoirs``, ``SHARCState``, ``DenoiserState``,
``TAAState`` and a whole ``FrameState``. ``device`` defaults to the card,
as every builder of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import backend
from .models import clusters, material, pipeline, scene as scene_mod
from .models import texpack
from .ops import (camera as camera_mod, denoise, light, physics, restir,
                  sharc, sky, taa, trimesh, trimesh_kernels as tk)


def _tensor(x, device):
    return torch.from_numpy(np.array(x)).to(backend.device(device))


def _fields(cls, src, device):
    return {f.name: _tensor(getattr(src, f.name), device)
            for f in dataclasses.fields(cls)}


def materials(src, device="cuda") -> material.Materials:
    return material.Materials(**_fields(material.Materials, src, device))


def _optional(x, device):
    return None if x is None else _tensor(x, device)


def environment(src, device="cuda") -> sky.EnvironmentLight:
    """The environment light with its lat-long map and quarter-size mip
    as they are (None where the reference has none)."""
    return sky.EnvironmentLight(
        color=_tensor(src.color, device),
        rotation=_tensor(src.rotation, device),
        texture=_optional(getattr(src, "texture", None), device),
        texture_low=_optional(getattr(src, "texture_low", None), device))


def packed_textures(src, device="cuda") -> texpack.PackedTextures:
    """The reference's uint32 rows become int32 tensors with the same
    bits."""
    def words(x):
        return None if x is None else _tensor(
            np.ascontiguousarray(np.asarray(x, np.uint32)).view(np.int32),
            device)
    return texpack.PackedTextures(
        rows=words(src.rows),
        emissive_mean=_tensor(src.emissive_mean, device),
        size=int(src.size), n_words=int(src.n_words),
        rows_half=words(src.rows_half), half_size=int(src.half_size),
        emissive_small=_optional(src.emissive_small, device))


def tri_mesh(src, device="cuda") -> trimesh.TriMesh:
    """A TriMesh with the reference's arrays as they are (its face order,
    its triangle table); index arrays become int64. The chunk spheres are
    built from that triangle table at the port's chunk size: the
    reference's tri_bounds has other rows and another chunk."""
    fields = {}
    for f in dataclasses.fields(trimesh.TriMesh):
        if f.name in ("tri_bounds", "tri_chunk"):
            continue
        value = getattr(src, f.name)
        if f.name == "inscribed_radius":
            fields[f.name] = float(value)
        elif value is not None:
            fields[f.name] = _tensor(value, device)
    fields["faces"] = fields["faces"].long()
    chunk = tk.TRI_CHUNK
    fields["tri_bounds"] = _tensor(tk.tri_chunk_bounds(
        np.asarray(src.tri_tbl, np.float32), chunk), device)
    fields["tri_chunk"] = chunk
    return trimesh.TriMesh(**fields)


def mesh_instances(src, device="cuda") -> scene_mod.MeshInstances:
    return scene_mod.MeshInstances(
        **_fields(scene_mod.MeshInstances, src, device))


def scene(src, device="cuda") -> scene_mod.SphereScene:
    """SphereScene with or without mesh instances and textures."""
    mesh = mi = None
    if src.mesh is not None:
        mesh = tri_mesh(src.mesh, device)
        mi = mesh_instances(src.mesh_instances, device)
    return scene_mod.SphereScene(
        mesh=mesh, mesh_instances=mi,
        center=_tensor(src.center, device),
        rotation=_tensor(src.rotation, device),
        prev_center=_tensor(src.prev_center, device),
        prev_rotation=_tensor(src.prev_rotation, device),
        radius=_tensor(src.radius, device),
        materials=materials(src.materials, device),
        env=environment(src.env, device),
        textures=(packed_textures(src.textures, device)
                  if src.textures is not None else None),
        alpha_test_rounds=int(src.alpha_test_rounds))


def camera(src, device="cuda") -> camera_mod.Camera:
    return camera_mod.Camera(**_fields(camera_mod.Camera, src, device))


def cluster_plan(src, device="cuda") -> clusters.ClusterPlan:
    return clusters.ClusterPlan(
        member_object=_tensor(src.member_object, device).long(),
        num_clusters=int(src.num_clusters))


def morton_accel(src, device="cuda") -> clusters.MortonAccel:
    """The reference's table and chunk bounds (``bounds_tbl`` without its
    padding columns), with the port's count row: per chunk, one past its
    last slot of positive radius. That is the plan's filled-slot count
    (members fill a chunk's first slots and have radii), read off the
    table because the reference's accel holds no plan in its sorted chunk
    order; a slot past it has |c|^2 - r^2 = 1e30 and cannot block."""
    n_chunks, chunk = int(src.n_chunks), int(src.chunk)
    table = _tensor(src.table, device)
    filled = table[3].reshape(n_chunks, chunk) > 0.0
    slot = torch.arange(1, chunk + 1, device=table.device)
    count = torch.where(filled, slot, 0).amax(dim=1).to(torch.float32)
    bounds = torch.cat([_tensor(src.bounds_tbl, device)[:, :n_chunks],
                        count[None]]).contiguous()
    return clusters.MortonAccel(table=table, bounds=bounds,
                                n_chunks=n_chunks, chunk=chunk)


def rigid_bodies(src, device="cuda") -> physics.RigidBodies:
    scalars = {"spring_rest_y": float, "earth_index": int,
               "star_index": int}
    return physics.RigidBodies(**{
        f.name: (scalars[f.name](np.asarray(getattr(src, f.name)))
                 if f.name in scalars
                 else _tensor(getattr(src, f.name), device))
        for f in dataclasses.fields(physics.RigidBodies)})


def lights(src, device="cuda") -> light.Lights:
    """Lights of either kind (`tri_light_id` becomes int64)."""
    has_tri = bool(getattr(src, "has_triangles", False))
    return light.Lights(
        tri_light_id=(_tensor(src.tri_light_id, device).long() if has_tri
                      else None),
        has_triangles=has_tri,
        **{name: _tensor(getattr(src, name), device)
           for name in ("center", "radius", "emission", "power",
                        "total_power", "table", "compact", "cdf",
                        "dropped_lights", "dropped_power_frac")})


def regir_grid(src, device="cuda") -> restir.ReGIRGrid:
    return restir.ReGIRGrid(
        light_index=_tensor(src.light_index, device).long(),
        weight=_tensor(src.weight, device),
        packed=_tensor(src.packed, device),
        origin=_tensor(src.origin, device),
        cell_size=_tensor(src.cell_size, device))


def reservoirs(src, device="cuda") -> restir.Reservoirs:
    fields = _fields(restir.Reservoirs, src, device)
    fields["light_index"] = fields["light_index"].long()
    return restir.Reservoirs(**fields)


def sharc_state(src, device="cuda") -> sharc.SHARCState:
    """The uint32 fingerprints become int64 (values in [0, 2^32))."""
    fields = _fields(sharc.SHARCState, src, device)
    fields["fingerprint"] = _tensor(
        np.asarray(src.fingerprint).astype(np.int64), device)
    return sharc.SHARCState(**fields)


def denoiser_state(src, device="cuda") -> denoise.DenoiserState:
    return denoise.DenoiserState(**_fields(denoise.DenoiserState, src,
                                           device))


def taa_state(src, device="cuda") -> taa.TAAState:
    return taa.TAAState(**_fields(taa.TAAState, src, device))


def frame_state(src, device="cuda") -> pipeline.FrameState:
    """A whole FrameState, its host frame count from frame_index."""
    return pipeline.FrameState(
        frame_index=_tensor(src.frame_index, device).long(),
        bodies=rigid_bodies(src.bodies, device),
        scene=scene(src.scene, device),
        denoiser=denoiser_state(src.denoiser, device),
        taa=taa_state(src.taa, device),
        reservoirs=reservoirs(src.reservoirs, device),
        prev_depth=_tensor(src.prev_depth, device),
        prev_normal=_tensor(src.prev_normal, device),
        prev_surface_rows=_tensor(src.prev_surface_rows, device),
        sharc=sharc_state(src.sharc, device),
        earth_gravity=_tensor(src.earth_gravity, device),
        star_gravity=_tensor(src.star_gravity, device),
        counters={k: _tensor(v, device) for k, v in src.counters.items()},
        frame_count=int(np.asarray(src.frame_index)))
