"""G-buffer generation (port of ``drts_tpu/ops/gbuffer.py``): primary
visibility through pinhole or thin-lens rays, material channels,
demodulation albedos and motion vectors (GBufferGeneration.hlsl:117-232),
deforming meshes' per-vertex motion included."""

from __future__ import annotations

import dataclasses

import torch

from ..models import scene as scene_mod
from ..utils import math as m
from ..utils import rng as rng_mod
from . import bxdf, camera as camera_mod, shading, sky, trace as trace_mod


@dataclasses.dataclass(frozen=True)
class GBuffer:
    """The reference's G-buffer channel set."""
    surf: scene_mod.HitSurface
    mat: shading.EvaluatedMaterial
    ray_origin: torch.Tensor       # (H, W, 3)
    ray_direction: torch.Tensor    # (H, W, 3)
    linear_depth: torch.Tensor     # (H, W) view-forward depth (inf miss)
    motion: torch.Tensor           # (H, W, 2) prev - current, pixels
    radiance: torch.Tensor         # (H, W, 3) primary emission / env miss
    diffuse_albedo: torch.Tensor   # (H, W, 3)
    specular_albedo: torch.Tensor  # (H, W, 3)


def generate(scene: scene_mod.SphereScene, cam: camera_mod.Camera,
             width: int, height: int, block_size: int = 16384,
             accel=None, thin_lens: bool = False,
             frame_index=0, rows=None) -> GBuffer:
    """Primary-ray pass. With ``thin_lens`` the primary rays sample the
    camera aperture (Camera.hlsli:43-54), each pixel from its own stream
    of ``frame_index``, so every pixel has its own ray origin. ``rows`` =
    (start, end) renders that band of the height-row frame (its pixels'
    NDC, streams and motion as in the whole frame)."""
    r0, r1 = rows if rows is not None else (0, height)
    ndc = camera_mod.pixel_ndc(width, height, cam.jitter, rows)
    if thin_lens:
        dev = ndc.device
        py, px = torch.meshgrid(torch.arange(r0, r1, device=dev),
                                torch.arange(width, device=dev),
                                indexing="ij")
        u2, _ = rng_mod.next_floats(
            rng_mod.init(px + 977, py + 557, frame_index), 2)
        ray_o, ray_d, t_min, t_max = camera_mod.generate_thin_lens_rays(
            cam, ndc, u2)
    else:
        ray_o, ray_d, t_min, t_max = camera_mod.generate_pinhole_rays(cam,
                                                                      ndc)
    t_min = torch.broadcast_to(t_min, (r1 - r0, width))
    t_max = torch.broadcast_to(t_max, (r1 - r0, width))

    table = scene_mod.object_table(scene)
    surf = trace_mod.trace_scene(scene, ray_o, ray_d, t_min, t_max,
                                 block_size, accel=accel, table=table,
                                 alpha_rounds=scene.alpha_test_rounds)
    mat = shading.evaluate_material(surf.material, surf.uv,
                                    surf.shading_normal, surf.tangent,
                                    scene.textures)

    sv = bxdf.make_surface_vectors(surf.is_front_face, surf.geometric_normal,
                                   mat.shading_normal)
    bs = bxdf.make_bsdf(mat.base_color, mat.metallic, mat.roughness, mat.ior,
                        mat.transmission, surf.is_front_face)
    diff_albedo, spec_albedo = bxdf.demodulation_factors(bs, sv, -ray_d)

    env = sky.environment_color(scene.env, ray_d)
    radiance = torch.where(surf.valid[..., None], mat.emission, env)

    fwd = m.normalize(cam.forward)
    depth = torch.where(surf.valid, m.dot(surf.position - cam.position, fwd),
                        float("inf"))

    # Motion vectors: world hit -> object space (current pose) -> world via
    # the previous pose -> previous camera NDC -> pixel delta.
    row = table[surf.object_index]
    obj_local = m.quat_rotate(m.quat_conj(row[..., 4:8]),
                              surf.position - row[..., 0:3])
    if surf.prev_offset is not None:
        # Deforming meshes: the interpolated per-vertex motion, added
        # before the previous pose (GBufferGeneration.hlsl:70-84).
        obj_local = obj_local + surf.prev_offset
    prev_world = row[..., 8:11] + m.quat_rotate(row[..., 11:15], obj_local)
    prev_ndc, _ = camera_mod.project_to_ndc(cam, prev_world, previous=True)
    cur_ndc, _ = camera_mod.project_to_ndc(cam, surf.position,
                                           previous=False)
    prev_px = camera_mod.ndc_to_pixel(prev_ndc, width, height)
    cur_px = camera_mod.ndc_to_pixel(cur_ndc, width, height)
    motion = torch.where(surf.valid[..., None], prev_px - cur_px, 0.0)

    return GBuffer(surf=surf, mat=mat, ray_origin=ray_o, ray_direction=ray_d,
                   linear_depth=depth, motion=motion, radiance=radiance,
                   diffuse_albedo=diff_albedo, specular_albedo=spec_albedo)
