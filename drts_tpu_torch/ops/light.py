"""Light preparation and sampling (port of ``drts_tpu/ops/light.py``).

The scene's lights are emissive sphere instances and, where the scene has
mesh instances, every face of an emissive instance (a triangle light).
``prepare`` builds the per-frame power table, the compact list of the
``MAX_LIGHTS`` brightest emitters of both kinds (reservoirs carry compact
ids) and its power CDF; sphere lights are sampled by solid-angle cone
sampling, triangle lights uniformly by area with the solid-angle pdf. The
reference's one-hot MXU row fetch (``light._onehot_fetch``) is a plain
index gather here: the same rows exactly. With textures, a sphere
light's radiance takes its set's whole-map emissive mean (a lat-long
sphere's footprint is the whole map), and a triangle light's the area
average of its emissive map over the face's UV triangle
(``_face_emissive_avg``, LightPreparation.hlsl:86-128).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.scene import SphereScene
from ..utils import math as m

# Static capacity of the compact light list (top-power emitters).
MAX_LIGHTS = 128


@dataclasses.dataclass(frozen=True)
class Lights:
    """LightInfo SoA: object-indexed fields over all K sphere objects and
    the COMPACT light-indexed table over the L = MAX_LIGHTS brightest
    emitters (-1 in col 8 and zeros elsewhere for empty rows):
      sphere rows:   cols 0:3 center | 3 radius | 4:7 radiance | 7 power |
                     8 object id
      triangle rows (only when the scene has mesh instances; the table
      widens to 16): cols 0:3 centroid | 3 = 0 | 4:7 radiance | 7 power |
                     8 object id (K + instance) | 9:12 edge1 | 12:15 edge2 |
                     15 kind (1 = triangle)"""
    center: torch.Tensor       # (K, 3)
    radius: torch.Tensor       # (K,)
    emission: torch.Tensor     # (K, 3) radiance
    power: torch.Tensor        # (K,) luminance x area
    total_power: torch.Tensor  # scalar
    table: torch.Tensor        # (K, 9) object rows [c r e power light_id]
    compact: torch.Tensor      # (L, 9|16) light rows (layout above)
    cdf: torch.Tensor          # (L,) normalized inclusive power CDF
    # Triangle extension (None for sphere-only scenes): compact light id of
    # each (instance, face), flattened (M*F,) int64, -1 = not a light.
    tri_light_id: torch.Tensor | None = None
    # Cap accounting: emitters beyond the MAX_LIGHTS cut, and their share of
    # the total power.
    dropped_lights: torch.Tensor | None = None      # scalar count
    dropped_power_frac: torch.Tensor | None = None  # scalar in [0, 1]
    has_triangles: bool = False


@dataclasses.dataclass(frozen=True)
class LightRows:
    """Per-ray gathered light attributes (one wide fetch)."""
    center: torch.Tensor    # (..., 3)
    radius: torch.Tensor    # (...,)
    emission: torch.Tensor  # (..., 3)
    power: torch.Tensor     # (...,)
    aux: torch.Tensor       # (...,) int64: object id for compact rows,
                            # light id (-1 = none) for object rows
    # Triangle columns (None when fetched from a sphere-only table).
    e1: torch.Tensor | None = None    # (..., 3)
    e2: torch.Tensor | None = None    # (..., 3)
    kind: torch.Tensor | None = None  # (...,) bool: True = triangle


def fetch_rows(lights: Lights, idx) -> LightRows:
    """COMPACT-indexed light fetch; `aux` is the source object id. Ids are
    clamped into the table, so a negative id reads row 0 where the
    reference's gather counts it from the end; compact ids come from
    sample_light_index, in [0, L), so no path passes one."""
    row = lights.compact[torch.clamp(idx, 0, lights.compact.shape[0] - 1)]
    tri = {}
    if lights.has_triangles:
        tri = dict(e1=row[..., 9:12], e2=row[..., 12:15],
                   kind=row[..., 15] > 0.5)
    return LightRows(center=row[..., 0:3], radius=row[..., 3],
                     emission=row[..., 4:7], power=row[..., 7],
                     aux=torch.round(row[..., 8]).long(), **tri)


def fetch_rows_object(lights: Lights, obj_idx) -> LightRows:
    """OBJECT-indexed fetch (for BRDF-ray candidates that hit geometry);
    `aux` is the compact light id, -1 where the object is no light. Ids
    index as the reference's gather does: a negative id counts from the
    end (-1, a miss, reads the last row), and ids are then clamped into
    the table."""
    k = lights.table.shape[0]
    row = lights.table[torch.clamp(torch.where(obj_idx < 0, obj_idx + k,
                                               obj_idx), 0, k - 1)]
    return LightRows(center=row[..., 0:3], radius=row[..., 3],
                     emission=row[..., 4:7], power=row[..., 7],
                     aux=torch.round(row[..., 8]).long())


def _face_emissive_avg(em_small, uvs, faces):
    """Per-(set, face) filtered emissive average -> (T', F, 3): the exact
    area average of the 32^2 emissive mip over each face's UV triangle
    (texel centres inside it, U-wrap aware), and a bilinear tap at the
    wrapped UV centroid for faces that cover no texel centre. The
    reference's per-triangle SampleGrad whose footprint covers the
    triangle (LightPreparation.hlsl:86-128); one (F, S^2) mask product."""
    t, s = em_small.shape[0], em_small.shape[1]
    dev = em_small.device
    uv = uvs[faces]                       # (F, 3, 2)
    u = uv[..., 0]
    # Canonicalize the U wrap per face: each corner into corner 0's period.
    u = u - torch.round(u - u[..., :1])
    a = torch.stack([u[..., 0], uv[..., 0, 1]], -1)  # (F, 2)
    b = torch.stack([u[..., 1], uv[..., 1, 1]], -1)
    c = torch.stack([u[..., 2], uv[..., 2, 1]], -1)

    tc = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    py, px = torch.meshgrid(tc, tc, indexing="ij")   # rows = v
    p = torch.stack([px.reshape(-1), py.reshape(-1)], -1)   # (P, 2)

    def inside(pp):
        def edge(q0, q1):
            return ((q1[:, None, 0] - q0[:, None, 0])
                    * (pp[None, :, 1] - q0[:, None, 1])
                    - (q1[:, None, 1] - q0[:, None, 1])
                    * (pp[None, :, 0] - q0[:, None, 0]))
        e0, e1_, e2_ = edge(a, b), edge(b, c), edge(c, a)
        return (((e0 >= 0) & (e1_ >= 0) & (e2_ >= 0))
                | ((e0 <= 0) & (e1_ <= 0) & (e2_ <= 0)))

    shift = m.const((1.0, 0.0), device=dev)
    # Periodic U: a texel centre counts if it, or a copy one period away,
    # lies inside the canonicalized triangle.
    maskf = (inside(p) | inside(p + shift) | inside(p - shift)).to(
        torch.float32)                                    # (F, P)
    count = maskf.sum(dim=1)                              # (F,)
    sums = torch.einsum("fp,tpc->tfc", maskf, em_small.reshape(t, s * s, 3))
    avg = sums / torch.clamp(count, min=1.0)[None, :, None]

    # Sub-texel fallback: bilinear tap at the wrapped UV centroid (the
    # texel-centre convention of shading.sample_packed).
    cen = (a + b + c) / 3.0
    x = torch.remainder(cen[:, 0], 1.0) * s - 0.5
    y = cen[:, 1] * s - 0.5
    x0 = torch.floor(x)
    y0c = torch.clamp(torch.floor(y), 0, s - 1)
    fx = (x - x0)[:, None]
    fy = torch.clamp(y - y0c, 0.0, 1.0)[:, None]
    x0i = torch.remainder(x0.long(), s)
    x1i = torch.remainder(x0i + 1, s)
    y0i = y0c.long()
    y1i = torch.clamp(y0i + 1, 0, s - 1)
    tap = (em_small[:, y0i, x0i] * (1 - fx) * (1 - fy)
           + em_small[:, y0i, x1i] * fx * (1 - fy)
           + em_small[:, y1i, x0i] * (1 - fx) * fy
           + em_small[:, y1i, x1i] * fx * fy)
    return torch.where((count > 0)[None, :, None], avg, tap)


def prepare(scene: SphereScene) -> Lights:
    """CountLights/PrepareResources/Process analogue
    (LightPreparation.ixx:52-133): emission -> power -> compact light list
    -> sampling CDF. Sphere power is luminance x area (4 pi r^2). Every
    face of an emissive mesh instance is a triangle light with world-space
    edges and power = area x luminance (one common pi dropped on both
    kinds, so a mixed scene samples them in proportion to emitted
    power). With textures, an emissive-mapped sphere's radiance is scaled
    by its set's whole-map mean and a triangle light's by its face's
    filtered average of the map (_face_emissive_avg)."""
    k = scene.center.shape[0]
    dev = scene.center.device
    all_emission = scene.materials.emission()
    tex = scene.textures
    if tex is not None:
        # Per-set emissive-map mean, computed when the sets were baked.
        emap_all = scene.materials.emissive_color_map
        avg = tex.emissive_mean[torch.clamp(emap_all, min=0).long()]
        all_emission = all_emission * torch.where(
            (emap_all >= 0)[:, None], avg, 1.0)
    emission = all_emission[:k]
    power = m.luminance(emission) * (4.0 * math.pi) \
        * scene.radius * scene.radius

    has_tri = scene.mesh is not None and scene.mesh_instances is not None
    if has_tri:
        mesh, mi = scene.mesh, scene.mesh_instances
        mcount, f = mi.center.shape[0], mesh.v0.shape[0]
        em_inst = all_emission[k:k + mcount]              # (M, 3)
        if tex is not None and tex.emissive_small is not None:
            # Raw material emission x the face's footprint average of its
            # emissive map, in place of the whole-map mean above.
            emap_i = scene.materials.emissive_color_map[k:k + mcount]
            face_avg = _face_emissive_avg(tex.emissive_small, mesh.uvs,
                                          mesh.faces)     # (T', F, 3)
            raw_em = scene.materials.emission()[k:k + mcount]
            per_face = face_avg[torch.clamp(emap_i, min=0).long()]
            em_face = torch.where((emap_i >= 0)[:, None, None],
                                  raw_em[:, None, :] * per_face,
                                  em_inst[:, None, :])   # (M, F, 3)
        else:
            em_face = torch.broadcast_to(em_inst[:, None, :],
                                         (mcount, f, 3))
        rot = mi.rotation[:, None, :]                     # (M, 1, 4)
        scl = mi.scale[:, None, None]
        v0w = mi.center[:, None, :] + m.quat_rotate(rot, mesh.v0[None] * scl)
        e1w = m.quat_rotate(rot, mesh.e1[None] * scl)     # (M, F, 3)
        e2w = m.quat_rotate(rot, mesh.e2[None] * scl)
        area = 0.5 * m.length(m.cross(e1w, e2w))          # (M, F)
        tri_power = (m.luminance(em_face) * area).reshape(-1)
        tri_em = em_face.reshape(-1, 3)
        tri_centroid = (v0w + (e1w + e2w) / 3.0).reshape(-1, 3)
        tri_e1 = e1w.reshape(-1, 3)
        tri_e2 = e2w.reshape(-1, 3)
        tri_obj = k + torch.arange(mcount * f, device=dev) // f
        cand_power = torch.cat([power, tri_power])
    else:
        cand_power = power
    total = torch.sum(cand_power)

    # Compact list: the top-MAX_LIGHTS by power, ties to the lower index
    # (jax.lax.top_k order). Powers follow static materials, radii and
    # mesh topology, so every compact id is frame-stable (temporal reuse
    # stores them).
    n_l = min(MAX_LIGHTS, cand_power.shape[0])
    top_power, top_cand = torch.sort(cand_power, descending=True, stable=True)
    top_power, top_cand = top_power[:n_l], top_cand[:n_l]
    pad = MAX_LIGHTS - n_l
    if pad:
        top_power = torch.cat([top_power, top_power.new_zeros(pad)])
        top_cand = torch.cat([top_cand, top_cand.new_zeros(pad)])
    is_light = top_power > 0
    top_cand = torch.where(is_light, top_cand, -1)
    safe_cand = torch.clamp(top_cand, min=0)

    tri_light_id = None
    if has_tri:
        n_tri = tri_centroid.shape[0]
        is_tri = safe_cand >= k
        tri_i = torch.clamp(safe_cand - k, 0, n_tri - 1)
        if k == 0:
            # All-mesh scene (myscene.as_mesh_scene): every candidate is a
            # triangle, and the empty sphere table cannot be gathered from.
            c_center = tri_centroid[tri_i]
            c_radius = torch.zeros(MAX_LIGHTS, dtype=torch.float32,
                                   device=dev)
            c_em = tri_em[tri_i]
            c_obj = tri_obj[tri_i]
        else:
            sph_i = torch.clamp(safe_cand, 0, k - 1)
            c_center = torch.where(is_tri[:, None], tri_centroid[tri_i],
                                   scene.center[sph_i])
            c_radius = torch.where(is_tri, 0.0, scene.radius[sph_i])
            c_em = torch.where(is_tri[:, None], tri_em[tri_i],
                               emission[sph_i])
            c_obj = torch.where(is_tri, tri_obj[tri_i], sph_i)
        compact = torch.cat([
            c_center, c_radius[:, None], c_em, top_power[:, None],
            c_obj[:, None].to(torch.float32),
            torch.where(is_tri[:, None], tri_e1[tri_i], 0.0),
            torch.where(is_tri[:, None], tri_e2[tri_i], 0.0),
            is_tri[:, None].to(torch.float32)], dim=-1)
        # Reverse map: flat (instance, face) -> compact light id; rows
        # that are no triangle light go to the dropped slot n_tri.
        tri_slot = torch.where(is_light & is_tri, tri_i, n_tri)
        tri_light_id = torch.full((n_tri + 1,), -1, dtype=torch.int64,
                                  device=dev)
        tri_light_id[tri_slot] = torch.arange(MAX_LIGHTS, device=dev)
        tri_light_id = tri_light_id[:n_tri]
    else:
        compact = torch.cat([
            scene.center[safe_cand], scene.radius[safe_cand, None],
            emission[safe_cand], top_power[:, None],
            top_cand[:, None].to(torch.float32)], dim=-1)
    empty = torch.zeros_like(compact)
    empty[:, 8].fill_(-1.0)
    compact = torch.where(is_light[:, None], compact, empty)
    cdf = torch.cumsum(top_power, dim=0) / torch.clamp(total, min=1e-20)

    # Sphere object -> compact light id (-1 = not a light); rows that are
    # no sphere light go to the dropped slot k.
    slot = torch.where(is_light & (safe_cand < k), safe_cand, k)
    light_id = torch.full((k + 1,), -1, dtype=torch.int64, device=dev)
    light_id[slot] = torch.arange(MAX_LIGHTS, device=dev)
    light_id = light_id[:k]
    table = torch.cat([scene.center, scene.radius[:, None], emission,
                       power[:, None], light_id[:, None].to(torch.float32)],
                      dim=-1)
    n_emitters = torch.sum(cand_power > 0)
    kept = torch.sum(top_power > 0)
    kept_power = torch.sum(top_power)
    return Lights(
        center=scene.center, radius=scene.radius, emission=emission,
        power=power, total_power=total, table=table, compact=compact,
        cdf=cdf, tri_light_id=tri_light_id, has_triangles=has_tri,
        dropped_lights=(n_emitters - kept).to(torch.float32),
        dropped_power_frac=torch.where(
            total > 0, 1.0 - kept_power / torch.clamp(total, min=1e-20), 0.0))


def sample_light_index(lights: Lights, u):
    """Power-proportional light pick: COMPACT index (the count of CDF
    entries <= u) and its selection pdf."""
    idx = torch.searchsorted(lights.cdf, u.contiguous(), right=True)
    idx = torch.clamp(idx, 0, lights.cdf.shape[0] - 1)
    pdf = lights.compact[idx, 7] / torch.clamp(lights.total_power,
                                               min=1e-20)
    return idx, pdf


def sample_sphere_light(lights: Lights, idx, surface_pos, rand2):
    """Cone sampling of the sphere light of compact id `idx`: its row
    fetched, then ``sample_sphere_light_rows``."""
    return sample_sphere_light_rows(fetch_rows(lights, idx), surface_pos,
                                    rand2)


def sample_light_rows(rows: LightRows, surface_pos, rand2):
    """Light sampling from pre-gathered rows, by kind: sphere rows by
    solid-angle cone sampling, triangle rows uniformly by area with the
    solid-angle pdf (Light.hlsli TriangleLight::CalculateSample). Both
    forms are evaluated and selected per lane; rows of a sphere-only table
    (`kind` None) skip the triangle form.
    Returns (direction, distance, solid_angle_pdf, emission)."""
    ds, dist_s, pdf_s, em = sample_sphere_light_rows(rows, surface_pos,
                                                     rand2)
    if rows.kind is None:
        return ds, dist_s, pdf_s, em
    dt, dist_t, pdf_t = _sample_triangle_rows(rows, surface_pos, rand2)
    tri = rows.kind
    return (torch.where(tri[..., None], dt, ds),
            torch.where(tri, dist_t, dist_s),
            torch.where(tri, pdf_t, pdf_s), em)


def _tri_geometry(rows: LightRows):
    """v0, unit normal and area of centroid-form triangle rows."""
    v0 = rows.center - (rows.e1 + rows.e2) / 3.0
    n_raw = m.cross(rows.e1, rows.e2)
    n_len = m.length(n_raw)
    area = torch.clamp(0.5 * n_len, min=1e-12)
    n_unit = n_raw / torch.clamp(n_len, min=1e-12)[..., None]
    return v0, n_unit, area


def _sample_triangle_rows(rows: LightRows, surface_pos, rand2):
    """Uniform-area triangle sample -> (direction, distance, solid-angle
    pdf). Two-sided, as the reference's abs(dot(L, -Normal))
    (Light.hlsli:63-68)."""
    v0, n_unit, area = _tri_geometry(rows)
    bary = m.sample_triangle(rand2)
    p = v0 + bary[..., 0:1] * rows.e1 + bary[..., 1:2] * rows.e2
    to_p = p - surface_pos
    dist = torch.clamp(m.length(to_p), min=1e-6)
    direction = to_p / dist[..., None]
    cos_l = torch.abs(m.dot(direction, n_unit))
    return direction, dist, m.to_solid_angle_pdf(1.0 / area, dist, cos_l)


def triangle_uv_from_direction(rows: LightRows, surface_pos, direction):
    """Invert uniform-area triangle sampling: the (u, v) uniforms whose
    sample lies where `direction` from `surface_pos` pierces the triangle's
    plane (the inverse of Math::SampleTriangle's sqrt warp). Returns (uv,
    inside)."""
    v0, n_unit, _ = _tri_geometry(rows)
    dn = m.dot(direction, n_unit)
    t = m.dot(v0 - surface_pos, n_unit) / torch.where(
        torch.abs(dn) > 1e-9, dn, 1e-9)
    p = surface_pos + direction * t[..., None]
    # Solve p - v0 = b1 e1 + b2 e2 (the 2x2 Gram system).
    d = p - v0
    a11 = m.dot(rows.e1, rows.e1)
    a12 = m.dot(rows.e1, rows.e2)
    a22 = m.dot(rows.e2, rows.e2)
    det = torch.clamp(a11 * a22 - a12 * a12, min=1e-18)
    r1 = m.dot(d, rows.e1)
    r2 = m.dot(d, rows.e2)
    b1 = (a22 * r1 - a12 * r2) / det
    b2 = (a11 * r2 - a12 * r1) / det
    s = b1 + b2
    inside = (t > 0) & (b1 >= 0) & (b2 >= 0) & (s <= 1.0)
    # SampleTriangle: b1 = sqrt(u0) (1 - u1), b2 = sqrt(u0) u1.
    u0 = torch.clamp(s * s, 0.0, 1.0)
    u1 = torch.clamp(b2 / torch.clamp(s, min=1e-9), 0.0, 1.0)
    return torch.stack([u0, u1], dim=-1), inside


def sample_sphere_light_rows(rows: LightRows, surface_pos, rand2):
    """Uniform cone sampling of a sphere light from `surface_pos`: exact
    solid-angle sampling outside the sphere. Returns (direction, distance
    to the near surface, solid_angle_pdf, emission)."""
    to_c = rows.center - surface_pos
    dist_c = torch.clamp(m.length(to_c), min=1e-6)
    w = to_c / dist_c[..., None]

    sin_max_sq = torch.clamp((rows.radius / dist_c) ** 2, 0.0, 1.0 - 1e-6)
    cos_max = torch.sqrt(1.0 - sin_max_sq)
    cos_t = 1.0 - rand2[..., 0] * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * rand2[..., 1]
    t, b = m.orthonormal_basis(w)
    direction = (t * (sin_t * torch.cos(phi))[..., None]
                 + b * (sin_t * torch.sin(phi))[..., None]
                 + w * cos_t[..., None])
    pdf = 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-8)

    # Distance to the sphere along the sampled direction (near root).
    oc = -to_c
    bq = m.dot(oc, direction)
    cq = m.dot(oc, oc) - rows.radius * rows.radius
    disc = torch.clamp(bq * bq - cq, min=0.0)
    dist = torch.clamp(-bq - torch.sqrt(disc), min=1e-4)
    return direction, dist, pdf, rows.emission


def light_pdf_rows(rows: LightRows, surface_pos):
    """Solid-angle pdf of having cone-sampled the light from
    `surface_pos` (for MIS against BSDF sampling)."""
    dist_c = torch.clamp(m.length(rows.center - surface_pos), min=1e-6)
    sin_max_sq = torch.clamp((rows.radius / dist_c) ** 2, 0.0, 1.0 - 1e-6)
    cos_max = torch.sqrt(1.0 - sin_max_sq)
    return 1.0 / torch.clamp(2.0 * math.pi * (1.0 - cos_max), min=1e-8)


def light_pdf(lights: Lights, idx, surface_pos):
    """Solid-angle pdf of having cone-sampled the light of compact id `idx`
    from `surface_pos`: its row fetched, then ``light_pdf_rows``."""
    return light_pdf_rows(fetch_rows(lights, idx), surface_pos)
