"""ReSTIR DI: ReGIR grid, initial / temporal / spatial reservoir resampling
and final shading (port of ``drts_tpu/ops/restir.py``).

The reference's default path: ReGIR_RIS local-light candidates through
the fused candidate kernel (B3, ``restir_kernels.initial_light_candidates``)
plus BRDF-ray candidates (the light sweep is B11, the occluder test B2),
temporal reuse in ``basic`` bias mode over the exact nearest reprojection
(B4), spatial reuse in ``basic`` mode with ``per_pixel`` disc offsets, the
boiling filter, and final shading with its visibility ray (B2). A scene
with triangle lights (any scene with mesh instances), the ``Power_RIS`` and
``Uniform`` light modes, ``local_light_samples = 0`` or ``initial_kernel=
False`` take the reference's sequential candidate loop instead of B3 (or,
with ``candidate_batch``, the same draws evaluated as one batch); a scene
with triangle lights finds its BRDF-ray triangle candidates by a dense
sweep over the compact rows' triangles and casts its visibility rays
through the mesh any-hit kernels (``trace.occluded_scene``).

The pairwise and raytraced bias modes reuse with confidence-weighted
pairwise MIS: temporal reuse reprojects the stored target pdf beside the
reservoir row (5 words through B4) and, with ``temporal_prev_surface=
"real"``, the previous frame's surface rows too (12 words); spatial reuse
gathers each neighbour's reservoir and surface rows in one 34-word row.
The raytraced modes trace a visibility batch per cross term. ``shared``
spatial offsets take one golden-angle offset per round and frame, computed
on the host in float32 as the reference computes it from its int32 frame
index, and roll the packed rows by it. Reservoirs are SoA (H, W) tensors;
light ids are compact ids (``light.Lights``), kept as int64.
"""

from __future__ import annotations

import dataclasses
import math
import types

import numpy as np
import torch

from ..utils import math as m
from ..utils import rng as rng_mod
from . import bxdf, intersect, light as light_mod, trimesh
from . import reproject_kernels as rp
from . import restir_kernels as rk
from . import trace as trace_mod


@dataclasses.dataclass(frozen=True)
class ReSTIRConfig:
    """MyAppData.h:190-253 defaults (the reference's ReSTIRConfig)."""
    regir_cells_per_axis: int = 16
    regir_cell_size: float = 1.0
    regir_slots_per_cell: int = 8
    regir_build_samples: int = 8
    local_light_mode: str = "ReGIR_RIS"
    local_light_samples: int = 8
    brdf_samples: int = 1
    temporal_enabled: bool = True
    spatial_enabled: bool = True
    max_history: int = 20
    boiling_filter_strength: float = 0.2
    spatial_samples: int = 1
    spatial_radius: float = 30.0
    depth_threshold: float = 0.1
    normal_threshold: float = 0.5
    spatial_bias_correction: str = "basic"
    temporal_bias_correction: str = "basic"
    temporal_prev_surface: str = "pseudo"
    spatial_offset_mode: str = "per_pixel"
    candidate_batch: bool = False
    initial_kernel: bool = True


LIGHT_MODES = ("ReGIR_RIS", "Power_RIS", "Uniform")
BIAS_MODES = ("basic", "pairwise", "raytraced")
PREV_SURFACES = ("pseudo", "real")
OFFSET_MODES = ("per_pixel", "shared")


def check_config(cfg: ReSTIRConfig) -> None:
    """Raise ValueError for a mode name the reference does not know."""
    for name, allowed in (("local_light_mode", LIGHT_MODES),
                          ("spatial_bias_correction", BIAS_MODES),
                          ("temporal_bias_correction", BIAS_MODES),
                          ("temporal_prev_surface", PREV_SURFACES),
                          ("spatial_offset_mode", OFFSET_MODES)):
        value = getattr(cfg, name)
        if value not in allowed:
            raise ValueError(f"ReSTIR {name} must be one of {allowed}, got "
                             f"{value!r}")


@dataclasses.dataclass(frozen=True)
class Reservoirs:
    """Per-pixel DI reservoirs (the RTXDI reservoir buffer as planes)."""
    light_index: torch.Tensor  # (H, W) int64 compact light id
    uv: torch.Tensor           # (H, W, 2) sample uniforms
    w_sum: torch.Tensor        # (H, W)
    m_count: torch.Tensor      # (H, W)
    w_out: torch.Tensor        # (H, W) unbiased contribution weight W
    phat: torch.Tensor         # (H, W) target pdf at the owning surface


def init_reservoirs(height: int, width: int, device="cuda") -> Reservoirs:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return Reservoirs(
        light_index=torch.zeros((height, width), dtype=torch.int64,
                                device=device),
        uv=z(height, width, 2), w_sum=z(height, width),
        m_count=z(height, width), w_out=z(height, width),
        phat=z(height, width))


@dataclasses.dataclass(frozen=True)
class ReGIRGrid:
    """Camera-centred world grid of per-cell RIS reservoirs, with
    N_FALLBACK_CELLS power-RIS rows appended; `packed` holds each slot as
    an f16 pair [compact id | weight] in one f32."""
    light_index: torch.Tensor  # (C+F, S) int64
    weight: torch.Tensor       # (C+F, S) RIS weight W per slot
    packed: torch.Tensor       # (C+F, S) f32 (f16 pairs)
    origin: torch.Tensor       # (3,) grid corner
    cell_size: torch.Tensor    # scalar


@dataclasses.dataclass(frozen=True)
class Surface:
    """What the RAB_* callbacks reconstruct from the G-buffer
    (RTXDIAppBridge.hlsli:293-348)."""
    valid: torch.Tensor
    position: torch.Tensor
    view: torch.Tensor           # unit vector toward the camera
    bsdf: bxdf.BSDF
    sv: bxdf.SurfaceVectors
    lobe_weights: torch.Tensor
    depth: torch.Tensor
    normal: torch.Tensor


def make_surface(gbuf) -> Surface:
    mat, surf = gbuf.mat, gbuf.surf
    sv = bxdf.make_surface_vectors(surf.is_front_face, surf.geometric_normal,
                                   mat.shading_normal)
    bs = bxdf.make_bsdf(mat.base_color, mat.metallic, mat.roughness, mat.ior,
                        mat.transmission, surf.is_front_face)
    v = -gbuf.ray_direction
    return Surface(valid=surf.valid, position=surf.position, view=v,
                   bsdf=bs, sv=sv, lobe_weights=bxdf.lobe_weights(bs, sv, v),
                   depth=gbuf.linear_depth, normal=mat.shading_normal)


def _uv_from_direction(rows: light_mod.LightRows, surface_pos, direction):
    """Invert the sampling map: the (u, v) uniforms that generate
    `direction` toward the light of `rows`, and whether it reaches the
    light. Sphere rows invert cone sampling, triangle rows the area warp
    (light.triangle_uv_from_direction)."""
    uv_s, in_s = _uv_from_direction_sphere(rows, surface_pos, direction)
    if rows.kind is None:
        return uv_s, in_s
    uv_t, in_t = light_mod.triangle_uv_from_direction(rows, surface_pos,
                                                      direction)
    tri = rows.kind
    return (torch.where(tri[..., None], uv_t, uv_s),
            torch.where(tri, in_t, in_s))


def _uv_from_direction_sphere(rows: light_mod.LightRows, surface_pos,
                              direction):
    """Invert cone sampling: the (u, v) uniforms that generate `direction`
    toward the light of `rows`, and whether it lies inside the cone."""
    to_c = rows.center - surface_pos
    dist_c = torch.clamp(m.length(to_c), min=1e-6)
    w = to_c / dist_c[..., None]
    sin_max_sq = torch.clamp((rows.radius / dist_c) ** 2, 0.0, 1.0 - 1e-6)
    cos_max = torch.sqrt(1.0 - sin_max_sq)
    cos_t = torch.clamp(m.dot(direction, w), -1.0, 1.0)
    u0 = torch.clamp((1.0 - cos_t) / torch.clamp(1.0 - cos_max, min=1e-8),
                     0.0, 1.0)
    t, b = m.orthonormal_basis(w)
    phi = torch.atan2(m.dot(direction, b), m.dot(direction, t))
    u1 = torch.remainder(phi / (2.0 * math.pi), 1.0)   # floored, as jnp.mod
    return torch.stack([u0, u1], dim=-1), cos_t >= cos_max


def _target_pdf_rows(surface: Surface, rows: light_mod.LightRows, uv):
    """p_hat of the sample at this surface in uv-square measure (the
    solid-angle integrand times the cone Jacobian 1/cone_pdf), with the
    shading pieces (direction, distance, f_diffuse, f_specular, emission,
    inv_cone_pdf)."""
    direction, dist, cone_pdf, emission = light_mod.sample_light_rows(
        rows, surface.position, uv)
    diff, spec = bxdf.eval_split(surface.bsdf, surface.sv, direction,
                                 surface.view, surface.lobe_weights)
    inv_cone = 1.0 / torch.clamp(cone_pdf, min=1e-12)
    p_hat = m.luminance((diff + spec) * emission) * inv_cone
    p_hat = torch.where(surface.valid & (rows.power > 0), p_hat, 0.0)
    return p_hat, direction, dist, diff, spec, emission, inv_cone


def _target_pdf(surface: Surface, lights: light_mod.Lights, idx, uv):
    """_target_pdf_rows after the compact-row fetch; also returns the rows
    (rows.aux = the light's object id, excluded from its visibility ray)."""
    rows = light_mod.fetch_rows(lights, idx)
    return _target_pdf_rows(surface, rows, uv) + (rows,)


def _target_pdf_with_bsdf(surface: Surface, lights: light_mod.Lights, idx,
                          uv):
    """p_hat of _target_pdf and the BSDF mixture pdf of the generated
    direction in uv measure (the other technique's density in a light
    candidate's MIS weight)."""
    p_hat, direction, _, _, _, _, inv_cone, _ = _target_pdf(surface, lights,
                                                            idx, uv)
    p_w = bxdf.eval_pdf(surface.bsdf, surface.sv, direction, surface.view,
                        surface.lobe_weights)
    return p_hat, p_w * inv_cone


# ----------------------------------------------------------------------------
# ReGIR grid build (ReGIRPresampling.hlsl analogue)

# Power-RIS rows appended after the ReGIR cells, serving pixels outside the
# grid volume.
N_FALLBACK_CELLS = 64


def build_regir_grid(lights: light_mod.Lights, camera_position,
                     cfg: ReSTIRConfig, frame_index) -> ReGIRGrid:
    check_config(cfg)
    dev = lights.compact.device
    n = cfg.regir_cells_per_axis
    c_total = n * n * n
    s = cfg.regir_slots_per_cell
    origin = camera_position - n * cfg.regir_cell_size / 2.0

    ids = torch.arange(c_total, device=dev)
    ijk = torch.stack([ids // (n * n), (ids // n) % n, ids % n], dim=-1)
    centers = origin + (ijk.to(torch.float32) + 0.5) * cfg.regir_cell_size

    slot_ids = torch.arange(s, device=dev)
    rng = rng_mod.init(ids[:, None] * s + slot_ids[None, :],
                       torch.full((c_total, s), 7777, device=dev),
                       frame_index)
    best_idx = torch.zeros((c_total, s), dtype=torch.int64, device=dev)
    w_sum = torch.zeros((c_total, s), dtype=torch.float32, device=dev)
    best_phat = torch.zeros_like(w_sum)
    for _ in range(cfg.regir_build_samples):
        u_pick, rng = rng_mod.next_float(rng)
        u_keep, rng = rng_mod.next_float(rng)
        idx, pick_pdf = light_mod.sample_light_index(lights, u_pick)
        rows = light_mod.fetch_rows(lights, idx)
        # Cell target: power / squared distance.
        d2 = torch.sum((rows.center - centers[:, None, :]) ** 2, dim=-1)
        p_hat = rows.power / torch.clamp(d2, min=cfg.regir_cell_size ** 2)
        w = torch.where(pick_pdf > 0,
                        p_hat / torch.clamp(pick_pdf, min=1e-20), 0.0)
        w_sum = w_sum + w
        take = (u_keep * w_sum) < w
        best_idx = torch.where(take, idx, best_idx)
        best_phat = torch.where(take, p_hat, best_phat)
    w_out = torch.where(best_phat > 0, w_sum / (
        cfg.regir_build_samples * torch.clamp(best_phat, min=1e-20)), 0.0)

    # Fallback rows: one power-RIS draw per slot, W = 1 / pdf.
    fb = N_FALLBACK_CELLS
    fb_rng = rng_mod.init(
        torch.arange(fb, device=dev)[:, None] * s + slot_ids[None, :],
        torch.full((fb, s), 3131, device=dev), frame_index)
    u_fb, _ = rng_mod.next_float(fb_rng)
    fb_idx, fb_pdf = light_mod.sample_light_index(lights, u_fb)
    fb_w = torch.where(fb_pdf > 0, 1.0 / torch.clamp(fb_pdf, min=1e-20), 0.0)

    all_idx = torch.cat([best_idx, fb_idx])
    all_w = torch.cat([w_out, fb_w])
    return ReGIRGrid(light_index=all_idx, weight=all_w,
                     packed=m.pack2f16(all_idx.to(torch.float32), all_w),
                     origin=origin,
                     cell_size=m.const(float(cfg.regir_cell_size),
                                       device=dev))


def _cell_of(grid: ReGIRGrid, position, n: int):
    ijk = torch.floor((position - grid.origin) / grid.cell_size)
    inside = torch.all((ijk >= 0) & (ijk < n), dim=-1)
    ijk = torch.clamp(torch.nan_to_num(ijk, nan=0.0), 0, n - 1).long()
    return (ijk[..., 0] * n + ijk[..., 1]) * n + ijk[..., 2], inside


# ----------------------------------------------------------------------------
# initial sampling (DIInitialSampling.hlsl)


def _pack_surface_planar(surface: Surface):
    """Surface -> the (24, N) planar stream of restir_kernels (ROW_*)."""
    sv, bs = surface.sv, surface.bsdf
    rows = [
        surface.position[..., 0], surface.position[..., 1],
        surface.position[..., 2],
        sv.shading_normal[..., 0], sv.shading_normal[..., 1],
        sv.shading_normal[..., 2],
        sv.front_geometric_normal[..., 0], sv.front_geometric_normal[..., 1],
        sv.front_geometric_normal[..., 2],
        surface.view[..., 0], surface.view[..., 1], surface.view[..., 2],
        bs.base_color[..., 0], bs.base_color[..., 1], bs.base_color[..., 2],
        bs.metallic, bs.roughness, bs.ior_i, bs.ior_o, bs.transmission,
        surface.valid.to(torch.float32),
        surface.lobe_weights[..., 0], surface.lobe_weights[..., 1],
        surface.lobe_weights[..., 2],
    ]
    return torch.stack([r.reshape(-1).to(torch.float32) for r in rows])


def _pixel_grid(h: int, w: int, device, row0: int = 0):
    """(py, px) of an (h, w) grid whose first row is image row `row0`."""
    return torch.meshgrid(torch.arange(row0, row0 + h, device=device),
                          torch.arange(w, device=device), indexing="ij")


def _map_surface(fn, surface: Surface) -> Surface:
    """`fn` applied to every tensor of a Surface (its BSDF and vectors
    included)."""
    def go(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: go(getattr(x, f.name))
                              for f in dataclasses.fields(x)})
        return fn(x)
    return go(surface)


def _valid_lights(lights: light_mod.Lights):
    """The number of compact rows with positive power, as a float32
    scalar on the device."""
    return torch.sum((lights.compact[:, 7] > 0).to(torch.float32))


def _light_candidates(surface: Surface, lights: light_mod.Lights, rows_all,
                      cfg: ReSTIRConfig, rng):
    """The light-candidate rounds without the fused kernel (the reference's
    sequential loop, or with ``candidate_batch`` the same draws evaluated
    as one (n_l, H, W) batch and merged in the loop's order): per round a
    candidate and its RIS source weight (a slot of the pixel's prefetched
    ReGIR row, a fresh power-CDF draw, or a uniform pick over the valid
    lights), weighed by the balance heuristic against the BRDF technique
    and taken by weighted reservoir sampling. rows_all: (H, W, s) packed
    slots (ReGIR_RIS only). Returns (res_idx, res_uv, res_phat, w_sum,
    m_count, rng)."""
    h, w = surface.depth.shape
    dev = surface.depth.device
    s = cfg.regir_slots_per_cell
    n_l, n_b = cfg.local_light_samples, cfg.brdf_samples
    m_total = float(n_l + n_b)

    def pick_candidate(u_slot):
        if cfg.local_light_mode == "Power_RIS":
            cand, pick_pdf = light_mod.sample_light_index(lights, u_slot)
            w_cand = torch.where(pick_pdf > 0, 1.0 / torch.clamp(
                pick_pdf, min=1e-20), 0.0)
        elif cfg.local_light_mode == "Uniform":
            # Uniform over the valid compact lights (they sort first).
            n_valid = _valid_lights(lights)
            cand = torch.minimum((u_slot * n_valid).to(torch.int64),
                                 torch.clamp(n_valid - 1, min=0).long())
            w_cand = torch.broadcast_to(n_valid, cand.shape)
        else:
            slot = torch.clamp((u_slot * s).to(torch.int64), max=s - 1)
            rows = torch.broadcast_to(rows_all, slot.shape + (s,))
            cand_f, w_cand = m.unpack2f16(
                rows.gather(-1, slot[..., None])[..., 0])
            cand = torch.round(cand_f).long()
        return cand, w_cand

    def candidate_weight(surf, cand, uv, w_cand):
        if n_b > 0:
            p_self = 1.0 / torch.clamp(w_cand, min=1e-20)
            p_hat, p_other = _target_pdf_with_bsdf(surf, lights, cand, uv)
            wi = m_total * p_hat / torch.clamp(
                n_l * p_self + n_b * p_other, min=1e-20)
            wi = torch.where(w_cand > 0, wi, 0.0)
        else:
            p_hat = _target_pdf(surf, lights, cand, uv)[0]
            wi = p_hat * w_cand
        return p_hat, wi

    draws = []
    for _ in range(n_l):
        u2, rng = rng_mod.next_floats(rng, 2)
        uv, rng = rng_mod.next_floats(rng, 2)
        draws.append((u2[..., 0], u2[..., 1], uv))
    if cfg.candidate_batch and n_l > 0:
        cand_all, w_all = pick_candidate(torch.stack([d[0] for d in draws]))
        p_hat_all, wi_all = candidate_weight(
            _map_surface(lambda x: x[None], surface), cand_all,
            torch.stack([d[2] for d in draws]), w_all)
        rounds = [(cand_all[i], p_hat_all[i], wi_all[i]) for i in range(n_l)]
    else:
        rounds = []
        for u_slot, _, uv in draws:
            cand, w_cand = pick_candidate(u_slot)
            rounds.append((cand,) + candidate_weight(surface, cand, uv,
                                                     w_cand))
    res_idx = torch.zeros((h, w), dtype=torch.int64, device=dev)
    res_uv = torch.zeros((h, w, 2), device=dev)
    res_phat = torch.zeros((h, w), device=dev)
    w_sum = torch.zeros((h, w), device=dev)
    m_count = torch.zeros((h, w), device=dev)
    for (_, u_keep, uv), (cand, p_hat, wi) in zip(draws, rounds):
        w_sum = w_sum + wi
        m_count = m_count + 1.0
        take = (u_keep * w_sum) < wi
        res_idx = torch.where(take, cand, res_idx)
        res_uv = torch.where(take[..., None], uv, res_uv)
        res_phat = torch.where(take, p_hat, res_phat)
    return res_idx, res_uv, res_phat, w_sum, m_count, rng


def _intersect_tri_lights(lights: light_mod.Lights, origin, direction, live):
    """Closest hit against the compact table's triangle-light rows (the
    BRDF candidate's counterpart of the sphere-light sweep): a dense
    Moeller-Trumbore over the MAX_LIGHTS world-space triangles. Sphere rows
    carry zero edges and never hit. Returns (t (inf = miss), compact id,
    bary_u, bary_v)."""
    comp = lights.compact
    e1, e2 = comp[:, 9:12], comp[:, 12:15]
    mesh = types.SimpleNamespace(v0=comp[:, 0:3] - (e1 + e2) / 3.0, e1=e1,
                                 e2=e2)
    t, face, u, v = trimesh.intersect_mesh(
        origin, direction, torch.zeros_like(live, dtype=torch.float32),
        torch.where(live, float("inf"), -1.0), mesh)
    return t, face, u, v


def initial_sampling(surface: Surface, scene, lights: light_mod.Lights,
                     grid: ReGIRGrid | None, cfg: ReSTIRConfig, frame_index,
                     block_size: int = 16384, accel=None,
                     row0: int = 0) -> Reservoirs:
    """n_l light candidates (B3 in ReGIR_RIS mode on a sphere-light table
    with initial_kernel on, else _light_candidates) and n_b BRDF-ray
    candidates (B11 light sweep and, with triangle lights, the dense
    triangle sweep; the occluder test) into one reservoir per pixel, then
    the initial visibility ray. `grid` is used in ReGIR_RIS mode only.
    A `surface` of a row band starting at image row `row0` takes its
    pixels' streams of the whole frame."""
    check_config(cfg)
    h, w = surface.depth.shape
    dev = surface.depth.device
    py, px = _pixel_grid(h, w, dev, row0)
    rng = rng_mod.init(px + 17, py + 31, frame_index * 3 + 1)

    s = cfg.regir_slots_per_cell
    rows_all = None
    if cfg.local_light_mode == "ReGIR_RIS":
        n_cells = cfg.regir_cells_per_axis
        cell, inside = _cell_of(grid, surface.position, n_cells)
        # Pixels outside the grid volume draw from one of the fallback
        # rows.
        u_fb, rng = rng_mod.next_float(rng)
        fb_cell = n_cells ** 3 + torch.clamp(
            (u_fb * N_FALLBACK_CELLS).to(torch.int64),
            max=N_FALLBACK_CELLS - 1)
        rows_all = grid.packed[torch.where(inside, cell, fb_cell)]  # (H,W,s)

    n_l, n_b = cfg.local_light_samples, cfg.brdf_samples
    m_total = float(n_l + n_b)

    # The reference's kernel gate: ReGIR_RIS candidates from a sphere-only
    # light table (the kernel's rows are 9 wide and it samples cones only).
    use_kernel = (cfg.initial_kernel and n_l > 0
                  and cfg.local_light_mode == "ReGIR_RIS"
                  and not lights.has_triangles)
    win_dir = win_dist = win_aux = None
    if use_kernel:
        # The uniforms in the sequential loop's draw order, as planar rows.
        uni_rows = []
        for _ in range(n_l):
            u2, rng = rng_mod.next_floats(rng, 2)
            uv, rng = rng_mod.next_floats(rng, 2)
            uni_rows += [u2[..., 0], u2[..., 1], uv[..., 0], uv[..., 1]]
        cand_all_f, w_all = m.unpack2f16(rows_all)
        slot_rows = [cand_all_f[..., j] for j in range(s)] \
            + [w_all[..., j] for j in range(s)]
        out_f, out_i = rk.initial_light_candidates(
            _pack_surface_planar(surface),
            torch.stack([r.reshape(-1) for r in uni_rows]),
            torch.stack([r.reshape(-1) for r in slot_rows]),
            lights.compact.contiguous(), n_l, s, n_b)
        out_f = out_f.reshape(8, h, w)
        out_i = out_i.reshape(2, h, w).long()
        res_uv = out_f[0:2].permute(1, 2, 0)
        res_phat, w_sum = out_f[2], out_f[3]
        win_dir = out_f[4:7].permute(1, 2, 0)
        win_dist = out_f[7]
        res_idx, win_aux = out_i[0], out_i[1]
        m_count = torch.full((h, w), float(n_l), device=dev)
    else:
        res_idx, res_uv, res_phat, w_sum, m_count, rng = \
            _light_candidates(surface, lights, rows_all, cfg, rng)

    # BRDF-ray candidates: sample the BSDF, find the nearest light along
    # the ray (a sweep over the compact table), test for occluders, fold
    # the hit into the (light, uv) reservoir domain.
    for _ in range(n_b):
        rand4, rng = rng_mod.next_floats(rng, 4)
        u_keep2, rng = rng_mod.next_float(rng)
        l_dir, _, valid_dir = bxdf.sample(surface.bsdf, surface.sv,
                                          surface.view, rand4)
        origin = intersect.safe_spawn_point(
            surface.position, surface.sv.front_geometric_normal, l_dir)
        ray_live = surface.valid & valid_dir
        lhit = intersect.intersect_spheres(
            origin, l_dir, torch.zeros((h, w), device=dev),
            torch.where(ray_live, float("inf"), -1.0),
            lights.compact[:, 0:3], lights.compact[:, 3], block_size)
        light_t = torch.where(lhit.hit, lhit.t, float("inf"))
        cand_b = lhit.index
        hit_light = lhit.hit
        if lights.has_triangles:
            # Triangle-light candidates; the hit's barycentrics invert the
            # area warp directly.
            tri_t, tri_id, tri_u, tri_v = _intersect_tri_lights(
                lights, origin, l_dir, ray_live)
            cand_b = torch.where(tri_t < light_t, tri_id, cand_b)
            light_t = torch.minimum(light_t, tri_t)
            hit_light = hit_light | torch.isfinite(tri_t)
            tri_s = torch.clamp(tri_u + tri_v, 0.0, 1.0)
            uv_tri_hit = torch.stack(
                [tri_s * tri_s,
                 torch.clamp(tri_v / torch.clamp(tri_s, min=1e-9), 0.0, 1.0)],
                dim=-1)
        krows = light_mod.fetch_rows(lights, cand_b)
        occ_b = _occluded(origin, l_dir, light_t, scene, krows.aux,
                          block_size, accel, live=ray_live & hit_light)
        is_emissive = hit_light & (krows.power > 0) & ~occ_b
        uv_b, inside_cone = _uv_from_direction(krows, surface.position,
                                               l_dir)
        if lights.has_triangles:
            took_tri = krows.kind & torch.isfinite(tri_t)
            uv_b = torch.where(took_tri[..., None], uv_tri_hit, uv_b)
            inside_cone = inside_cone | took_tri
        ok = is_emissive & inside_cone & ray_live

        p_w = bxdf.eval_pdf(surface.bsdf, surface.sv, l_dir, surface.view,
                            surface.lobe_weights)
        _, _, cone_pdf_b, _ = light_mod.sample_light_rows(
            krows, surface.position, uv_b)
        p_self = p_w / torch.clamp(cone_pdf_b, min=1e-12)
        # MIS light-technique density: uniform over the valid lights in
        # Uniform mode, else the power pdf (RTXDI's BRDF-candidate
        # approximation where candidates come from the ReGIR grid).
        if cfg.local_light_mode == "Uniform":
            p_light = torch.where(krows.power > 0, 1.0 / torch.clamp(
                _valid_lights(lights), min=1.0), 0.0)
        else:
            p_light = krows.power / torch.clamp(lights.total_power,
                                                min=1e-20)
        p_hat_b = torch.where(ok, _target_pdf_rows(surface, krows, uv_b)[0],
                              0.0)
        wi = torch.where(ok & (p_self > 0), m_total * p_hat_b / torch.clamp(
            n_b * p_self + n_l * p_light, min=1e-20), 0.0)
        w_sum = w_sum + wi
        m_count = m_count + 1.0
        take = (u_keep2 * w_sum) < wi
        res_idx = torch.where(take, torch.clamp(cand_b, min=0), res_idx)
        res_uv = torch.where(take[..., None], uv_b, res_uv)
        res_phat = torch.where(take, p_hat_b, res_phat)
        if win_dir is not None:
            win_dir = torch.where(take[..., None], l_dir, win_dir)
            win_dist = torch.where(take, torch.where(
                torch.isfinite(light_t), light_t, 0.0), win_dist)
            win_aux = torch.where(take, krows.aux, win_aux)

    w_out = torch.where(res_phat > 0, w_sum / (
        torch.clamp(m_count, min=1.0) * torch.clamp(res_phat, min=1e-20)),
        0.0)
    # Initial visibility ray toward the winner (the kernel carried its
    # direction, distance and object id; the loop fetches them again);
    # dead where the reservoir is already worthless.
    if win_dir is None:
        _, win_dir, win_dist, _, _, _, _, rows = _target_pdf(
            surface, lights, res_idx, res_uv)
        win_aux = rows.aux
    origin = intersect.safe_spawn_point(surface.position,
                                        surface.sv.front_geometric_normal,
                                        win_dir)
    occluded = _occluded(origin, win_dir, win_dist, scene, win_aux,
                         block_size, accel, live=surface.valid & (w_out > 0))
    w_out = torch.where(occluded | ~surface.valid, 0.0, w_out)
    return Reservoirs(light_index=res_idx, uv=res_uv.contiguous(),
                      w_sum=w_sum, m_count=m_count, w_out=w_out,
                      phat=res_phat)


def _occluded(origin, direction, light_dist, scene, exclude_obj,
              block_size: int, accel=None, live=None):
    """Visibility ray toward the selected light (RAB_GetConservativeVisibility,
    RTXDIAppBridge.hlsli:418-459): blocked if a sphere other than the light
    object, or a mesh instance, lies closer than the light surface. Lanes
    whose answer is never read (`live` False) get a dead t range and cost
    the kernel nothing."""
    max_dist = torch.clamp(light_dist - 1e-3, min=0.0)
    if live is not None:
        max_dist = torch.where(live, max_dist, -1.0)
    return trace_mod.occluded_scene(scene, origin, direction, max_dist,
                                    exclude_obj, block_size, accel=accel)


# ----------------------------------------------------------------------------
# reservoir merge helpers


def _merge(a_idx, a_uv, a_phat, a_wsum, a_m, b_idx, b_uv, b_w, b_m, b_phat,
           u_keep):
    """Merge stream B (one sample of weight b_w = p_hat_b W_b M_b) into A."""
    w_sum = a_wsum + b_w
    take = (u_keep * w_sum) < b_w
    return (torch.where(take, b_idx, a_idx),
            torch.where(take[..., None], b_uv, a_uv),
            torch.where(take, b_phat, a_phat),
            w_sum, a_m + b_m)


def _finalize(idx, uv, phat, w_sum, m_count) -> Reservoirs:
    w_out = torch.where(phat > 0, w_sum / (
        torch.clamp(m_count, min=1.0) * torch.clamp(phat, min=1e-20)), 0.0)
    return Reservoirs(light_index=idx, uv=uv, w_sum=w_sum, m_count=m_count,
                      w_out=w_out, phat=phat)


def _pack_reservoirs(res: Reservoirs, depth, normal, extra=None):
    """(H, W, 4 [+ E]) packed reservoir and guide rows for one-row fetches:
    [idx|M as f16 pair, uv as f16 pair, w_out, depth|oct8 normal], then
    the E words of `extra`."""
    packed = torch.stack([
        m.pack2f16(res.light_index.to(torch.float32), res.m_count),
        m.pack2f16(res.uv[..., 0], res.uv[..., 1]),
        res.w_out,
        m.pack_depth_oct8(depth, normal),
    ], dim=-1)
    if extra is not None:
        packed = torch.cat([packed, extra], dim=-1)
    return packed


def _unpack_rows(row):
    """Packed reservoir rows -> (idx, uv, m_count, w_out, depth, normal,
    the extra words)."""
    idx_f, m_count = m.unpack2f16(row[..., 0])
    u0, u1 = m.unpack2f16(row[..., 1])
    depth, normal = m.unpack_depth_oct8(row[..., 3])
    return (torch.round(idx_f).long(), torch.stack([u0, u1], dim=-1),
            m_count, row[..., 2], depth, normal, row[..., 4:])


def pack_prev_material(gbuf):
    """(H, W, 7) rows of what RAB_GetGBufferSurface(previousFrame) reads
    from the previous G-buffer (RTXDIAppBridge.hlsli:293-348): world
    position (f32 x3), then f16 pairs [r|g, b|metallic, roughness|ior,
    transmission|valid]. The pipeline keeps them from each frame's
    G-buffer for temporal_prev_surface="real"."""
    mat, surf = gbuf.mat, gbuf.surf
    return torch.cat([
        surf.position,
        m.pack2f16(mat.base_color[..., 0], mat.base_color[..., 1])[..., None],
        m.pack2f16(mat.base_color[..., 2], mat.metallic)[..., None],
        m.pack2f16(mat.roughness, mat.ior)[..., None],
        m.pack2f16(mat.transmission,
                   surf.valid.to(torch.float32))[..., None],
    ], dim=-1)


def _prev_surface_from_rows(mrows, pn, pd, hist_ok, prev_camera_position,
                            fallback_view) -> Surface:
    """The previous frame's Surface from reprojected pack_prev_material
    rows (the previousFrame branch of RAB_GetGBufferSurface, with its
    MinRoughness = 0.05 validity gate)."""
    pos_p = mrows[..., 0:3]
    cr, cg = m.unpack2f16(mrows[..., 3])
    cb, metal = m.unpack2f16(mrows[..., 4])
    rough, ior = m.unpack2f16(mrows[..., 5])
    trans, pvalid_f = m.unpack2f16(mrows[..., 6])
    valid_p = hist_ok & (pvalid_f > 0.5) & (rough >= 0.05)
    if prev_camera_position is not None:
        view_p = m.normalize(prev_camera_position - pos_p)
    else:
        view_p = fallback_view
    front_p = m.dot(pn, view_p) > 0
    sv_p = bxdf.make_surface_vectors(front_p, pn, pn)
    bs_p = bxdf.make_bsdf(torch.stack([cr, cg, cb], dim=-1), metal, rough,
                          ior, trans, front_p)
    return Surface(valid=valid_p, position=pos_p, view=view_p, bsdf=bs_p,
                   sv=sv_p, lobe_weights=bxdf.lobe_weights(bs_p, sv_p,
                                                           view_p),
                   depth=pd, normal=pn)


def _spawn_occluded(from_surface: Surface, direction, dist, rows, scene,
                    block_size, accel, live):
    """The visibility ray from `from_surface` toward a light sample whose
    direction, distance and rows _target_pdf gave: True where occluded."""
    origin = intersect.safe_spawn_point(
        from_surface.position, from_surface.sv.front_geometric_normal,
        direction)
    return _occluded(origin, direction, dist, scene, rows.aux, block_size,
                     accel, live=live)


# ----------------------------------------------------------------------------
# temporal resampling (DITemporalResampling.hlsl)


def temporal_resampling(cur: Reservoirs, prev: Reservoirs, surface: Surface,
                        lights: light_mod.Lights, motion, prev_depth,
                        prev_normal, cfg: ReSTIRConfig, frame_index,
                        scene=None, accel=None, block_size: int = 16384,
                        prev_material=None,
                        prev_camera_position=None, band=None) -> Reservoirs:
    """Merge the reprojected previous reservoir (nearest taps through B4,
    valid where in frame and depth/normal-similar) into the current one,
    then the boiling filter. In the pairwise and raytraced modes the
    history row carries its stored target pdf (and, with
    temporal_prev_surface="real" and `prev_material` given, the previous
    frame's pack_prev_material rows), and the history is MIS-balanced
    against the canonical reservoir; "raytraced" (with a `scene`) traces
    the history sample's visibility from this surface.

    With a ``band`` (``parallel.mesh.Band`` of the sharded frame) the
    current buffers hold the band's rows and the history its band or the
    whole frame: the packed history rows are gathered (the one gather of
    the stage), B4 writes the band's rows, and the boiling filter's 16-row
    tiles read a halo of the neighbours' weights."""
    check_config(cfg)
    h, w = surface.depth.shape
    row0 = band.start if band is not None else 0
    dev = surface.depth.device
    pairwise = cfg.temporal_bias_correction in ("pairwise", "raytraced")
    real_prev = (pairwise and cfg.temporal_prev_surface == "real"
                 and prev_material is not None)
    extra = prev.phat[..., None] if pairwise else None
    if real_prev:
        extra = torch.cat([extra, prev_material], dim=-1)
    packed = _pack_reservoirs(prev, prev_depth, prev_normal, extra)
    if band is not None:
        packed = band.full(packed)
    row, in_bounds = rp.reproject_packed(packed, motion, "nearest", row0)
    p_idx, p_uv, p_m, p_w, pd, pn, rest = _unpack_rows(row)

    depth_ok = torch.abs(pd - surface.depth) <= cfg.depth_threshold \
        * torch.clamp(torch.abs(surface.depth), min=1e-3)
    normal_ok = m.dot(pn, surface.normal) >= cfg.normal_threshold
    hist_ok = in_bounds & depth_ok & normal_ok & surface.valid

    # History length clamp (RTXDI maxHistoryLength x current M).
    p_m = torch.minimum(p_m, cfg.max_history
                        * torch.clamp(cur.m_count, min=1.0))
    p_m = torch.where(hist_ok, p_m, 0.0)
    p_phat, p_dir, p_dist, _, _, _, _, p_rows = _target_pdf(
        surface, lights, p_idx, p_uv)

    rng = rng_mod.init(torch.arange(w, device=dev)[None, :] + 3,
                       torch.arange(row0, row0 + h, device=dev)[:, None] + 5,
                       frame_index * 3 + 2)
    u_keep, _ = rng_mod.next_float(rng)
    cur_phat = cur.phat
    if pairwise:
        # The single history "neighbour" against the canonical reservoir
        # with confidence weights (the k = 1 case of _spatial_pairwise).
        # p_hat_prev(x_prev) rides the history row; the current sample is
        # evaluated at the previous surface: the real one from its rows,
        # or the pseudo one (this surface's BSDF with the reprojected
        # normal).
        p_phat_prev = torch.where(hist_ok, rest[..., 0], 0.0)
        if real_prev:
            psurf = _prev_surface_from_rows(rest[..., 1:8], pn, pd, hist_ok,
                                            prev_camera_position,
                                            surface.view)
        else:
            sv_p = bxdf.make_surface_vectors(torch.ones_like(hist_ok), pn,
                                             pn)
            psurf = Surface(valid=hist_ok, position=surface.position,
                            view=surface.view, bsdf=surface.bsdf, sv=sv_p,
                            lobe_weights=bxdf.lobe_weights(
                                surface.bsdf, sv_p, surface.view),
                            depth=pd, normal=pn)
        phat_c_xi = p_phat
        phat_i_xc = _target_pdf(psurf, lights, cur.light_index, cur.uv)[0]
        if cfg.temporal_bias_correction == "raytraced" and scene is not None:
            occ = _spawn_occluded(surface, p_dir, p_dist, p_rows, scene,
                                  block_size, accel,
                                  live=hist_ok & (phat_c_xi > 0))
            phat_c_xi = torch.where(occ, 0.0, phat_c_xi)
        m_c = cur.m_count
        a_xc = p_m * phat_i_xc
        f_xc = m_c * cur_phat
        mc_weight = torch.where(f_xc > 0, f_xc / torch.clamp(a_xc + f_xc,
                                                            min=1e-20), 0.0)
        a_xi = p_m * p_phat_prev
        m_i = torch.where(p_m > 0, a_xi / torch.clamp(
            a_xi + m_c * phat_c_xi, min=1e-20), 0.0)
        b_w2 = m_i * phat_c_xi * p_w
        w_sum = mc_weight * cur_phat * cur.w_out + b_w2
        take = (u_keep * w_sum) < b_w2
        phat = torch.where(take, phat_c_xi, cur_phat)
        out = Reservoirs(
            light_index=torch.where(take, p_idx, cur.light_index),
            uv=torch.where(take[..., None], p_uv, cur.uv), w_sum=w_sum,
            m_count=cur.m_count + p_m,
            w_out=torch.where(phat > 0, w_sum / torch.clamp(phat, min=1e-20),
                              0.0),
            phat=phat)
    else:
        idx, uv, phat, w_sum, m_count = _merge(
            cur.light_index, cur.uv, cur_phat,
            cur_phat * cur.w_out * cur.m_count, cur.m_count,
            p_idx, p_uv, p_phat * p_w * p_m, p_m, p_phat, u_keep)
        out = _finalize(idx, uv, phat, w_sum, m_count)

    # Boiling filter: kill reservoirs whose weight far exceeds the local
    # average.
    if cfg.boiling_filter_strength > 0:
        weight = out.w_out * phat
        threshold = _avg_pool_band(weight, BOILING_TILE, band) \
            * (1.0 + 9.0 * (1.0 - cfg.boiling_filter_strength))
        boiling = weight > torch.clamp(threshold, min=1e-12)
        out = dataclasses.replace(
            out, w_out=torch.where(boiling, 0.0, out.w_out))
    return out


def _avg_pool(x, size: int):
    """Mean over size x size tiles (zero-padded at the far edges),
    broadcast back to every pixel of the tile."""
    h, w = x.shape
    xp = torch.nn.functional.pad(x, (0, (-w) % size, 0, (-h) % size))
    hh, ww = xp.shape
    pooled = xp.reshape(hh // size, size, ww // size, size).mean(dim=(1, 3))
    up = pooled.repeat_interleave(size, dim=0).repeat_interleave(size, dim=1)
    return up[:h, :w]


def _tile_span(start: int, end: int, size: int, height: int):
    """The rows of the size-row tiles that rows [start, end) touch."""
    return start // size * size, min(-(-end // size) * size, height)


def _avg_pool_band(x, size: int, band=None):
    """_avg_pool's rows of this band: its tiles' rows fetched from the
    neighbours (a halo up to the tile edges), pooled, the band's rows
    kept."""
    if band is None:
        return _avg_pool(x, size)
    lo, hi = band.source_halo(band, lambda s, e: _tile_span(s, e, size,
                                                            band.height))
    ext = band.halo([x], lo, hi)[0]
    a = band.ext_span(lo, hi)[0]
    t0, t1 = _tile_span(band.start, band.end, size, band.height)
    pooled = _avg_pool(ext[t0 - a:t1 - a], size)
    return pooled[band.start - t0:band.end - t0]


# ----------------------------------------------------------------------------
# spatial resampling (DISpatialResampling.hlsl)

GOLDEN_ANGLE = 2.39996323
BOILING_TILE = 16


def shared_offsets(frame: int, cfg: ReSTIRConfig):
    """The ``shared`` mode's (dx, dy) per round of frame `frame`: one
    golden-angle disc offset per (round, frame), computed in float32 as
    the reference computes it from its int32 frame index (its
    ``restir.py:1041-1047``), on the host, so the card is not read (a
    graph frame writes them into its device input before each replay)."""
    f32 = np.float32
    out = []
    for s_i in range(cfg.spatial_samples):
        seq = f32(np.int32(frame) * np.int32(cfg.spatial_samples)
                  + np.int32(s_i))
        frac = np.fmod(seq * f32(0.6180339887), f32(1.0))
        rad = (f32(0.35) + f32(0.6) * frac) * f32(cfg.spatial_radius) \
            + f32(1.0)
        ang = seq * f32(GOLDEN_ANGLE)
        out.append((int(np.round(rad * np.cos(ang))),
                    int(np.round(rad * np.sin(ang)))))
    return out


def _pack_surface_rows(surface: Surface):
    """(H, W, 30) rows of all a target pdf needs at a gathered neighbour
    surface (the RAB_GetGBufferSurface fetch, RTXDIAppBridge.hlsli:293-348,
    packed for one wide row gather)."""
    bs = surface.bsdf
    return torch.cat([
        surface.position, surface.normal, surface.view,
        surface.sv.front_geometric_normal,
        bs.albedo, bs.f0,
        bs.roughness[..., None], bs.ior_i[..., None], bs.ior_o[..., None],
        bs.transmission[..., None], bs.metallic[..., None],
        bs.base_color, surface.lobe_weights,
        surface.valid.to(torch.float32)[..., None],
    ], dim=-1)


def _surface_from_rows(rows) -> Surface:
    """A Surface from _pack_surface_rows output (the tangent basis
    re-derived from the shading normal)."""
    nrm = rows[..., 3:6]
    t, b = m.orthonormal_basis(nrm)
    sv = bxdf.SurfaceVectors(front_geometric_normal=rows[..., 9:12],
                             shading_normal=nrm, tangent=t, bitangent=b)
    bs = bxdf.BSDF(base_color=rows[..., 23:26], metallic=rows[..., 22],
                   albedo=rows[..., 12:15], roughness=rows[..., 18],
                   ior_i=rows[..., 19], ior_o=rows[..., 20],
                   f0=rows[..., 15:18], transmission=rows[..., 21])
    return Surface(valid=rows[..., 29] > 0.5, position=rows[..., 0:3],
                   view=rows[..., 6:9], bsdf=bs, sv=sv,
                   lobe_weights=rows[..., 26:29],
                   depth=torch.zeros_like(rows[..., 18]), normal=nrm)


def spatial_reach(cfg: ReSTIRConfig) -> int:
    """The most rows a per-pixel disc offset moves: |round(r sin a)| with
    r < spatial_radius + 1."""
    return int(math.ceil(cfg.spatial_radius)) + 1


def _spatial_neighbors(cur: Reservoirs, surface: Surface, cfg: ReSTIRConfig,
                       frame_index, with_surface: bool, frame_count=None,
                       band=None, offsets=None):
    """cfg.spatial_samples neighbours: per round, the packed rows of one
    neighbour per pixel (a disc offset per pixel, or with ``shared`` one
    shift of all rows by (dx, dy), ``packed[(y + dy) % h, (x + dx) % w]``),
    gathered once as one row (4 words, or 34 with the neighbour's
    surface), and the similarity tests. The shared offsets are `offsets`,
    a (spatial_samples, 2) int64 tensor of (dx, dy) on the device (the
    graph frame's input, which every replay rewrites), or else
    shared_offsets of `frame_count` (default int(frame_index)), computed
    on the host and copied to the device. Returns a list of dicts. With a
    ``band`` (the sharded frame's) the buffers hold the band's rows and
    the neighbours' rows come as a halo of ``spatial_reach`` rows each
    side: clamped at the frame's edges for disc offsets, wrapped for the
    shared shifts (every shared |dy| is within the reach, so the halo's
    size does not depend on the frame; the rows are gathered at the
    device offsets, as on one device)."""
    h, w = surface.depth.shape
    dev = surface.depth.device
    row0 = band.start if band is not None else 0
    py, px = _pixel_grid(h, w, dev, row0)
    rng = rng_mod.init(px, py, frame_index * 3 + 3)
    sdepth = torch.where(torch.isfinite(surface.depth), surface.depth, 1e8)
    packed = _pack_reservoirs(
        cur, sdepth, surface.normal,
        _pack_surface_rows(surface) if with_surface else None)
    shared = cfg.spatial_offset_mode == "shared"
    if shared and offsets is None:
        offsets = torch.tensor(shared_offsets(
            int(frame_index) if frame_count is None else frame_count, cfg),
            dtype=torch.int64).to(dev)
    full_h, lo = h, 0
    if band is not None:
        lo = spatial_reach(cfg)
        packed = band.halo([packed], lo, lo, cyclic=shared)[0]
        if not shared:
            full_h = band.height
            row0 = band.ext_span(lo, lo)[0]
    if shared:
        ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    flat = packed.reshape(-1, packed.shape[-1])
    out = []
    for s_i in range(cfg.spatial_samples):
        u3, rng = rng_mod.next_floats(rng, 3)
        if shared:
            # Wrapped border lanes land on the far edge and fail the
            # similarity tests like any dissimilar neighbour.
            dx, dy = offsets[s_i]
            ry = (ys + dy) % h if band is None else ys + (lo + dy)
            rows = packed.index_select(0, ry).index_select(1, (xs + dx) % w)
        else:
            radius = u3[..., 0] * cfg.spatial_radius + 1.0
            angle = u3[..., 1] * 2.0 * math.pi
            nx = torch.clamp(px + torch.round(
                radius * torch.cos(angle)).long(), 0, w - 1)
            ny = torch.clamp(py + torch.round(
                radius * torch.sin(angle)).long(), 0, full_h - 1)
            if row0:
                ny = ny - row0
            rows = flat[ny * w + nx]
        n_idx, n_uv, n_m, n_w, nd, nn, rest = _unpack_rows(rows)
        depth_ok = torch.abs(nd - sdepth) <= cfg.depth_threshold \
            * torch.clamp(torch.abs(sdepth), min=1e-3)
        normal_ok = m.dot(nn, surface.normal) >= cfg.normal_threshold
        ok = depth_ok & normal_ok & surface.valid
        n = {"idx": n_idx, "uv": n_uv, "m": torch.where(ok, n_m, 0.0),
             "w": n_w, "u_keep": u3[..., 2]}
        if with_surface:
            n["surface"] = _surface_from_rows(rest)
        out.append(n)
    return out


def _spatial_pairwise(cur: Reservoirs, surface: Surface,
                      lights: light_mod.Lights, cfg: ReSTIRConfig,
                      frame_index, scene=None, accel=None,
                      block_size: int = 16384,
                      frame_count=None, band=None,
                      offsets=None) -> Reservoirs:
    """Pairwise-MIS spatial reuse: each neighbour is balanced against the
    canonical reservoir with confidence (M) weights,

        m_i(x) = M_i p_i(x) / (k M_i p_i(x) + M_c p_c(x))
        m_c(x_c) = (1/k) sum_i M_c p_c(x_c) / (k M_i p_i(x_c) + M_c p_c(x_c))

    (the RTXDI pairwise bias correction, RTXDI.ixx:73-139), so the finalize
    divides by p only. "raytraced" (with a `scene`) multiplies both cross
    terms by a traced visibility: one batch from this surface toward each
    neighbour's sample, one from each neighbour's surface toward this
    sample."""
    raytraced = (cfg.spatial_bias_correction == "raytraced"
                 and scene is not None)
    k = float(cfg.spatial_samples)
    neighbors = _spatial_neighbors(cur, surface, cfg, frame_index, True,
                                   frame_count, band, offsets)
    phat_c, m_c = cur.phat, cur.m_count

    def cross(from_surface, idx, uv):
        """p_hat of sample (idx, uv) at `from_surface`, times its traced
        visibility in raytraced mode."""
        p_hat, direction, dist, _, _, _, _, rows = _target_pdf(
            from_surface, lights, idx, uv)
        if not raytraced:
            return p_hat
        occ = _spawn_occluded(from_surface, direction, dist, rows, scene,
                              block_size, accel, live=from_surface.valid)
        return p_hat * (~occ).to(torch.float32)

    # Pass 1: the cross evaluations and the canonical MIS weight.
    mc_weight = torch.zeros_like(phat_c)
    evals = []
    for n in neighbors:
        nsurf = n["surface"]
        phat_i_xi = _target_pdf(nsurf, lights, n["idx"], n["uv"])[0]
        phat_c_xi = cross(surface, n["idx"], n["uv"])
        phat_i_xc = cross(nsurf, cur.light_index, cur.uv)
        a_xc = k * n["m"] * phat_i_xc
        f_xc = m_c * phat_c
        mc_weight = mc_weight + torch.where(
            f_xc > 0, f_xc / torch.clamp(a_xc + f_xc, min=1e-20), 0.0) / k
        evals.append((phat_i_xi, phat_c_xi))

    # Pass 2: the streaming merge of the MIS-weighted neighbours.
    idx, uv, phat = cur.light_index, cur.uv, phat_c
    w_sum = mc_weight * phat_c * cur.w_out
    m_count = m_c
    for n, (phat_i_xi, phat_c_xi) in zip(neighbors, evals):
        a_xi = k * n["m"] * phat_i_xi
        m_i = torch.where(n["m"] > 0, n["m"] * phat_i_xi / torch.clamp(
            a_xi + m_c * phat_c_xi, min=1e-20), 0.0)
        b_w = m_i * phat_c_xi * n["w"]
        w_sum = w_sum + b_w
        take = (n["u_keep"] * w_sum) < b_w
        idx = torch.where(take, n["idx"], idx)
        uv = torch.where(take[..., None], n["uv"], uv)
        phat = torch.where(take, phat_c_xi, phat)
        m_count = m_count + n["m"]
    w_out = torch.where(phat > 0, w_sum / torch.clamp(phat, min=1e-20), 0.0)
    return Reservoirs(light_index=idx, uv=uv, w_sum=w_sum, m_count=m_count,
                      w_out=w_out, phat=phat)


def spatial_resampling(cur: Reservoirs, surface: Surface,
                       lights: light_mod.Lights, cfg: ReSTIRConfig,
                       frame_index, scene=None, accel=None,
                       block_size: int = 16384,
                       frame_count: int | None = None,
                       band=None, offsets=None) -> Reservoirs:
    """Spatial reuse over cfg.spatial_samples neighbours: 1/M in ``basic``
    mode (each neighbour's sample re-evaluated at this surface), else
    _spatial_pairwise. `frame_count` is the host's copy of `frame_index`
    for ``shared`` offsets (a tensor frame_index is read back without
    it; `offsets`, the same offsets as a device tensor, take their
    place). With a ``band`` the buffers hold its rows
    (_spatial_neighbors)."""
    check_config(cfg)
    if cfg.spatial_bias_correction in ("pairwise", "raytraced"):
        return _spatial_pairwise(cur, surface, lights, cfg, frame_index,
                                 scene, accel, block_size, frame_count, band,
                                 offsets)
    phat, idx, uv = cur.phat, cur.light_index, cur.uv
    w_sum = phat * cur.w_out * cur.m_count
    m_count = cur.m_count
    for n in _spatial_neighbors(cur, surface, cfg, frame_index, False,
                                frame_count, band, offsets):
        n_phat = _target_pdf(surface, lights, n["idx"], n["uv"])[0]
        b_w = torch.where(n["m"] > 0, n_phat * n["w"] * n["m"], 0.0)
        idx, uv, phat, w_sum, m_count = _merge(
            idx, uv, phat, w_sum, m_count, n["idx"], n["uv"], b_w, n["m"],
            n_phat, n["u_keep"])
    return _finalize(idx, uv, phat, w_sum, m_count)


# ----------------------------------------------------------------------------
# final shading (DIFinalShading.hlsl)


def final_shading(res: Reservoirs, surface: Surface, scene,
                  lights: light_mod.Lights, block_size: int = 16384,
                  accel=None):
    """(diffuse, specular) direct illumination (H, W, 3): the reservoir's
    sample shaded at this surface, with its visibility ray (B2)."""
    p_hat, direction, dist, diff, spec, emission, inv_cone, rows = \
        _target_pdf(surface, lights, res.light_index, res.uv)
    origin = intersect.safe_spawn_point(surface.position,
                                        surface.sv.front_geometric_normal,
                                        direction)
    occluded = _occluded(origin, direction, dist, scene, rows.aux,
                         block_size, accel,
                         live=surface.valid & (res.w_out > 0) & (p_hat > 0))
    weight = torch.where(surface.valid & ~occluded & (p_hat > 0),
                         res.w_out * inv_cone, 0.0)[..., None]
    return diff * emission * weight, spec * emission * weight
