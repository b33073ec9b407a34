"""Instanced triangle meshes: the general-geometry path (port of
``drts_tpu/ops/trimesh.py``).

One shared mesh (the reference instances a single geosphere) with
per-instance rigid transforms and a uniform scale. ``intersect_instances``
tightens every ray's range against the instances' bounding spheres, hands
the rays to the kernels of ``trimesh_kernels`` (the candidate loop, or the
serial walk alone with ``rounds=0``) and refines the winners' t and
barycentrics; ``intersect_instances_any`` is the shadow ray, through the
any-hit candidate loop (or the serial any-hit walk alone with
``rounds=0``); ``intersect_mesh`` is the dense sweep over one small mesh
in its own space, which the triangle lights use;
``interpolate_attributes`` fetches and interpolates the vertex attributes.
The reference's 8x128 screen-tile ray order and its sort by candidate
instance are TPU block-coherence aids with no effect on the result: rays
keep pixel order.

``MESH_CAND`` picks the closest-hit form as the reference's DRTS_MESH_CAND
does: 0 the serial walk (B7), 1 the multi-launch candidate loop (B5, B6,
then B7 on what is left), 2 the fused loop (B10, then B7). The port reads
no environment variable: the module constant is read at call time, so a
caller or a test sets it (``trimesh_kernels.CAND_ROUNDS`` is the
reference's MESH_CAND_ITERS).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend
from ..models import geometry
from ..utils import math as m
from . import intersect
from . import trimesh_kernels as tk

MESH_CAND = 1   # 0 serial walk, 1 candidate loop, 2 fused candidate loop
MESH_CAND_MODES = (0, 1, 2)


def _mesh_cand() -> int:
    """MESH_CAND as it is now, checked."""
    if MESH_CAND not in MESH_CAND_MODES:
        raise ValueError(f"MESH_CAND must be one of {MESH_CAND_MODES}, got "
                         f"{MESH_CAND!r}")
    return MESH_CAND


@dataclasses.dataclass(frozen=True)
class TriMesh:
    """Shared triangle mesh, SoA. Faces are stored in Morton (centroid)
    order (make_mesh permutes them), so a kernel's packed face row is the
    face index."""
    positions: torch.Tensor  # (V, 3)
    normals: torch.Tensor    # (V, 3)
    uvs: torch.Tensor        # (V, 2)
    tangents: torch.Tensor   # (V, 3)
    faces: torch.Tensor      # (F, 3) int64
    # Per-face corners for the intersection sweep.
    v0: torch.Tensor         # (F, 3)
    e1: torch.Tensor         # (F, 3) v1 - v0
    e2: torch.Tensor         # (F, 3) v2 - v0
    bound_radius: torch.Tensor  # scalar: mesh-space bounding radius
    # BLAS tables (built once per mesh): padded Morton-ordered triangle
    # rows, and per run of tri_chunk rows a covering sphere and a guard
    # cone, by which B6, B8, B9 and B10 cull per lane (trimesh_kernels.
    # tri_chunk_bounds). The reference's tri_bounds has 8 rows: 0-3 the
    # same spheres (at its own chunk), 4-7 normal cones for its convex
    # back-face cull, which the port does not have; its n_chunks, convex
    # and local_radius feed only its own culls.
    tri_tbl: torch.Tensor = None     # (F_pad, 9) [v0 e1 e2]
    tri_bounds: torch.Tensor = None  # (10, C_pad) [cx cy cz r wx wy wz c s h]
    tri_chunk: int = tk.TRI_CHUNK
    # Radius of the largest origin-centred ball that lies inside the mesh
    # (0 for an open mesh or an origin outside): it licenses the bounds
    # pre-pass's tmax clamp.
    inscribed_radius: float = 0.0
    # Optional (V, 3) previous - current object-space position per vertex
    # (deforming meshes); None = rigid. Kept as a field; its G-buffer use
    # is not ported.
    vertex_motion: torch.Tensor = None


def _inscribed_radius(v0, e1, e2, faces) -> float:
    """Largest r such that the origin-centred ball of radius r lies inside
    the mesh: a ray segment through instance i's inscribed ball must hit
    i's surface before it leaves i's bounding sphere. Returns 0 unless the
    mesh is a closed oriented 2-manifold with the origin inside. Numpy,
    O(F)."""
    f = faces.shape[0]
    if f == 0:
        return 0.0
    # Closed oriented manifold: every directed edge appears exactly once
    # and pairs with its reverse.
    de = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                         faces[:, [2, 0]]])
    key = de[:, 0].astype(np.int64) * (de.max() + 1) + de[:, 1]
    rkey = de[:, 1].astype(np.int64) * (de.max() + 1) + de[:, 0]
    if len(np.unique(key)) != len(key):
        return 0.0
    if not np.isin(rkey, key).all():
        return 0.0
    # Origin inside: crossing parity along an arbitrary direction.
    d = np.array([0.57735027, 0.577350029, 0.5773504], np.float64)
    pv = np.cross(d, e2.astype(np.float64))
    det = np.einsum("fi,fi->f", pv, e1.astype(np.float64))
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = -v0.astype(np.float64)
    u = np.einsum("fi,fi->f", tv, pv) * inv
    qv = np.cross(tv, e1.astype(np.float64))
    vbar = qv @ d * inv
    t = np.einsum("fi,fi->f", qv, e2.astype(np.float64)) * inv
    crossings = ok & (u >= 0) & (vbar >= 0) & (u + vbar <= 1) & (t > 0)
    if int(crossings.sum()) % 2 == 0:
        return 0.0
    # Exact origin-to-triangle distance: the interior critical point (when
    # inside the barycentric domain) and the three clamped edges.
    v0d = v0.astype(np.float64)
    e1d = e1.astype(np.float64)
    e2d = e2.astype(np.float64)
    a = np.einsum("fi,fi->f", e1d, e1d)
    b = np.einsum("fi,fi->f", e1d, e2d)
    c = np.einsum("fi,fi->f", e2d, e2d)
    dd = np.einsum("fi,fi->f", e1d, v0d)
    e = np.einsum("fi,fi->f", e2d, v0d)
    det2 = a * c - b * b
    good = det2 > 1e-18
    s = np.where(good, (b * e - c * dd) / np.where(good, det2, 1.0), -1.0)
    tt = np.where(good, (b * dd - a * e) / np.where(good, det2, 1.0), -1.0)
    inside = good & (s >= 0) & (tt >= 0) & (s + tt <= 1)
    p_in = v0d + s[:, None] * e1d + tt[:, None] * e2d
    d2_in = np.where(inside, np.einsum("fi,fi->f", p_in, p_in), np.inf)

    def edge_d2(av, dv):
        dvdv = np.einsum("fi,fi->f", dv, dv)
        tcl = np.clip(-np.einsum("fi,fi->f", av, dv)
                      / np.maximum(dvdv, 1e-18), 0.0, 1.0)
        p = av + tcl[:, None] * dv
        return np.einsum("fi,fi->f", p, p)

    d2 = np.minimum(d2_in, edge_d2(v0d, e1d))
    d2 = np.minimum(d2, edge_d2(v0d, e2d))
    d2 = np.minimum(d2, edge_d2(v0d + e1d, e2d - e1d))
    return float(max(np.sqrt(d2.min()) * (1.0 - 1e-5), 0.0))


def make_mesh(positions, normals, uvs, faces, tangents=None,
              vertex_motion=None, device="cuda") -> TriMesh:
    """Build a TriMesh from numpy arrays: per-face corners, the BLAS tables
    (trimesh_kernels.build_mesh_tables at TRI_CHUNK), the inscribed
    radius, all in Morton face order."""
    device = backend.device(device)
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    uvs = np.asarray(uvs, np.float32)
    faces = np.asarray(faces, np.int32)
    if tangents is None:
        tangents = geometry.compute_tangent_frame(faces, positions, normals,
                                                  uvs)
    v0 = positions[faces[:, 0]]
    e1 = positions[faces[:, 1]] - v0
    e2 = positions[faces[:, 2]] - v0
    order, tri_tbl, tri_bounds = tk.build_mesh_tables(v0, e1, e2,
                                                      tk.TRI_CHUNK)
    r_ins = _inscribed_radius(v0, e1, e2, faces)
    lengths = np.sqrt((positions * positions).sum(-1))

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return TriMesh(
        positions=tensor(positions), normals=tensor(normals),
        uvs=tensor(uvs), tangents=tensor(np.asarray(tangents, np.float32)),
        faces=tensor(faces[order].astype(np.int64)),
        v0=tensor(v0[order]), e1=tensor(e1[order]), e2=tensor(e2[order]),
        bound_radius=torch.tensor(lengths.max(), device=device),
        tri_tbl=tensor(tri_tbl), tri_bounds=tensor(tri_bounds),
        tri_chunk=tk.TRI_CHUNK, inscribed_radius=r_ins,
        vertex_motion=(None if vertex_motion is None
                       else tensor(np.asarray(vertex_motion, np.float32))))


@dataclasses.dataclass(frozen=True)
class TriHit:
    hit: torch.Tensor           # (...,) bool
    t: torch.Tensor             # (...,)
    face: torch.Tensor          # (...,) int64
    instance: torch.Tensor      # (...,) int64
    barycentrics: torch.Tensor  # (..., 2) (u, v) of v1/v2


# Elements of one (rays, faces) plane of intersect_mesh's temporaries.
_DENSE_PLANE = 1 << 22


def _moller_trumbore(o, d, v0, e1, e2, t_min, t_max, eps=1e-8):
    """Two-sided Moeller-Trumbore of rays (B, 3) against triangles (F, 3):
    (B, F) hit t (inf where none, or |det| <= eps) and barycentrics."""
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    v0x, v0y, v0z = (v0[None, :, i] for i in range(3))
    e1x, e1y, e1z = (e1[None, :, i] for i in range(3))
    e2x, e2y, e2z = (e2[None, :, i] for i in range(3))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    sound = torch.abs(det) > eps
    inv_det = torch.where(sound, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (qvx * dx + qvy * dy + qvz * dz) * inv_det
    t = (qvx * e2x + qvy * e2y + qvz * e2z) * inv_det
    valid = (sound & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= t_min[:, None]) & (t <= t_max[:, None]))
    return torch.where(valid, t, float("inf")), u, v


def intersect_mesh(origin, direction, t_min, t_max, mesh):
    """Closest hit against one mesh in its own space, a dense sweep of
    every ray over every face (`mesh` needs v0, e1, e2 only). origin,
    direction: (..., 3); t_min, t_max broadcastable to (...,). Returns
    (t, face, u, v); ties go to the lowest face, a miss has t = inf and
    face 0. Rays go in blocks, so the (rays, faces) temporaries stay at
    _DENSE_PLANE elements each."""
    lead = origin.shape[:-1]
    n = origin[..., 0].numel()
    dev = origin.device

    def flat(x):
        return torch.broadcast_to(m.as_f32(x, dev), lead).reshape(n)

    o, d = origin.reshape(n, 3), direction.reshape(n, 3)
    tmin, tmax = flat(t_min), flat(t_max)
    f = mesh.v0.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    face = torch.empty(n, dtype=torch.int64, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    step = max(_DENSE_PLANE // max(f, 1), 1)
    for s in range(0, n, step):
        e = slice(s, s + step)
        tb, ub, vb = _moller_trumbore(o[e], d[e], mesh.v0, mesh.e1, mesh.e2,
                                      tmin[e], tmax[e])
        t[e], arg = tb.min(dim=1)
        face[e] = arg
        u[e] = ub.gather(1, arg[:, None])[:, 0]
        v[e] = vb.gather(1, arg[:, None])[:, 0]
    face = torch.clamp(face, max=f - 1)
    return (t.reshape(lead), face.reshape(lead), u.reshape(lead),
            v.reshape(lead))


def _bounds_prepass(origin, direction, t_min, t_max, mesh: TriMesh,
                    inst_position, inst_scale, block_size: int = 16384,
                    any_hit: bool = False):
    """Per-lane range tightening before the mesh kernels, by brute-force
    sphere sweeps over the M instance bounds:

    1. kill: a lane whose segment misses every instance bounding sphere
       cannot hit the mesh and gets a dead range (tmax < tmin);
    2. clamp (closest hit only, inscribed_radius > 0): a lane through
       instance i's inscribed ball is sure to hit a surface before it
       leaves i's bounding sphere, so tmax clamps to t_entry + 2 r_bound.

    t_min, t_max: lead-shaped. Returns the tightened t_max."""
    r_bound = mesh.bound_radius * inst_scale
    dead = torch.clamp(t_min, max=0.0) - 1.0
    if any_hit:
        reach = intersect.intersect_spheres_any(
            origin, direction, torch.clamp(t_min, min=0.0), t_max,
            block_size, centers=inst_position, radii=r_bound)
        return torch.where(reach, t_max, dead)
    hit_b = intersect.intersect_spheres(origin, direction,
                                        torch.clamp(t_min, min=0.0), t_max,
                                        inst_position, r_bound, block_size)
    t_max_new = torch.where(hit_b.hit, t_max, dead)
    if mesh.inscribed_radius <= 0.0:
        return t_max_new
    r_ins = mesh.inscribed_radius * inst_scale
    hit_i = intersect.intersect_spheres(origin, direction, t_min, t_max_new,
                                        inst_position, r_ins, block_size)
    clamp = hit_i.t + 2.0 * r_bound[hit_i.index] * 1.0001 + 1e-4
    return torch.where(hit_i.hit, torch.minimum(t_max_new, clamp), t_max_new)


def _pack_for_mesh_kernel(origin, direction, t_min, t_max, mesh,
                          inst_position, inst_rotation, inst_scale):
    """Planar rays in pixel order and the per-call TLAS tables, ordered
    near to far from the centroid of the live rays' origins. Returns (rays
    (8, N), inst_tbl, inst_bounds, order, n_ichunks)."""
    n = t_min.numel()
    o = origin.reshape(n, 3)
    tmn, tmx = t_min.reshape(n), t_max.reshape(n)
    rays = intersect.pack_rays(o, direction.reshape(n, 3), tmn, tmx)
    live = (tmx >= tmn).to(torch.float32)
    cnt = torch.clamp(live.sum(), min=1.0)
    sort_origin = (o * live[:, None]).sum(dim=0) / cnt
    return (rays, *tk.make_inst_tables(
        inst_position, inst_rotation, inst_scale, mesh.bound_radius,
        sort_origin=sort_origin))


def intersect_instances(origin, direction, t_min, t_max, mesh: TriMesh,
                        inst_position, inst_rotation, inst_scale,
                        rounds: int | None = None,
                        block_size: int = 16384) -> TriHit:
    """Closest hit of rays against M instances of one mesh.

    origin/direction: (..., 3), unit directions; t_min/t_max broadcastable
    to (...,) with t_min >= 0. The form is MESH_CAND's, read now; `rounds`
    (default trimesh_kernels.CAND_ROUNDS, read now) candidate rounds run
    before the serial walk takes what is left, and 0 runs the serial walk
    alone."""
    mode = _mesh_cand()
    if rounds is None:
        rounds = tk.CAND_ROUNDS
    lead = origin.shape[:-1]

    def full(x):
        return torch.broadcast_to(m.as_f32(x, origin.device), lead)

    t_min = full(t_min)
    t_max = _bounds_prepass(origin, direction, t_min, full(t_max), mesh,
                            inst_position, inst_scale, block_size)
    rays, inst_tbl, inst_bounds, order, n_ic = _pack_for_mesh_kernel(
        origin, direction, t_min, t_max, mesh, inst_position, inst_rotation,
        inst_scale)
    if mode and rounds > 0:
        if mode == 2:
            t_p, face_p, inst_p = tk.intersect_mesh_instances_cand_fused(
                rays, inst_tbl, inst_bounds, mesh.tri_tbl, mesh.tri_bounds,
                mesh.tri_chunk, n_ic, rounds=rounds, block=block_size)
        else:
            t_p, face_p, inst_p = tk.intersect_mesh_instances_cand(
                rays, inst_tbl, inst_bounds, mesh.tri_tbl, mesh.tri_bounds,
                mesh.tri_chunk, n_ic, rounds=rounds, block=block_size)
    else:
        t_p, face_p, inst_p = tk.intersect_mesh_instances(
            rays, inst_tbl, inst_bounds, mesh.tri_tbl, n_ic, mesh.tri_bounds,
            mesh.tri_chunk, block_size)
    # The kernels' instance ids are table positions; map them back.
    inst_p = torch.clamp(
        order[torch.clamp(inst_p.long(), max=order.shape[0] - 1)], min=0)

    t_p = t_p.reshape(lead)
    face_p = torch.clamp(face_p.long(), max=mesh.v0.shape[0] - 1
                         ).reshape(lead)
    inst_p = torch.clamp(inst_p, max=inst_position.shape[0] - 1
                         ).reshape(lead)
    t_exact, u, v = tk.refine_hit(mesh, inst_position, inst_rotation,
                                  inst_scale, origin, direction, t_p, face_p,
                                  inst_p)
    hit = torch.isfinite(t_p) & torch.isfinite(t_exact)
    return TriHit(hit=hit, t=torch.where(hit, t_exact, float("inf")),
                  face=face_p, instance=inst_p,
                  barycentrics=torch.stack([u, v], dim=-1))


def intersect_instances_any(origin, direction, t_min, t_max, mesh: TriMesh,
                            inst_position, inst_rotation, inst_scale,
                            rounds: int | None = None,
                            block_size: int = 16384):
    """Any hit (shadow ray) of rays against M instances of one mesh: True
    where some triangle lies in [t_min, t_max]. Shapes as
    intersect_instances. As the reference, MESH_CAND 1 and 2 both run the
    any-hit candidate loop (there is no fused any-hit kernel) and 0 the
    serial any-hit walk alone; `rounds` (default
    trimesh_kernels.ANY_ROUNDS, read now) any-hit candidate rounds run
    before the serial walk takes what is left, and 0 runs it alone."""
    mode = _mesh_cand()
    if rounds is None:
        rounds = tk.ANY_ROUNDS
    lead = origin.shape[:-1]

    def full(x):
        return torch.broadcast_to(m.as_f32(x, origin.device), lead)

    t_min = full(t_min)
    t_max = _bounds_prepass(origin, direction, t_min, full(t_max), mesh,
                            inst_position, inst_scale, block_size,
                            any_hit=True)
    rays, inst_tbl, inst_bounds, _, n_ic = _pack_for_mesh_kernel(
        origin, direction, t_min, t_max, mesh, inst_position, inst_rotation,
        inst_scale)
    if mode and rounds > 0:
        occ = tk.intersect_mesh_instances_any_cand(
            rays, inst_tbl, inst_bounds, mesh.tri_tbl, mesh.tri_bounds,
            mesh.tri_chunk, n_ic, rounds=rounds, block=block_size)
    else:
        occ = tk.intersect_mesh_instances_any(
            rays, inst_tbl, inst_bounds, mesh.tri_tbl, mesh.tri_bounds,
            mesh.tri_chunk, n_ic, block=block_size) > 0
    return occ.reshape(lead)


def interpolate_attributes(mesh: TriMesh, hit: TriHit, inst_rotation):
    """Vertex fetch and barycentric interpolation (Vertex::Interpolate /
    HitInfo::Initialize), rotated to world. Returns (normal, uv,
    tangent)."""
    tri = mesh.faces[hit.face]                          # (..., 3)
    w = 1.0 - hit.barycentrics[..., 0] - hit.barycentrics[..., 1]
    bary = torch.stack([w, hit.barycentrics[..., 0],
                        hit.barycentrics[..., 1]], dim=-1)[..., None]

    def interp(attr):
        return torch.sum(attr[tri] * bary, dim=-2)

    rot = inst_rotation[hit.instance]
    normal = m.normalize(m.quat_rotate(rot, interp(mesh.normals)))
    tangent = m.normalize(m.quat_rotate(rot, interp(mesh.tangents)))
    return normal, interp(mesh.uvs), tangent
