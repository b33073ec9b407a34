"""The instanced triangle-mesh kernels of the port: table makers,
wrappers, plain versions, counters and the candidate loop.

Counterpart of ``drts_tpu/ops/trimesh_pallas.py``. One shared object-space
mesh (the BLAS: a Morton-ordered triangle table) is instanced by rigid
transforms with a uniform scale (the TLAS: a per-call instance table).
Each TPU kernel of the closest-hit and the any-hit half becomes a CUDA C++
kernel for Hopper in ``csrc/trimesh.cu``:

- ``bound_scan`` replaces ``trimesh_pallas.bound_scan`` (B5): per ray, the
  next instance bounding sphere, front to back, past the ray's cursor.
- ``shared_blas_sweep`` replaces ``trimesh_pallas.shared_blas_sweep`` (B6):
  per ray, Moeller-Trumbore against the shared triangle table in the frame
  of the ray's own candidate instance, folded into the running best.
- ``intersect_mesh_instances`` replaces
  ``trimesh_pallas.intersect_mesh_instances`` (B7): the serial walk over
  every instance, the exact backstop of the candidate loop.
- ``shared_blas_any`` replaces ``trimesh_pallas.shared_blas_any`` (B8): the
  any-hit twin of B6, one blocked bit per ray, the sweep left at the first
  blocking triangle.
- ``intersect_mesh_instances_any`` replaces
  ``trimesh_pallas.intersect_mesh_instances_any`` (B9): the any-hit twin of
  B7, the exact backstop of the any-hit candidate loop. Its kernel compacts
  each block's live lanes; a block with fewer than ``B9_SPARSE_LIVE`` of
  them puts all its threads on one live ray at a time.
- ``cand_fused`` replaces ``trimesh_pallas.cand_fused`` (B10): every round
  of the candidate loop (B5, then B6 on the candidate found) and the last
  scan in one launch, each lane walking its own candidates in the loop's
  order, so it returns the loop's words.

What the TPU kernels were: blocks of 2,048 rays that decide per block (a
bundle's origin sphere and direction cone cull instance chunks, instances
and triangle chunks for the whole block; B6 loops over the block's
distinct candidates). Those culls are conservative and change no result.
On the H100 each kernel but B9 takes one thread per ray, which reads its
own candidate row and keeps its best in a register (B9 compacts a block's
live lanes first); a pair costs ~25 (B5) or ~50 (B6-B9) separately
rounded float32 operations against 32-48 bytes per ray, so all of them
are bound by the instruction rate, not by memory, but for B7 on a
backstop batch of dead lanes. Culls kept: a dead lane (tmax < tmin) does
no work and a block of dead lanes leaves before it reads a table
(B5-B10); B5 and B10's scan test each ray against the instance chunks'
covering spheres, with a
segment that ends at its best key so far (B1's half-line cull,
``intersect_kernels.segment_misses``), sweep only the rows of the chunks
they meet and take no root where the discriminant is negative
(``bound_scan_walk`` repeats the walk and ``bound_scan_work`` counts it);
B6-B10's sweeps test the ray, in the instance's object frame, against
the covering spheres of the triangle table's chunks (``tri_bounds``, runs
of ``chunk`` Morton-ordered rows), and in a chunk the segment misses they
skip each face that the ray does not graze (``face_guards``;
csrc/trimesh.cu states why a skip is exact against Moeller-Trumbore, B7's
and B9's direction of length 1/scale included); ``tri_sweep_walk``
repeats that sweep, ``shared_blas_any_walk``,
``intersect_mesh_instances_walk``, ``intersect_mesh_instances_any_walk``
and ``cand_fused_walk`` the kernels of B8, B7, B9 and B10, and
``shared_blas_sweep_work``, ``shared_blas_any_work``,
``intersect_mesh_instances_work``, ``intersect_mesh_instances_any_work``
and ``cand_fused_work`` count the walks of B6, B8, B7, B9 and B10; B7 and
B9 test each ray against the instance chunks' covering spheres and the
instances' bounding spheres, with the ray's running best (B7) or its own
tmax (B9) as the far limit, and sweep only what passes. Left out, none
of which changes a result: the
reference's normal-cone and convex back-face culls, B10's bundle cone,
its far-chunk cut (farc) and its front-to-back chunk order (MESH_F2B): a
packed min does not depend on the order of the visits.

Ray directions are unit vectors on this path (B5, the bounds pre-pass and
the sphere tests of B7 and B9 take the quadratic's leading coefficient as
1).

Dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the kernel, or the wrapper raises. There
is no fallback. Each wrapper counts its launches in ``backend.LAUNCHES``.
The kernels equal their plain versions bit for bit: same operations, same
order, no fused multiply-add, IEEE division and square root.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..models.clusters import _morton3
from ..utils import math as m
from . import intersect_kernels
from .intersect_kernels import INF_BITS, _blocks, _check, pos_bits

TRI_PAD = 64          # the triangle table is padded to a multiple of this
# Faces per shared-memory tile of the triangle kernels (csrc/trimesh.cu's
# kFaceTile); B7 stages a wider table into scratch memory instead.
FACE_TILE = 512
# Faces per chunk of the triangle table, one covering sphere and guard cone
# each (tri_bounds): the chunk size the kernels use, chosen by timing 8,
# 16, 32 and 64 on the card (chip_smoke.py phases 10 and 12; PERF.md).
TRI_CHUNK = 8
# The triangle-chunk cull of B6, B8-B10 (csrc/trimesh.cu derives both):
# a lane skips a face of a chunk whose covering sphere its object-space
# segment misses by more than the margin of TRI_CULL_SCALE, unless the ray
# grazes the face (|d . A| < TRI_GUARD, face_guards). Moeller-Trumbore's
# accepted t puts the ray within 1816 u S of the face at TRI_GUARD = 2^-6
# (u = 2^-24, S = |o|_1 + |C|_1 + R + |t|); 2^-13 = 2048 u S also covers
# the covering radius's rounding and the cull test's own. Setting either
# to 0 loses hits (tests/test_torch_tri_culls.py).
TRI_CULL_SCALE = 2.0 ** -13
TRI_GUARD = 2.0 ** -6
# Rows of tri_bounds: [cx cy cz r] the covering sphere, [wx wy wz c s h]
# the guard cone (tri_chunk_bounds).
TRI_BOUND_ROWS = 10
INST_CHUNK = 16       # instances per TLAS chunk
BSCAN_CHUNK = 128     # the bound-scan table is padded to a multiple of this
CAND_ROUNDS = 3       # candidate rounds before the serial backstop
ANY_ROUNDS = 2        # any-hit candidate rounds before the serial backstop
# Slack of B7's per-ray sphere tests: radius * BOUND_SCALE + BOUND_PAD
# (the kernel takes both, and INST_CHUNK, as arguments).
BOUND_SCALE = 1.0001
BOUND_PAD = 1e-5
# B9's kernel: a block with fewer live lanes than this takes them one at a
# time with all its threads, the others one thread per live lane; chosen
# by timing thresholds on the card (chip_smoke.py phase 10; PERF.md). It
# changes no result.
B9_SPARSE_LIVE = 32


# ----------------------------------------------------------------------------
# Tables


def check_tri_chunk(chunk: int) -> int:
    """A triangle chunk size: a positive multiple of 8 that divides
    TRI_PAD, else ValueError."""
    if (not isinstance(chunk, (int, np.integer)) or chunk <= 0
            or chunk % 8 or TRI_PAD % chunk):
        raise ValueError(f"triangle chunk {chunk!r} is not a positive "
                         f"multiple of 8 that divides {TRI_PAD}")
    return int(chunk)


def _chunk_cone(rows: np.ndarray):
    """One chunk's guard cone (w (3,) float32, c, s, h as float64): for
    every ray direction d with |d.d - 1| <= 2^-8, each face's G = |d . A|
    / |d| (A = e1 x e2 / (|e1| |e2|), exact from the float32 rows) is at
    least c |d . w| - s sqrt(d.d - (d . w)^2), and a lane that computes
    that in float32 and subtracts h stays below it. A face with e1 = 0 or
    e2 = 0 is left out (Moeller-Trumbore's u or v is NaN there); a chunk
    of such faces only gets c = s = 0, h = -1 (every face skipped); any
    other face with |e1| |e2| < 2^-64 or a non-finite row gives no cone
    (c = s = 0, h = 1).

    Derivation: with n_f = A_f / q_f (q_f = |A_f|) at angle t_f from the
    axis w / |w| (two-sided: |n_f . w| = |w| cos t_f), |d . n_f| >=
    cos t_f |d . w| / |w| - sin t_f sqrt(|d|^2 - (d . w)^2 / |w|^2), so
    G_f >= q (cos t |d . w| - sin t sqrt(|d|^2 |w|^2 - (d . w)^2)) /
    (|d| |w|) with q = min q_f, cos t = min cos t_f (sin t the largest
    sin t_f); c and s are q cos t
    and q sin t over 1.0021 >= |d| |w| (where the bracket is positive,
    which a skip needs). h covers the lane's float32: the sqrt of a value
    off by <= 12u (the rounding of d . w, d.d and the difference) and by
    |w|^2 - 1 (<= 3.7u), off by <= sqrt(12u) + sqrt(3.7u) < 1.33e-3, and
    <= 8u for the rest."""
    e1 = rows[:, 3:6].astype(np.float64)
    e2 = rows[:, 6:9].astype(np.float64)
    none = (np.zeros(3, np.float32), 0.0, 0.0, 1.0)
    if not (np.isfinite(e1).all() and np.isfinite(e2).all()):
        return none
    den = np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1)
    if ((den > 0) & (den < 2.0 ** -64)).any():
        return none
    if not (den > 0).any():
        return np.zeros(3, np.float32), 0.0, 0.0, -1.0
    a = np.cross(e1[den > 0], e2[den > 0]) / den[den > 0, None]
    q = np.linalg.norm(a, axis=1)
    if not (q > 0).all():
        return none
    n = a / q[:, None]
    m = (np.where(n @ n[0] < 0, -1.0, 1.0)[:, None] * n).sum(0)
    if np.linalg.norm(m) < 1e-6:
        return none
    w = (m / np.linalg.norm(m)).astype(np.float32)
    w64 = w.astype(np.float64)
    cos_t = (np.abs(n @ w64) / np.linalg.norm(w64)).min()
    sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
    s = q.min() * sin_t / 1.0021
    return w, q.min() * cos_t / 1.0021, s, s * 1.33e-3 + 8 * 2.0 ** -24


def _f32(x: float, up: bool) -> np.float32:
    """x rounded to float32 upwards (up) or downwards."""
    y = np.float32(x)
    if up and y < x:
        return np.nextafter(y, np.float32(np.inf))
    if not up and y > x:
        return np.nextafter(y, np.float32(-np.inf))
    return y


def tri_chunk_bounds(tbl: np.ndarray, chunk: int) -> np.ndarray:
    """(TRI_BOUND_ROWS, C_pad) float32, one column per run of `chunk` rows
    of the triangle table (F_pad, 9), C_pad the chunk count rounded up to 8
    (zero columns beyond). Rows 0-3 [cx cy cz r]: the covering sphere, the
    padding rows' corners included, by the reference's formula
    (trimesh_pallas.build_mesh_tables, rows 0-3): the mean of the chunk's 3
    x chunk corners and the largest distance to it plus 1e-5. Rows 4-9 [wx
    wy wz c s h]: the guard cone (_chunk_cone; c rounded down, s and h
    up): a lane whose c |d . w| - s sqrt(d.d - (d . w)^2) - h reaches
    TRI_GUARD skips the chunk's guard tests (the reference's rows 4-7 are
    another cone, for its back-face cull)."""
    chunk = check_tri_chunk(chunk)
    f_pad = tbl.shape[0]
    if f_pad % chunk:
        raise ValueError(f"{f_pad} triangle rows are not whole chunks of "
                         f"{chunk}")
    n_chunks = f_pad // chunk
    bounds = np.zeros((TRI_BOUND_ROWS, -(-n_chunks // 8) * 8), np.float32)
    for c in range(n_chunks):
        rows = tbl[c * chunk:(c + 1) * chunk]
        pts = np.concatenate([rows[:, 0:3],
                              rows[:, 0:3] + rows[:, 3:6],
                              rows[:, 0:3] + rows[:, 6:9]])
        ctr = pts.mean(axis=0)
        bounds[0:3, c] = ctr
        bounds[3, c] = np.sqrt(((pts - ctr) ** 2).sum(-1)).max() + 1e-5
        w, cos_q, sin_q, slack = _chunk_cone(rows)
        bounds[4:7, c] = w
        bounds[7:10, c] = (_f32(cos_q, False), _f32(sin_q, True),
                           _f32(slack, True))
    return bounds


def build_mesh_tables(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                      chunk: int):
    """Host-side BLAS build (numpy, once per mesh): Morton-order the faces
    by centroid and pad to a multiple of TRI_PAD with all-zero rows, which
    never hit. Returns (order (F,), tri_tbl (F_pad, 9) [v0 e1 e2],
    tri_bounds (TRI_BOUND_ROWS, C_pad) from tri_chunk_bounds(tri_tbl,
    chunk))."""
    chunk = check_tri_chunk(chunk)
    f = v0.shape[0]
    cent = v0 + (e1 + e2) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-9)
    quant = np.clip((cent - lo) / span * 1023.0, 0, 1023).astype(np.uint64)
    order = np.argsort(_morton3(quant), kind="stable").astype(np.int32)

    f_pad = -(-f // TRI_PAD) * TRI_PAD
    tbl = np.zeros((f_pad, 9), np.float32)
    tbl[:f, 0:3] = v0[order]
    tbl[:f, 3:6] = e1[order]
    tbl[:f, 6:9] = e2[order]
    return order, tbl, tri_chunk_bounds(tbl, chunk)


def _spread_bits(v):
    """10-bit -> 30-bit Morton spread of an int64 tensor."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def make_inst_tables(center, rotation, scale, bound_radius,
                     sort_origin=None):
    """Per-call TLAS build, on the tensors' device:

    1. Morton-sort the instances by centre (a stable sort),
    2. group runs of INST_CHUNK into chunks with covering spheres,
    3. order the chunks near to far from `sort_origin`.

    Returns (inst_tbl (9, M_pad) [px py pz qx qy qz qw 1/scale
    world_bound_radius], padded columns with radius 0; inst_bounds
    (4, IC_pad) chunk spheres; order (M_pad,) int64 table position ->
    instance id, -1 on padding; n_ichunks)."""
    mcount = center.shape[0]
    dev = center.device
    n_ic = -(-mcount // INST_CHUNK)
    m_pad = n_ic * INST_CHUNK

    lo = center.amin(dim=0)
    span = torch.clamp(center.amax(dim=0) - lo, min=1e-6)
    q = torch.clamp((center - lo) / span * 1023.0, 0.0, 1023.0).long()
    code = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
            | (_spread_bits(q[:, 2]) << 2))
    order = torch.argsort(code, stable=True)
    order = torch.cat([order, torch.full((m_pad - mcount,), -1,
                                         dtype=torch.int64, device=dev)])

    valid = order >= 0
    idx = torch.clamp(order, min=0)
    radius_w = bound_radius * scale
    sc = torch.where(valid[:, None], center[idx], 0.0)       # (M_pad, 3)
    sr = torch.where(valid, radius_w[idx], 0.0)              # (M_pad,)

    # Chunk bounds: centroid of the valid members and a covering radius.
    scc = sc.reshape(n_ic, INST_CHUNK, 3)
    vcc = valid.reshape(n_ic, INST_CHUNK)
    src = sr.reshape(n_ic, INST_CHUNK)
    cnt = torch.clamp(vcc.sum(dim=1, keepdim=True), min=1)
    ctr = (scc * vcc[..., None]).sum(dim=1) / cnt            # (IC, 3)
    d = torch.sqrt(((scc - ctr[:, None, :]) ** 2).sum(dim=-1))
    rad = torch.where(vcc, d + src, 0.0).amax(dim=1) + 1e-5

    if sort_origin is not None:
        dist = torch.sqrt(((ctr - sort_origin) ** 2).sum(dim=-1))
        corder = torch.argsort(dist, stable=True)
        ctr = ctr[corder]
        rad = rad[corder]
        order = order.reshape(n_ic, INST_CHUNK)[corder].reshape(m_pad)
        valid = order >= 0
        idx = torch.clamp(order, min=0)

    ic_pad = -(-n_ic // 8) * 8
    inst_bounds = torch.zeros((4, ic_pad), dtype=torch.float32, device=dev)
    inst_bounds[0:3, :n_ic] = ctr.T
    inst_bounds[3, :n_ic] = rad

    inv_s = 1.0 / torch.clamp(scale, min=1e-12)

    def row(x, fill=0.0):
        return torch.where(valid, x[idx].to(torch.float32), fill)

    inst_tbl = torch.stack([
        row(center[:, 0]), row(center[:, 1]), row(center[:, 2]),
        row(rotation[:, 0]), row(rotation[:, 1]), row(rotation[:, 2]),
        row(rotation[:, 3], 1.0),
        row(inv_s, 1.0),
        row(radius_w),       # padded columns: radius 0, never entered
    ])
    return inst_tbl, inst_bounds, order, n_ic


def make_bscan_table(inst_tbl):
    """B5's table from the instance table: (M_pad128, 4) rows [cx cy cz
    |c|^2 - r^2], with 1e30 in the last column on padding (radius 0), so
    the discriminant is negative there."""
    mm = inst_tbl.shape[1]
    m_pad = -(-mm // BSCAN_CHUNK) * BSCAN_CHUNK
    cx, cy, cz, r = inst_tbl[0], inst_tbl[1], inst_tbl[2], inst_tbl[8]
    ccrr = torch.where(r > 0.0, cx * cx + cy * cy + cz * cz - r * r, 1e30)
    tbl = torch.zeros((m_pad, 4), dtype=torch.float32,
                      device=inst_tbl.device)
    tbl[:, 3].fill_(1e30)
    tbl[:mm] = torch.stack([cx, cy, cz, ccrr], dim=1)
    return tbl


# ----------------------------------------------------------------------------
# Shared pieces of the plain versions


def _check_words(name, x, n, device):
    if x.dtype != torch.int32 or x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, rays on {device}")


def _check_table(name, x, rows, device, rows_first=True):
    shape_ok = x.dim() == 2 and (x.shape[0] if rows_first
                                 else x.shape[1]) == rows
    if x.dtype != torch.float32 or not shape_ok or not x.is_contiguous():
        want = f"({rows}, M)" if rows_first else f"(M, {rows})"
        raise ValueError(f"{name} must be a contiguous {want} float32 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, rays on {device}")


def _check_rays(rays):
    _check("rays", rays, 8)
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")


def _conj_rotate(qx, qy, qz, qw, vx, vy, vz):
    """Rotate (vx, vy, vz) by the conjugate of the quaternion (world ->
    object): v' = v + 2 qv x (qv x v + w v) with qv negated."""
    ax, ay, az = -qx, -qy, -qz
    c1x = ay * vz - az * vy + qw * vx
    c1y = az * vx - ax * vz + qw * vy
    c1z = ax * vy - ay * vx + qw * vz
    rx = vx + 2.0 * (ay * c1z - az * c1y)
    ry = vy + 2.0 * (az * c1x - ax * c1z)
    rz = vz + 2.0 * (ax * c1y - ay * c1x)
    return rx, ry, rz


def _mt_pairs(ol, dl, tmn, tmx, rows, trunc, pos):
    """Two-sided Moeller-Trumbore of L rays (ol, dl: three (L,) tensors
    each; tmn, tmx (L,)) against the triangle rows (R, 9) at table
    positions pos (R,) int32. Returns (L, R) int32: the packed (t bits &
    trunc | pos) where the hit lies in [tmn, tmx], INF_BITS elsewhere.
    1 / det is +-inf on a degenerate or padded row, whose NaN or inf u, v,
    t fail the compares."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (c[None, :]
                                                    for c in rows.T)
    olx, oly, olz = (x[:, None] for x in ol)
    dlx, dly, dlz = (x[:, None] for x in dl)
    pvx = dly * e2z - dlz * e2y
    pvy = dlz * e2x - dlx * e2z
    pvz = dlx * e2y - dly * e2x
    det = pvx * e1x + pvy * e1y + pvz * e1z
    inv = 1.0 / det
    tvx = olx - v0x
    tvy = oly - v0y
    tvz = olz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dlx * qvx + dly * qvy + dlz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= tmn[:, None]) & (t <= tmx[:, None]))
    return torch.where(ok, (t.view(torch.int32) & trunc) | pos[None, :],
                       INF_BITS)


def _sweep_packed(ol, dl, tmn, tmx, tri_tbl, trunc, block):
    """_mt_pairs over every row of tri_tbl, in blocks of lanes. Returns
    (L,) int32: the least packed word, INF_BITS where no row is hit."""
    n, f_pad = ol[0].shape[0], tri_tbl.shape[0]
    pos = torch.arange(f_pad, dtype=torch.int32, device=tri_tbl.device)
    out = torch.empty(n, dtype=torch.int32, device=tri_tbl.device)
    starts, step = _blocks(n, f_pad, block)
    for s in starts:
        out[s:s + step] = _mt_pairs(
            tuple(x[s:s + step] for x in ol), tuple(x[s:s + step] for x in dl),
            tmn[s:s + step], tmx[s:s + step], tri_tbl, trunc, pos).amin(1)
    return out


def face_guards(tri_tbl):
    """(F_pad, 3) float32 A = (e1 x e2) / (|e1| |e2|) per face, in the
    operations and order the kernels use when they stage a face; A = 0
    where |e1| |e2| < 2^-64 (a degenerate or padding row, never skipped).
    |d . A| / |d| is |cos| of the angle between the ray and the face's
    normal times the sine of the face's angle at v0: csrc/trimesh.cu's
    guard against rays that graze a face."""
    e1x, e1y, e1z, e2x, e2y, e2z = tri_tbl[:, 3:9].T
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    den = (torch.sqrt(e1x * e1x + e1y * e1y + e1z * e1z)
           * torch.sqrt(e2x * e2x + e2y * e2y + e2z * e2z))
    inv = torch.where(den >= 2.0 ** -64, 1.0 / den, 0.0)
    return torch.stack([nx * inv, ny * inv, nz * inv], dim=1)


def tri_segment_cull(rl):
    """The per-lane terms of the triangle-chunk cull, in the kernels'
    operations and order: (inv_dd, m_o, slope), each (L,), as
    intersect_kernels.segment_cull at TRI_CULL_SCALE but with the slope
    1.125 TRI_CULL_SCALE (+inf outside |d.d - 1| <= 2^-8): a triangle's t
    assumes no unit direction, so the quadratic's sqrt(|d.d - 1|) term
    does not arise."""
    ox, oy, oz, dx, dy, dz = rl[:6]
    dd = dx * dx + dy * dy + dz * dz
    o1 = ox.abs() + oy.abs() + oz.abs()
    dev = (dd - 1.0).abs()
    slope = torch.where(dev <= 2.0 ** -8, 1.125 * TRI_CULL_SCALE,
                        float("inf"))
    return 1.0 / dd, TRI_CULL_SCALE * o1, slope


def tri_cull_spheres(tri_bounds):
    """(4, C_pad) triangle-chunk spheres as the cull reads them (rows 0-3
    of tri_bounds): centre and R + TRI_CULL_SCALE (|C|_1 + R)."""
    bx, by, bz, br = tri_bounds[:4]
    return torch.stack([bx, by, bz, br + TRI_CULL_SCALE * (
        bx.abs() + by.abs() + bz.abs() + br)])


def _check_tri_bounds(tri_bounds, chunk, f_pad, device):
    """tri_bounds (TRI_BOUND_ROWS, >= F_pad / chunk) float32 for a valid
    chunk size."""
    chunk = check_tri_chunk(chunk)
    _check_table("tri_bounds", tri_bounds, TRI_BOUND_ROWS, device)
    if f_pad % chunk or tri_bounds.shape[1] < f_pad // chunk:
        raise ValueError(f"tri_bounds {tuple(tri_bounds.shape)} does not "
                         f"hold the chunks of {f_pad} rows at {chunk}")
    return chunk


def tri_sweep_walk(rl, tri_tbl, tri_bounds, chunk: int, trunc: int,
                   any_hit: bool = False, rm=None, best=None,
                   end_scale=None):
    """The face sweep of B6, B8, B9 and B10, lane by lane in the kernels'
    operations and order. rl (8, L): live lanes' rays in their candidate's
    object frame [ol dl tmn tmx]. The chunks go in table order; a chunk's
    covering sphere (a column of tri_bounds) is tested against the
    segment [tmn, t_end] with B1's half-line cull (t_end = tmx, or for the
    closest hit min(tmx, top(best)) once the lane holds a hit); every face
    of a chunk the lane meets is swept; of a chunk it misses, none where
    the chunk's guard cone gives c |dl . w| - s sqrt(dl.dl - (dl . w)^2) -
    h >= TRI_GUARD (rows 4-9 of tri_bounds), else the faces with |dl . A|
    < TRI_GUARD (face_guards). The any-hit sweep leaves at its first
    blocking face. Moeller-Trumbore tests rm (8, L), B9's ray with the
    direction scaled by 1/scale and the world segment, where given, else
    rl itself. The closest hit folds into `best` (L,) where given (B7's
    running world best) and with `end_scale` (B7's 1/scale) ends the
    segment at min(tmx, top(best) * end_scale), the best being in world
    units. Returns (res (L,) int32: the least packed word, or for
    any_hit the first blocking row; INF_BITS where none; met (L, C) bool:
    the chunks met among those tested; work (L, 5) int64: chunks tested,
    chunks met, cones tested, faces guard-tested, faces swept)."""
    n, f_pad = rl.shape[1], tri_tbl.shape[0]
    n_chunks = f_pad // chunk
    dev = rl.device
    dl, tmx = tuple(rl[3:6]), rl[7]
    mt = rl if rm is None else rm
    cull = tri_segment_cull(rl)
    spheres = tri_cull_spheres(tri_bounds)
    guards = face_guards(tri_tbl)
    dd = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]
    pos = torch.arange(f_pad, dtype=torch.int32, device=dev)
    res = (torch.full((n,), INF_BITS, dtype=torch.int32, device=dev)
           if best is None else best.clone())
    walking = torch.ones(n, dtype=torch.bool, device=dev)
    met = torch.zeros((n, n_chunks), dtype=torch.bool, device=dev)
    work = torch.zeros((n, 5), dtype=torch.int64, device=dev)
    upto = torch.arange(chunk, device=dev)
    for k in range(n_chunks):
        lo, hi = k * chunk, (k + 1) * chunk
        if any_hit:
            t_end = tmx
        elif end_scale is None:
            t_end = intersect_kernels.segment_end(tmx, res, trunc)
        else:
            top = ((res & trunc) | ~trunc).view(torch.float32)
            t_end = torch.where((res >= 0) & (res < INF_BITS),
                                torch.fmin(tmx, top * end_scale), tmx)
        met[:, k] = walking & ~intersect_kernels.segment_misses(
            rl, cull, spheres[:, k], t_end)
        wx, wy, wz, cos_q, sin_q, slack = tri_bounds[4:10, k]
        x = dl[0] * wx + dl[1] * wy + dl[2] * wz
        low = (cos_q * x.abs() - sin_q * torch.sqrt(torch.clamp(
            dd - x * x, min=0.0))) - slack
        coned = ~met[:, k] & (low >= TRI_GUARD)
        ax, ay, az = guards[lo:hi].T
        g = (dl[0][:, None] * ax + dl[1][:, None] * ay
             + dl[2][:, None] * az).abs()
        swept = (met[:, k, None] | ~(g >= TRI_GUARD)) & ~coned[:, None]
        packed = torch.where(swept, _mt_pairs(
            tuple(mt[0:3]), tuple(mt[3:6]), mt[6], mt[7], tri_tbl[lo:hi],
            trunc, pos[lo:hi]), INF_BITS)
        visited = walking[:, None].expand(n, chunk)
        if any_hit:
            hit = packed < INF_BITS
            first = torch.where(hit.any(1), hit.to(torch.uint8).argmax(1),
                                chunk)
            visited = visited & (upto[None, :] <= first[:, None])
            res = torch.where(walking & hit.any(1), lo + first, res)
        else:
            res = torch.minimum(res, packed.amin(1))
        work[:, 0] += walking
        work[:, 1] += met[:, k]
        work[:, 2] += walking & ~met[:, k]
        work[:, 3] += (visited & ~(met[:, k] | coned)[:, None]).sum(1)
        work[:, 4] += (visited & swept).sum(1)
        if any_hit:
            walking = walking & (res == INF_BITS)
    return res.to(torch.int32), met, work


def _to_object(rays, row):
    """Ray origins and directions in an instance's object frame. rays: the
    eight (L,) rows; row: the instance's nine entries, scalars or (L,)
    tensors. Returns (ol, dl, inv_s): positions scaled by 1/scale, the
    direction rotated only."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    px, py, pz, qx, qy, qz, qw, inv_s = row[:8]
    olx, oly, olz = _conj_rotate(qx, qy, qz, qw, ox - px, oy - py, oz - pz)
    ol = (olx * inv_s, oly * inv_s, olz * inv_s)
    return ol, _conj_rotate(qx, qy, qz, qw, dx, dy, dz), inv_s


# ----------------------------------------------------------------------------
# B5: the bound scan


def scan_keys(rays, rows, pos, trunc, cursor):
    """B5's test of each ray x bound-scan row, in the kernel's operations
    and order. rays (8, L); rows (R, 4) of make_bscan_table; pos (R,)
    int32 their table positions; cursor (L,). Returns (key (L, R) int32:
    the packed key where the row's [entry, exit] overlaps [tmin, tmax] on
    a live lane and the key is greater than the cursor, else INF_BITS;
    root (L, R) bool: the discriminant is not negative, the rows for which
    the kernel takes the root)."""
    cx, cy, cz, ccrr = (c[None, :] for c in rows.T)
    ox, oy, oz, dx, dy, dz, tmin, tmax = (r[:, None] for r in rays)
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    b = od - (cx * dx + cy * dy + cz * dz)
    c0 = oo - 2.0 * (cx * ox + cy * oy + cz * oz) + ccrr
    disc = b * b - c0
    sq = torch.sqrt(disc)                      # NaN when the ray misses
    entry = -b - sq
    exit_t = sq - b
    ok = (exit_t >= tmin) & (entry <= tmax) & (tmax >= tmin)
    ce = torch.where(entry > 0.0, entry, 0.0)
    key = (ce.view(torch.int32) & trunc) | pos[None, :]
    return (torch.where(ok & (key > cursor[:, None]), key, INF_BITS),
            ~(disc < 0))


def bound_scan_plain(rays, bscan_tbl, cursor, inst_bounds=None,
                     m_tbl: int = None, block: int = 16384):
    """Plain PyTorch B5. rays (8, N) [ox oy oz dx dy dz tmin tmax], tmin
    >= 0, unit directions; bscan_tbl (M_pad, 4) from make_bscan_table;
    cursor (N,) int32, -1 to start. Returns key (N,) int32: the least
    packed key (bits of max(entry t, 0) with the low pos_bits(M_pad) bits
    replaced by the table position) greater than the cursor, over the
    bounding spheres whose [entry, exit] overlaps [tmin, tmax]; INF_BITS
    where none is left, and on dead lanes (tmax < tmin). ``inst_bounds``
    and ``m_tbl`` are ignored: the kernel's culls do not change the
    result, which this computes from the whole table."""
    n, m_pad = rays.shape[1], bscan_tbl.shape[0]
    trunc = ~((1 << pos_bits(m_pad)) - 1)
    pos = torch.arange(m_pad, dtype=torch.int32, device=rays.device)
    out = torch.empty(n, dtype=torch.int32, device=rays.device)
    starts, step = _blocks(n, m_pad, block)
    for s in starts:
        out[s:s + step] = scan_keys(rays[:, s:s + step], bscan_tbl, pos,
                                    trunc, cursor[s:s + step])[0].amin(1)
    return out


def bound_scan_walk(rays, bscan_tbl, cursor, inst_bounds, m_tbl: int):
    """B5's kernel walk, lane by lane in its operations and order: the
    chunks of INST_CHUNK rows below m_tbl in table order, each chunk's
    covering sphere (a column of inst_bounds) tested against the ray's
    segment [tmin, t_end] (t_end = tmax, then min(tmax, top(best)) once
    the lane holds a key; csrc/trimesh.cu and csrc/rays.cuh state
    the cull and its margin), and a met chunk's rows folded into the
    least key. Returns (met (N, n_chunks) bool, key (N,) int32, roots
    (N,) int64: the swept rows whose discriminant is not negative). Dead
    lanes meet nothing."""
    n, m_pad = rays.shape[1], bscan_tbl.shape[0]
    n_chunks = _check_scan_bounds(inst_bounds, m_tbl, m_pad)
    trunc = ~((1 << pos_bits(m_pad)) - 1)
    live = rays[7] >= rays[6]
    cull = intersect_kernels.segment_cull(rays)
    spheres = intersect_kernels.cull_spheres(inst_bounds)
    pos = torch.arange(m_pad, dtype=torch.int32, device=rays.device)
    best = torch.full((n,), INF_BITS, dtype=torch.int32, device=rays.device)
    met = torch.zeros((n, n_chunks), dtype=torch.bool, device=rays.device)
    roots = torch.zeros(n, dtype=torch.int64, device=rays.device)
    for k in range(n_chunks):
        t_end = intersect_kernels.segment_end(rays[7], best, trunc)
        met[:, k] = live & ~intersect_kernels.segment_misses(
            rays, cull, spheres[:, k], t_end)
        lo, hi = k * INST_CHUNK, min((k + 1) * INST_CHUNK, m_tbl)
        key, root = scan_keys(rays, bscan_tbl[lo:hi], pos[lo:hi], trunc,
                              cursor)
        best = torch.where(met[:, k], torch.minimum(best, key.amin(1)),
                           best)
        roots += root.sum(1) * met[:, k]
    return met, best, roots


def bound_scan_work(rays, bscan_tbl, cursor, inst_bounds, m_tbl: int,
                    block: int = 16384):
    """The work B5's kernel needs on these rays, in its visit order (see
    bound_scan_walk): per ray, (chunk tests, chunks met, rows swept, roots
    taken), each int64 (N,). A live ray tests every chunk, sweeps the rows
    below m_tbl of each chunk it meets and takes the root of each swept
    row whose discriminant is not negative; dead lanes do nothing."""
    n = rays.shape[1]
    n_chunks = _check_scan_bounds(inst_bounds, m_tbl, bscan_tbl.shape[0])
    rows = torch.clamp(m_tbl - INST_CHUNK * torch.arange(
        n_chunks, device=rays.device), max=INST_CHUNK)
    out = [torch.zeros(n, dtype=torch.int64, device=rays.device)
           for _ in range(4)]
    starts, step = _blocks(n, INST_CHUNK, block)
    for s in starts:
        r = rays[:, s:s + step]
        met, _, roots = bound_scan_walk(r, bscan_tbl, cursor[s:s + step],
                                        inst_bounds, m_tbl)
        out[0][s:s + step] = torch.where(r[7] >= r[6], n_chunks, 0)
        out[1][s:s + step] = met.sum(1)
        out[2][s:s + step] = met.mul(rows).sum(1)
        out[3][s:s + step] = roots
    return tuple(out)


def _check_scan_bounds(inst_bounds, m_tbl, m_pad):
    """B5's chunk spheres: (4, >= ceil(m_tbl / INST_CHUNK)) for 1 <= m_tbl
    <= m_pad. Returns the chunk count."""
    n_chunks = -(-m_tbl // INST_CHUNK)
    if not 1 <= m_tbl <= m_pad:
        raise ValueError(f"m_tbl = {m_tbl} outside [1, {m_pad}]")
    if inst_bounds.dim() != 2 or inst_bounds.shape[0] != 4 \
            or inst_bounds.shape[1] < n_chunks:
        raise ValueError(f"inst_bounds {tuple(inst_bounds.shape)} does not "
                         f"hold the {n_chunks} chunks of {m_tbl} rows")
    return n_chunks


def bound_scan(rays, bscan_tbl, cursor, inst_bounds, m_tbl: int,
               block: int = 16384):
    """B5; see bound_scan_plain for the contract. inst_bounds (4, IC_pad)
    holds the covering spheres of the instance table's chunks
    (make_inst_tables) and m_tbl its width: the rows of bscan_tbl below
    m_tbl are its columns, in chunks of INST_CHUNK, and the rest is
    padding. The kernel culls chunks by them per lane. A CUDA tensor
    launches drts_bound_scan (csrc/trimesh.cu)."""
    _check_rays(rays)
    n = rays.shape[1]
    _check_table("bscan_tbl", bscan_tbl, 4, rays.device, rows_first=False)
    _check_words("cursor", cursor, n, rays.device)
    _check_table("inst_bounds", inst_bounds, 4, rays.device)
    m_pad = bscan_tbl.shape[0]
    _check_scan_bounds(inst_bounds, m_tbl, m_pad)
    if rays.device.type == "cpu":
        return bound_scan_plain(rays, bscan_tbl, cursor, inst_bounds, m_tbl,
                                block)
    lib = backend.kernels()
    key = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_bound_scan(rays.data_ptr(), n, cursor.data_ptr(),
                             bscan_tbl.data_ptr(), m_tbl,
                             inst_bounds.data_ptr(), inst_bounds.shape[1],
                             INST_CHUNK, intersect_kernels.CULL_SCALE,
                             pos_bits(m_pad), key.data_ptr(),
                             backend.stream_handle(rays))
    backend.check_launch(rc, "drts_bound_scan")
    backend.launched("bound_scan")
    return key


# ----------------------------------------------------------------------------
# B6: the shared-BLAS sweep of each ray's candidate instance


def shared_blas_sweep_plain(rays, cand, best, binst, inst_tbl, tri_tbl,
                            tri_bounds=None, chunk: int = None,
                            block: int = 16384):
    """Plain PyTorch B6. rays (8, N); cand (N,) int32 table position of
    the ray's candidate instance (outside [0, M) = none); best (N,) int32
    packed (world t bits | face row) so far, INF_BITS = none; binst (N,)
    int32 its instance position; inst_tbl (9, M); tri_tbl (F_pad, 9).

    A lane is live when min(tmax, best t) >= tmin and it has a candidate.
    It sweeps the triangle table in the candidate's object frame with the
    direction rotated but not scaled, so t is in object units; the least
    packed word is rescaled (t * scale) and repacked, and replaces the
    best where it is smaller. Returns the new (best, binst).
    ``tri_bounds`` and ``chunk`` are ignored: the kernel's culls do not
    change the result, which this computes from every face."""
    f_pad, m_tbl = tri_tbl.shape[0], inst_tbl.shape[1]
    trunc = ~((1 << pos_bits(f_pad)) - 1)
    tmin, tmax = rays[6], rays[7]
    tmax_eff = torch.minimum(tmax, (best & trunc).view(torch.float32))
    live = (tmax_eff >= tmin) & (cand >= 0) & (cand < m_tbl)
    best_out, binst_out = best.clone(), binst.clone()
    idx = torch.nonzero(live)[:, 0]
    if idx.numel() == 0:
        return best_out, binst_out
    k = cand[idx]
    row = inst_tbl[:, k.long()]
    ol, dl, inv_s = _to_object(rays[:, idx], row)
    best_obj = _sweep_packed(ol, dl, tmin[idx] * inv_s,
                             tmax_eff[idx] * inv_s, tri_tbl, trunc, block)
    t_w = (best_obj & trunc).view(torch.float32) * (1.0 / inv_s)
    packed_w = (t_w.view(torch.int32) & trunc) | (best_obj & ~trunc)
    better = (best_obj < INF_BITS) & (packed_w < best[idx])
    best_out[idx] = torch.where(better, packed_w, best[idx])
    binst_out[idx] = torch.where(better, k, binst[idx])
    return best_out, binst_out


def _culled_sweep(rays, idx, cand, best, binst, tmax_eff, inst_tbl,
                  tri_tbl, tri_bounds, chunk: int):
    """B6's fold with the culled sweep (tri_sweep_walk, closest hit) of the
    lanes idx on [tmin, tmax_eff] in their candidate's frame: the packed
    object best rescaled to world units replaces the lane's best where
    smaller, as shared_blas_sweep_plain folds. Returns (best, binst) for
    all lanes, and the walk's met and work for the lanes idx."""
    trunc = ~((1 << pos_bits(tri_tbl.shape[0])) - 1)
    k = cand[idx]
    ol, dl, inv_s = _to_object(rays[:, idx], inst_tbl[:, k.long()])
    rl = torch.stack([*ol, *dl, rays[6, idx] * inv_s, tmax_eff[idx] * inv_s])
    best_obj, met, work = tri_sweep_walk(rl, tri_tbl, tri_bounds, chunk,
                                         trunc)
    t_w = (best_obj & trunc).view(torch.float32) * (1.0 / inv_s)
    packed_w = (t_w.view(torch.int32) & trunc) | (best_obj & ~trunc)
    better = (best_obj < INF_BITS) & (packed_w < best[idx])
    best, binst = best.clone(), binst.clone()
    best[idx] = torch.where(better, packed_w, best[idx])
    binst[idx] = torch.where(better, k.to(torch.int32), binst[idx])
    return best, binst, met, work


def shared_blas_sweep_work(rays, cand, best, binst, inst_tbl, tri_tbl,
                           tri_bounds, chunk: int, block: int = 65536):
    """The work B6's kernel needs on these rays: its culled walk
    (_culled_sweep, tri_sweep_walk's closest hit, in blocks of lanes).
    Returns ((best, binst) folded from the walk, which must equal
    shared_blas_sweep_plain's, a dict of sums: live, tests, met, cones,
    guards, rows)."""
    f_pad, m_tbl = tri_tbl.shape[0], inst_tbl.shape[1]
    chunk = _check_tri_bounds(tri_bounds, chunk, f_pad, rays.device)
    trunc = ~((1 << pos_bits(f_pad)) - 1)
    names = ("tests", "met", "cones", "guards", "rows")
    out = dict.fromkeys(("live", *names), 0)
    tmax_eff = torch.minimum(rays[7], (best & trunc).view(torch.float32))
    live = (tmax_eff >= rays[6]) & (cand >= 0) & (cand < m_tbl)
    idx_all = torch.nonzero(live)[:, 0]
    for s in range(0, idx_all.numel(), block):
        idx = idx_all[s:s + block]
        best, binst, _, work = _culled_sweep(rays, idx, cand, best, binst,
                                             tmax_eff, inst_tbl, tri_tbl,
                                             tri_bounds, chunk)
        out["live"] += idx.numel()
        for j, name in enumerate(names):
            out[name] += int(work[:, j].sum())
    return (best, binst), out


def shared_blas_sweep(rays, cand, best, binst, inst_tbl, tri_tbl,
                      tri_bounds, chunk: int, block: int = 16384):
    """B6; see shared_blas_sweep_plain for the contract. tri_bounds
    (TRI_BOUND_ROWS, C_pad) holds the covering spheres and guard cones of
    the triangle table's chunks of `chunk` rows (tri_chunk_bounds); the
    kernel culls chunks and faces by them per lane, as B8 does
    (shared_blas_sweep_work walks and counts it). A CUDA tensor launches
    drts_shared_blas_sweep (csrc/trimesh.cu)."""
    _check_rays(rays)
    n = rays.shape[1]
    for name, x in (("cand", cand), ("best", best), ("binst", binst)):
        _check_words(name, x, n, rays.device)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    f_pad = tri_tbl.shape[0]
    chunk = _check_tri_bounds(tri_bounds, chunk, f_pad, rays.device)
    if rays.device.type == "cpu":
        return shared_blas_sweep_plain(rays, cand, best, binst, inst_tbl,
                                       tri_tbl, tri_bounds, chunk, block)
    lib = backend.kernels()
    best_out = torch.empty_like(best)
    binst_out = torch.empty_like(binst)
    rc = lib.drts_shared_blas_sweep(
        rays.data_ptr(), n, cand.data_ptr(), best.data_ptr(),
        binst.data_ptr(), inst_tbl.data_ptr(), inst_tbl.shape[1],
        tri_tbl.data_ptr(), f_pad, pos_bits(f_pad), tri_bounds.data_ptr(),
        tri_bounds.shape[1], chunk, TRI_CULL_SCALE, TRI_GUARD,
        best_out.data_ptr(), binst_out.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_shared_blas_sweep")
    backend.launched("shared_blas_sweep")
    return best_out, binst_out


# ----------------------------------------------------------------------------
# B7: the serial walk over every instance


def _reaches(rays, sphere, far):
    """B7's per-ray sphere test: does the segment [tmin, far] of each ray
    (eight (L,) rows, unit direction) meet the sphere (cx, cy, cz, r),
    grown by the slack? r <= 0 (padding) never passes; a ray that misses
    has a NaN half-chord, which fails both compares."""
    ox, oy, oz, dx, dy, dz, tmin = rays[:7]
    cx, cy, cz, r = sphere
    vx, vy, vz = cx - ox, cy - oy, cz - oz
    b = vx * dx + vy * dy + vz * dz
    wx, wy, wz = vx - b * dx, vy - b * dy, vz - b * dz
    rs = r * BOUND_SCALE + BOUND_PAD
    h = torch.sqrt(rs * rs - (wx * wx + wy * wy + wz * wz))
    return (r > 0.0) & (b + h >= tmin) & (b - h <= far)


def _serial_closest(rays, inst_tbl, inst_bounds, n_ichunks: int, trunc: int,
                    sweep):
    """B7's walk over the instances, shared by its plain version and its
    culled walk. The live lanes are compacted, then the instances are
    visited in table order as the kernel visits them: a chunk, then an
    instance, is entered by the lanes whose segment up to their running
    best meets its sphere (_reaches), and only those (ray, instance) pairs
    are swept. sweep(rk, row, best) sweeps instance `row` (a column of
    inst_tbl) for the entering lanes' rays rk (8, L) and packed world
    bests (L,) and returns their least packed words (L,) int32, INF_BITS
    where none, and (L, W) int64 work or None; the instance recorded is the
    first at which a lane's best strictly improved. Returns (packed (N,)
    int32, inst (N,) int32, counts: live lanes, chunk_tests, inst_tests
    (sphere tests made) and sweeps ((ray, instance) pairs swept), work
    (N, W) summed over each lane's sweeps, or None)."""
    n = rays.shape[1]
    if inst_tbl.shape[1] != n_ichunks * INST_CHUNK:
        raise ValueError(f"inst_tbl has {inst_tbl.shape[1]} columns, "
                         f"expected {n_ichunks} x {INST_CHUNK}")
    packed = torch.full((n,), INF_BITS, dtype=torch.int32,
                        device=rays.device)
    inst = torch.zeros(n, dtype=torch.int32, device=rays.device)
    live = torch.nonzero(rays[7] >= rays[6])[:, 0]
    counts = {"live": live.numel(), "chunk_tests": 0, "inst_tests": 0,
              "sweeps": 0}
    work = None
    if live.numel():
        r = rays[:, live]
        best = packed[live]
        binst = inst[live]

        def far_of(sel):
            return torch.minimum(r[7, sel],
                                 (best[sel] & trunc).view(torch.float32))

        everyone = torch.arange(live.numel(), device=rays.device)
        for ic in range(n_ichunks):
            in_chunk = everyone[_reaches(r, inst_bounds[:, ic],
                                         far_of(everyone))]
            counts["chunk_tests"] += live.numel()
            if in_chunk.numel() == 0:
                continue
            counts["inst_tests"] += in_chunk.numel() * INST_CHUNK
            for k in range(ic * INST_CHUNK, (ic + 1) * INST_CHUNK):
                row = inst_tbl[:, k]
                rc = r[:, in_chunk]
                sel = in_chunk[_reaches(rc, (row[0], row[1], row[2], row[8]),
                                        far_of(in_chunk))]
                if sel.numel() == 0:
                    continue
                counts["sweeps"] += sel.numel()
                hit, w = sweep(r[:, sel], row, best[sel])
                better = hit < best[sel]
                binst[sel] = torch.where(better, k, binst[sel])
                best[sel] = torch.where(better, hit, best[sel])
                if w is not None:
                    if work is None:
                        work = torch.zeros((n, w.shape[1]), dtype=torch.int64,
                                           device=rays.device)
                    work[live[sel]] += w
        packed[live] = best
        inst[live] = binst
    return packed, inst, counts, work


def intersect_mesh_instances_plain(rays, inst_tbl, inst_bounds, tri_tbl,
                                   n_ichunks: int, tri_bounds=None,
                                   chunk: int = None, block: int = 16384,
                                   work: dict = None):
    """Plain PyTorch B7. rays (8, N), unit directions; inst_tbl (9, M)
    with M = n_ichunks * INST_CHUNK; inst_bounds (4, IC_pad) chunk
    spheres; tri_tbl (F_pad, 9). Per ray, the closest hit over every
    instance and face, the direction scaled by 1/scale so t stays in world
    units. Returns (t (N,) float32 truncated down to the packed precision,
    inf on miss; face (N,) int32 table row; inst (N,) int32 table
    position: the first, in table order, at which the packed best
    improved).

    The walk over the instances is _serial_closest's; an entered
    instance's faces are all swept. ``tri_bounds`` and ``chunk`` are
    ignored (None will do): the kernel's culls do not change the result.
    `work`, when given, receives the counts of this call: live lanes,
    chunk_tests, inst_tests (sphere tests made) and sweeps ((ray,
    instance) pairs swept over the triangle table)."""
    trunc = ~((1 << pos_bits(tri_tbl.shape[0])) - 1)

    def sweep(rk, row, _best):
        ol, dl, inv_s = _to_object(rk, row)
        return _sweep_packed(ol, tuple(x * inv_s for x in dl), rk[6], rk[7],
                             tri_tbl, trunc, block), None

    packed, inst, counts, _ = _serial_closest(rays, inst_tbl, inst_bounds,
                                              n_ichunks, trunc, sweep)
    if work is not None:
        work.update(counts)
    return (packed & trunc).view(torch.float32), packed & ~trunc, inst


def intersect_mesh_instances_walk(rays, inst_tbl, inst_bounds, tri_tbl,
                                  tri_bounds, chunk: int, n_ichunks: int):
    """B7's kernel walk, lane by lane in its operations and order: the
    plain version's walk over the instances (_serial_closest), and for
    each instance entered the culled sweep (tri_sweep_walk, closest hit)
    in B8's frame (direction rotated only, [tmin, tmax] scaled by 1/scale),
    with Moeller-Trumbore on the plain version's own ray (direction also
    scaled by 1/scale, the world segment) folding into the lane's running
    world best, whose top times 1/scale ends the cull's segment
    (csrc/trimesh.cu extends the cull's argument to it). Returns ((t, face,
    inst) as the plain version's, counts as the plain version's, work
    (N, 5) int64: triangle chunks tested, chunks met, cones tested, faces
    guard-tested, faces swept, over the lane's sweeps)."""
    f_pad = tri_tbl.shape[0]
    chunk = _check_tri_bounds(tri_bounds, chunk, f_pad, rays.device)
    trunc = ~((1 << pos_bits(f_pad)) - 1)

    def sweep(rk, row, best):
        ol, dl, inv_s = _to_object(rk, row)
        rl = torch.stack([*ol, *dl, rk[6] * inv_s, rk[7] * inv_s])
        rm = torch.stack([*ol, *(x * inv_s for x in dl), rk[6], rk[7]])
        res, _, w = tri_sweep_walk(rl, tri_tbl, tri_bounds, chunk, trunc,
                                   rm=rm, best=best, end_scale=inv_s)
        return res, w

    packed, inst, counts, work = _serial_closest(rays, inst_tbl, inst_bounds,
                                                 n_ichunks, trunc, sweep)
    if work is None:
        work = torch.zeros((rays.shape[1], 5), dtype=torch.int64,
                           device=rays.device)
    return ((packed & trunc).view(torch.float32), packed & ~trunc, inst), \
        counts, work


def intersect_mesh_instances_work(rays, inst_tbl, inst_bounds, tri_tbl,
                                  tri_bounds, chunk: int, n_ichunks: int,
                                  block: int = 262144):
    """The work B7's kernel needs on these rays
    (intersect_mesh_instances_walk, in blocks of lanes). Returns (the
    walk's (t, face, inst), a dict of sums: the walk's counts (live,
    chunk_tests, inst_tests, sweeps), its tests (triangle chunks tested),
    met, cones, guards and rows (faces swept), and tri_tests: the faces the
    unculled sweeps visit, sweeps x F_pad)."""
    names = ("tests", "met", "cones", "guards", "rows")
    out = dict.fromkeys(("live", "chunk_tests", "inst_tests", "sweeps",
                         "tri_tests", *names), 0)
    n = rays.shape[1]
    res = (torch.empty(n, dtype=torch.float32, device=rays.device),
           torch.empty(n, dtype=torch.int32, device=rays.device),
           torch.empty(n, dtype=torch.int32, device=rays.device))
    for s in range(0, n, block):
        words, counts, work = intersect_mesh_instances_walk(
            rays[:, s:s + block], inst_tbl, inst_bounds, tri_tbl, tri_bounds,
            chunk, n_ichunks)
        for whole, part in zip(res, words):
            whole[s:s + block] = part
        for name, count in counts.items():
            out[name] += count
        for j, name in enumerate(names):
            out[name] += int(work[:, j].sum())
    out["tri_tests"] = out["sweeps"] * tri_tbl.shape[0]
    return res, out


def intersect_mesh_instances(rays, inst_tbl, inst_bounds, tri_tbl,
                             n_ichunks: int, tri_bounds=None,
                             chunk: int = None, block: int = 16384):
    """B7; see intersect_mesh_instances_plain for the contract. tri_bounds
    (TRI_BOUND_ROWS, C_pad) holds the covering spheres and guard cones of
    the triangle table's chunks of `chunk` rows (tri_chunk_bounds), by
    which the kernel culls each instance's sweep per lane
    (intersect_mesh_instances_walk); the CPU path may leave both None. A
    CUDA tensor launches drts_mesh_instances_closest (csrc/trimesh.cu),
    which stages the faces of a table of up to FACE_TILE rows in each
    block's shared memory (a wider one once per launch into scratch
    memory) and lets blocks and warps with no live lane leave at once."""
    _check_rays(rays)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("inst_bounds", inst_bounds, 4, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    f_pad = tri_tbl.shape[0]
    if rays.device.type == "cpu":
        return intersect_mesh_instances_plain(rays, inst_tbl, inst_bounds,
                                              tri_tbl, n_ichunks, tri_bounds,
                                              chunk, block)
    if tri_bounds is None or chunk is None:
        raise ValueError("B7's kernel culls by the triangle table's chunk "
                         "bounds: pass tri_bounds and chunk")
    chunk = _check_tri_bounds(tri_bounds, chunk, f_pad, rays.device)
    if (inst_tbl.shape[1] != n_ichunks * INST_CHUNK
            or inst_bounds.shape[1] < n_ichunks):
        raise ValueError(f"inst_tbl {tuple(inst_tbl.shape)} and inst_bounds "
                         f"{tuple(inst_bounds.shape)} do not hold "
                         f"{n_ichunks} chunks of {INST_CHUNK}")
    lib = backend.kernels()
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    face = torch.empty(n, dtype=torch.int32, device=rays.device)
    inst = torch.empty(n, dtype=torch.int32, device=rays.device)
    image = None
    if f_pad > FACE_TILE:
        image = torch.empty((3 * (f_pad + f_pad // chunk), 4),
                            dtype=torch.float32, device=rays.device)
    rc = lib.drts_mesh_instances_closest(
        rays.data_ptr(), n, inst_tbl.data_ptr(), inst_tbl.shape[1],
        inst_bounds.data_ptr(), inst_bounds.shape[1], n_ichunks, INST_CHUNK,
        BOUND_SCALE, BOUND_PAD, tri_tbl.data_ptr(), f_pad, pos_bits(f_pad),
        tri_bounds.data_ptr(), tri_bounds.shape[1], chunk, TRI_CULL_SCALE,
        TRI_GUARD, None if image is None else image.data_ptr(),
        t.data_ptr(), face.data_ptr(), inst.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_mesh_instances_closest")
    backend.launched("intersect_mesh_instances")
    return t, face, inst


# ----------------------------------------------------------------------------
# B8: does each ray's candidate instance block it?


def shared_blas_any_plain(rays, cand, occ_in, inst_tbl, tri_tbl,
                          tri_bounds=None, chunk: int = None,
                          block: int = 16384, work: dict = None):
    """Plain PyTorch B8. rays (8, N); cand (N,) int32 table position of the
    ray's candidate instance (outside [0, M) = none); occ_in (N,) int32
    blocked bit so far; inst_tbl (9, M); tri_tbl (F_pad, 9).

    A lane is live when tmax >= tmin, it has a candidate and occ_in is 0;
    every other lane returns occ_in. A live lane sweeps the triangle table
    in the candidate's object frame with the direction rotated but not
    scaled, so tmin and tmax are scaled into object units; it returns 1
    where some triangle's hit lies in that range. Returns occ (N,) int32.
    ``tri_bounds`` and ``chunk`` are ignored: the kernel's culls do not
    change the result, which this computes from every face. `work`, when
    given, receives the counts of this call: live lanes and tri_tests, the
    (ray, triangle) pairs up to each lane's first blocking row (all rows
    where none blocks) of this unculled sweep."""
    f_pad, m_tbl = tri_tbl.shape[0], inst_tbl.shape[1]
    tmin, tmax = rays[6], rays[7]
    live = (tmax >= tmin) & (cand >= 0) & (cand < m_tbl) & (occ_in == 0)
    occ = occ_in.clone()
    idx = torch.nonzero(live)[:, 0]
    counts = {"live": idx.numel(), "tri_tests": 0}
    if idx.numel():
        row = inst_tbl[:, cand[idx].long()]
        ol, dl, inv_s = _to_object(rays[:, idx], row)
        # trunc = 0 packs the row alone: the least word is the first row
        # that blocks.
        first = _sweep_packed(ol, dl, tmin[idx] * inv_s, tmax[idx] * inv_s,
                              tri_tbl, 0, block)
        hit = first < INF_BITS
        occ[idx] = hit.to(torch.int32)
        counts["tri_tests"] = int(torch.where(hit, first + 1, f_pad).sum())
    if work is not None:
        work.update(counts)
    return occ


def _anyhit_lanes(rays, cand, occ_in, inst_tbl):
    """B8's live lanes (N,) bool and their rays in the candidate's object
    frame (8, L) [ol dl tmin/s tmax/s]."""
    m_tbl = inst_tbl.shape[1]
    live = ((rays[7] >= rays[6]) & (cand >= 0) & (cand < m_tbl)
            & (occ_in == 0))
    idx = torch.nonzero(live)[:, 0]
    ol, dl, inv_s = _to_object(rays[:, idx], inst_tbl[:, cand[idx].long()])
    return live, torch.stack([*ol, *dl, rays[6, idx] * inv_s,
                              rays[7, idx] * inv_s])


def shared_blas_any_walk(rays, cand, occ_in, inst_tbl, tri_tbl, tri_bounds,
                         chunk: int):
    """B8's kernel walk (tri_sweep_walk, any hit) lane by lane. Returns (occ
    (N,) int32, met (N, C) bool: the triangle chunks each lane met, work
    (N, 5) int64: chunks tested, chunks met, cones tested, faces
    guard-tested, faces swept; zero on the lanes that do not sweep)."""
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    chunk = _check_tri_bounds(tri_bounds, chunk, f_pad, rays.device)
    live, rl = _anyhit_lanes(rays, cand, occ_in, inst_tbl)
    first, met_l, work_l = tri_sweep_walk(rl, tri_tbl, tri_bounds, chunk, 0,
                                          any_hit=True)
    occ = occ_in.clone()
    occ[live] = (first < INF_BITS).to(torch.int32)
    met = torch.zeros((n, f_pad // chunk), dtype=torch.bool,
                      device=rays.device)
    met[live] = met_l
    work = torch.zeros((n, 5), dtype=torch.int64, device=rays.device)
    work[live] = work_l
    return occ, met, work


def warp_sum(met):
    """Chunks that some lane of a warp (32 consecutive lanes) meets, summed
    over the warps: a warp sweeps a chunk while any of its lanes meets it.
    met (N, C) bool."""
    n = met.shape[0]
    pad = torch.zeros((-n % 32, met.shape[1]), dtype=torch.bool,
                      device=met.device)
    return int(torch.cat([met, pad]).reshape(-1, 32, met.shape[1])
               .any(1).sum())


def shared_blas_any_work(rays, cand, occ_in, inst_tbl, tri_tbl, tri_bounds,
                         chunk: int, block: int = 65536):
    """The work B8's kernel needs on these rays (shared_blas_any_walk, in
    blocks of lanes). Returns (the walk's occ (N,), a dict of sums over
    the lanes: live (lanes that sweep), tests (chunks tested), met (chunks
    met), cones (cones tested), guards (faces guard-tested), rows (faces
    swept), warp_met (chunks met per warp, see warp_sum), warps (warps
    with a live lane), and faces (the faces an unculled sweep visits: up
    to the first blocking row, all where none blocks, as
    shared_blas_any_plain counts them))."""
    names = ("tests", "met", "cones", "guards", "rows")
    out = dict.fromkeys(("live", *names, "warp_met", "warps", "faces"), 0)
    occ = torch.empty_like(occ_in)
    block = max(32, block // 32 * 32)
    for s in range(0, rays.shape[1], block):
        e = slice(s, s + block)
        args = (rays[:, e], cand[e], occ_in[e], inst_tbl)
        occ[e], met, work = shared_blas_any_walk(*args, tri_tbl, tri_bounds,
                                                 chunk)
        live = _anyhit_lanes(*args)[0]
        plain = {}
        shared_blas_any_plain(*args, tri_tbl, work=plain)
        out["faces"] += plain["tri_tests"]
        out["live"] += int(live.sum())
        for j, name in enumerate(names):
            out[name] += int(work[:, j].sum())
        out["warp_met"] += warp_sum(met)
        out["warps"] += warp_sum(live[:, None])
    return occ, out


def shared_blas_any(rays, cand, occ_in, inst_tbl, tri_tbl, tri_bounds,
                    chunk: int, block: int = 16384):
    """B8; see shared_blas_any_plain for the contract. tri_bounds
    (TRI_BOUND_ROWS, C_pad) holds the covering spheres and guard cones of
    the triangle table's chunks of
    `chunk` rows (tri_chunk_bounds); the kernel culls chunks and faces by
    them per lane (tri_sweep_walk). A CUDA tensor launches
    drts_shared_blas_any (csrc/trimesh.cu)."""
    _check_rays(rays)
    n = rays.shape[1]
    _check_words("cand", cand, n, rays.device)
    _check_words("occ_in", occ_in, n, rays.device)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    chunk = _check_tri_bounds(tri_bounds, chunk, tri_tbl.shape[0],
                              rays.device)
    if rays.device.type == "cpu":
        return shared_blas_any_plain(rays, cand, occ_in, inst_tbl, tri_tbl,
                                     tri_bounds, chunk, block)
    lib = backend.kernels()
    occ = torch.empty_like(occ_in)
    rc = lib.drts_shared_blas_any(
        rays.data_ptr(), n, cand.data_ptr(), occ_in.data_ptr(),
        inst_tbl.data_ptr(), inst_tbl.shape[1], tri_tbl.data_ptr(),
        tri_tbl.shape[0], tri_bounds.data_ptr(), tri_bounds.shape[1], chunk,
        TRI_CULL_SCALE, TRI_GUARD, occ.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_shared_blas_any")
    backend.launched("shared_blas_any")
    return occ


# ----------------------------------------------------------------------------
# B9: the serial any-hit walk over every instance


def _serial_anyhit(rays, inst_tbl, inst_bounds, n_ichunks: int, sweep):
    """B9's walk over the instances, shared by its plain version and its
    culled walk. The live lanes are compacted and walk the instances in
    table order; a chunk, then an instance, is entered by the lanes not yet
    blocked whose segment [tmin, tmax] meets its sphere (_reaches), and a
    blocked lane leaves the walk. sweep(rk, row) sweeps instance `row` (a
    column of inst_tbl) for the entering lanes' rays rk (8, L) and returns
    their first blocking rows (L,) int32, INF_BITS where none, and (L, W)
    int64 work. Returns (occ (N,) int32, counts: live lanes, chunk_tests,
    inst_tests (sphere tests made) and sweeps ((ray, instance) pairs
    entered), work (N, W) summed over each lane's sweeps)."""
    n = rays.shape[1]
    if inst_tbl.shape[1] != n_ichunks * INST_CHUNK:
        raise ValueError(f"inst_tbl has {inst_tbl.shape[1]} columns, "
                         f"expected {n_ichunks} x {INST_CHUNK}")
    occ = torch.zeros(n, dtype=torch.int32, device=rays.device)
    live = torch.nonzero(rays[7] >= rays[6])[:, 0]
    counts = {"live": live.numel(), "chunk_tests": 0, "inst_tests": 0,
              "sweeps": 0}
    work = None
    if live.numel():
        r = rays[:, live]
        blocked = torch.zeros(live.numel(), dtype=torch.bool,
                              device=rays.device)
        for ic in range(n_ichunks):
            walking = torch.nonzero(~blocked)[:, 0]
            if walking.numel() == 0:
                break
            rw = r[:, walking]
            in_chunk = walking[_reaches(rw, inst_bounds[:, ic], rw[7])]
            counts["chunk_tests"] += walking.numel()
            for k in range(ic * INST_CHUNK, (ic + 1) * INST_CHUNK):
                in_chunk = in_chunk[~blocked[in_chunk]]
                if in_chunk.numel() == 0:
                    break
                counts["inst_tests"] += in_chunk.numel()
                row = inst_tbl[:, k]
                rc = r[:, in_chunk]
                sel = in_chunk[_reaches(rc, (row[0], row[1], row[2], row[8]),
                                        rc[7])]
                if sel.numel() == 0:
                    continue
                counts["sweeps"] += sel.numel()
                first, w = sweep(r[:, sel], row)
                blocked[sel] = first < INF_BITS
                if work is None:
                    work = torch.zeros((n, w.shape[1]), dtype=torch.int64,
                                       device=rays.device)
                work[live[sel]] += w
        occ[live] = blocked.to(torch.int32)
    return occ, counts, work


def intersect_mesh_instances_any_plain(rays, inst_tbl, inst_bounds, tri_tbl,
                                       tri_bounds, chunk, n_ichunks: int,
                                       block: int = 16384,
                                       work: dict = None):
    """Plain PyTorch B9. Inputs as intersect_mesh_instances_plain (unit
    directions). Per ray, 1 where some triangle of some instance has its
    hit in [tmin, tmax], the direction scaled by 1/scale so t stays in
    world units and tmin, tmax are used as given. Returns occ (N,) int32.

    The walk over the instances is _serial_anyhit's; an entered instance's
    faces are all swept, up to the first blocking one. ``tri_bounds`` and
    ``chunk`` are ignored (None will do): the kernel's culls do not change
    the result.
    `work`, when given, receives the counts of this call: live lanes,
    chunk_tests, inst_tests (sphere tests made), sweeps ((ray, instance)
    pairs entered) and tri_tests ((ray, triangle) pairs up to each
    sweep's first blocking row)."""
    f_pad = tri_tbl.shape[0]

    def sweep(rk, row):
        ol, dl, inv_s = _to_object(rk, row)
        first = _sweep_packed(ol, tuple(x * inv_s for x in dl), rk[6], rk[7],
                              tri_tbl, 0, block)
        tests = torch.where(first < INF_BITS, first + 1, f_pad)
        return first, tests[:, None].long()

    occ, counts, tests = _serial_anyhit(rays, inst_tbl, inst_bounds,
                                        n_ichunks, sweep)
    if work is not None:
        work.update(counts, tri_tests=0 if tests is None
                    else int(tests.sum()))
    return occ


def intersect_mesh_instances_any_walk(rays, inst_tbl, inst_bounds, tri_tbl,
                                      tri_bounds, chunk: int,
                                      n_ichunks: int):
    """B9's kernel walk, lane by lane in its operations and order: the
    plain version's walk over the instances (_serial_anyhit), and for each
    instance entered the culled sweep (tri_sweep_walk, any hit) in B8's
    frame (direction rotated only, [tmin, tmax] scaled by 1/scale), with
    Moeller-Trumbore on the plain version's own ray (direction also scaled
    by 1/scale, the world segment; csrc/trimesh.cu extends the cull's
    argument to it). Returns (occ (N,) int32, counts as the plain
    version's, work (N, 5) int64: triangle chunks tested, chunks met,
    cones tested, faces guard-tested, faces swept, over the lane's
    sweeps)."""
    chunk = _check_tri_bounds(tri_bounds, chunk, tri_tbl.shape[0],
                              rays.device)

    def sweep(rk, row):
        ol, dl, inv_s = _to_object(rk, row)
        rl = torch.stack([*ol, *dl, rk[6] * inv_s, rk[7] * inv_s])
        rm = torch.stack([*ol, *(x * inv_s for x in dl), rk[6], rk[7]])
        first, _, w = tri_sweep_walk(rl, tri_tbl, tri_bounds, chunk, 0,
                                     any_hit=True, rm=rm)
        return first, w

    occ, counts, work = _serial_anyhit(rays, inst_tbl, inst_bounds,
                                       n_ichunks, sweep)
    if work is None:
        work = torch.zeros((rays.shape[1], 5), dtype=torch.int64,
                           device=rays.device)
    return occ, counts, work


def intersect_mesh_instances_any_work(rays, inst_tbl, inst_bounds, tri_tbl,
                                      tri_bounds, chunk: int, n_ichunks: int,
                                      block: int = 262144):
    """The work B9's kernel needs on these rays
    (intersect_mesh_instances_any_walk, in blocks of lanes). Returns (the
    walk's occ (N,), a dict of sums: the plain version's counts (live,
    chunk_tests, inst_tests, sweeps, and tri_tests: the faces its
    unculled sweeps visit), and the walk's tests (triangle chunks tested),
    met, cones, guards and rows (faces swept))."""
    names = ("tests", "met", "cones", "guards", "rows")
    out = dict.fromkeys(("live", "chunk_tests", "inst_tests", "sweeps",
                         "tri_tests", *names), 0)
    occ = torch.empty(rays.shape[1], dtype=torch.int32, device=rays.device)
    for s in range(0, rays.shape[1], block):
        r = rays[:, s:s + block]
        occ[s:s + block], _, work = intersect_mesh_instances_any_walk(
            r, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk, n_ichunks)
        plain = {}
        intersect_mesh_instances_any_plain(r, inst_tbl, inst_bounds, tri_tbl,
                                           None, None, n_ichunks, work=plain)
        for name, count in plain.items():
            out[name] += count
        for j, name in enumerate(names):
            out[name] += int(work[:, j].sum())
    return occ, out


def intersect_mesh_instances_any(rays, inst_tbl, inst_bounds, tri_tbl,
                                 tri_bounds, chunk: int, n_ichunks: int,
                                 block: int = 16384):
    """B9; see intersect_mesh_instances_any_plain for the contract.
    tri_bounds (TRI_BOUND_ROWS, C_pad) holds the covering spheres and guard
    cones of the triangle table's chunks of `chunk` rows
    (tri_chunk_bounds), by which the kernel culls each instance's sweep per
    lane (intersect_mesh_instances_any_walk). A CUDA tensor launches
    drts_mesh_instances_any (csrc/trimesh.cu), which compacts each block's
    live lanes and takes a block of fewer than B9_SPARSE_LIVE (read now)
    one live ray at a time with all its threads."""
    _check_rays(rays)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("inst_bounds", inst_bounds, 4, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    chunk = _check_tri_bounds(tri_bounds, chunk, tri_tbl.shape[0],
                              rays.device)
    if rays.device.type == "cpu":
        return intersect_mesh_instances_any_plain(
            rays, inst_tbl, inst_bounds, tri_tbl, tri_bounds, chunk,
            n_ichunks, block)
    if (inst_tbl.shape[1] != n_ichunks * INST_CHUNK
            or inst_bounds.shape[1] < n_ichunks):
        raise ValueError(f"inst_tbl {tuple(inst_tbl.shape)} and inst_bounds "
                         f"{tuple(inst_bounds.shape)} do not hold "
                         f"{n_ichunks} chunks of {INST_CHUNK}")
    lib = backend.kernels()
    n = rays.shape[1]
    occ = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_mesh_instances_any(
        rays.data_ptr(), n, inst_tbl.data_ptr(), inst_tbl.shape[1],
        inst_bounds.data_ptr(), inst_bounds.shape[1], n_ichunks, INST_CHUNK,
        BOUND_SCALE, BOUND_PAD, tri_tbl.data_ptr(), tri_tbl.shape[0],
        tri_bounds.data_ptr(), tri_bounds.shape[1], chunk, TRI_CULL_SCALE,
        TRI_GUARD, B9_SPARSE_LIVE, occ.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_mesh_instances_any")
    backend.launched("intersect_mesh_instances_any")
    return occ


# ----------------------------------------------------------------------------
# The candidate loop and the hit refinement


def cand_loop(rays, bscan_tbl, inst_tbl, inst_bounds, tri_tbl, tri_bounds,
              chunk: int, rounds: int, block: int = 16384):
    """The candidate rounds of the multi-launch loop: `rounds` times, B5
    hands every ray its next bounding sphere front to back (culling by
    the chunk spheres inst_bounds), B6 sweeps that instance (culling by
    the triangle chunks' bounds tri_bounds at `chunk`) and tmax tightens
    to the best hit; then one more B5 scan. Returns (best, binst,
    key): the packed world best, its instance position and the last scan's
    key (< INF_BITS where a sphere is left ahead). `rays` is not
    modified."""
    n, m_tbl = rays.shape[1], inst_tbl.shape[1]
    dev = rays.device
    pos_mask = (1 << pos_bits(bscan_tbl.shape[0])) - 1
    trunc_f = ~((1 << pos_bits(tri_tbl.shape[0])) - 1)
    cur = rays.clone()
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best = torch.full((n,), INF_BITS, dtype=torch.int32, device=dev)
    binst = torch.zeros(n, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        key = bound_scan(cur, bscan_tbl, cursor, inst_bounds, m_tbl, block)
        # m_tbl marks "no candidate": keys name real columns only.
        cand = torch.where(key < INF_BITS, key & pos_mask, m_tbl).to(
            torch.int32)
        best, binst = shared_blas_sweep(cur, cand, best, binst, inst_tbl,
                                        tri_tbl, tri_bounds, chunk, block)
        cursor = key
        cur[7] = torch.minimum(rays[7], (best & trunc_f).view(torch.float32))
    return best, binst, bound_scan(cur, bscan_tbl, cursor, inst_bounds, m_tbl,
                                   block)


def _backstop(rays, best, binst, key, inst_tbl, inst_bounds, tri_tbl,
              tri_bounds, chunk: int, n_ichunks: int, block: int):
    """B7 on the lanes the candidate rounds left unresolved (key <
    INF_BITS), on their range tightened to the best so far, merged with
    the rounds' best. Returns intersect_mesh_instances' (t, face, inst)."""
    m_tbl = inst_tbl.shape[1]
    trunc_f = ~((1 << pos_bits(tri_tbl.shape[0])) - 1)
    t_w = (best & trunc_f).view(torch.float32)
    unresolved = key < INF_BITS
    cur = rays.clone()
    cur[7] = torch.where(unresolved, torch.minimum(rays[7], t_w),
                         rays[6] - 1.0)
    t_fb, face_fb, inst_fb = intersect_mesh_instances(
        cur, inst_tbl, inst_bounds, tri_tbl, n_ichunks, tri_bounds, chunk,
        block)
    fb_better = unresolved & (t_fb < t_w)
    t_w = torch.where(fb_better, t_fb,
                      torch.where(best < INF_BITS, t_w, float("inf")))
    face = torch.where(fb_better, face_fb, best & ~trunc_f)
    inst = torch.where(fb_better, inst_fb, torch.clamp(binst, max=m_tbl - 1))
    return t_w, face, inst


def intersect_mesh_instances_cand(rays, inst_tbl, inst_bounds, tri_tbl,
                                  tri_bounds, chunk: int, n_ichunks: int,
                                  rounds: int = CAND_ROUNDS,
                                  block: int = 16384):
    """Candidate-iteration closest hit (the reference's DRTS_MESH_CAND=1):
    the rounds of cand_loop, then B7 walks the rays that still have a
    sphere ahead exactly, on their tightened range. Same contract as
    intersect_mesh_instances."""
    best, binst, key = cand_loop(rays, make_bscan_table(inst_tbl), inst_tbl,
                                 inst_bounds, tri_tbl, tri_bounds, chunk,
                                 rounds, block)
    return _backstop(rays, best, binst, key, inst_tbl, inst_bounds, tri_tbl,
                     tri_bounds, chunk, n_ichunks, block)


# ----------------------------------------------------------------------------
# B10: the candidate rounds fused into one launch


def cand_fused_plain(rays, bscan_tbl, inst_tbl, inst_bounds, tri_tbl,
                     tri_bounds, chunk: int, rounds: int, block: int = 16384,
                     work: dict = None):
    """Plain PyTorch B10. rays (8, N), tmin >= 0, unit directions;
    bscan_tbl (M_pad, 4) from make_bscan_table; inst_tbl (9, M); tri_tbl
    (F_pad, 9). Per lane: best, binst and the cursor start at INF_BITS, 0
    and -1; `rounds` + 1 times the lane scans the bound-scan table for the
    least key greater than its cursor with tmax_eff = min(tmax, best t)
    (B5's contract: none on a lane whose tmax_eff < tmin, or whose cursor
    is INF_BITS, a closed lane); after each of the first `rounds` scans a
    lane that found a key sweeps that instance's whole triangle table in
    its object frame and folds the world packed (t | face) into best and
    binst (B6's contract). Returns (best, binst, key), key from the last
    scan: the multi-launch loop's cand_loop, computed lane by lane as the
    kernel does (the dead lanes, tmax < tmin, sweep nothing).
    ``inst_bounds``, ``tri_bounds`` and ``chunk`` are ignored: the
    kernel's culls do not change the result, which this computes from the
    whole tables. `work`, when given, receives the counts of this call:
    live lanes, scans (lane scans made) and sweeps (lanes that swept an
    instance)."""
    m_tbl = inst_tbl.shape[1]
    pos_mask = (1 << pos_bits(bscan_tbl.shape[0])) - 1
    trunc_f = ~((1 << pos_bits(tri_tbl.shape[0])) - 1)
    live0 = rays[7] >= rays[6]
    cur = rays.clone()
    cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32,
                        device=rays.device)
    best = torch.full_like(cursor, INF_BITS)
    binst = torch.zeros_like(cursor)
    counts = {"live": int(live0.sum()), "scans": 0, "sweeps": 0}
    for it in range(rounds + 1):
        cur[7] = torch.minimum(rays[7], (best & trunc_f).view(torch.float32))
        counts["scans"] += int((live0 & (cursor < INF_BITS)
                                & (cur[7] >= cur[6])).sum())
        key = bound_scan_plain(cur, bscan_tbl, cursor, block=block)
        cursor = key
        if it == rounds:
            break
        cand = torch.where((key < INF_BITS) & live0, key & pos_mask,
                           m_tbl).to(torch.int32)
        counts["sweeps"] += int((cand < m_tbl).sum())
        best, binst = shared_blas_sweep_plain(cur, cand, best, binst,
                                              inst_tbl, tri_tbl, block=block)
    if work is not None:
        work.update(counts)
    return best, binst, key


def cand_fused_walk(rays, bscan_tbl, inst_tbl, inst_bounds, tri_tbl,
                    tri_bounds, chunk: int, rounds: int):
    """B10's kernel walk, lane by lane in its operations and order: each
    round's scan is B5's culled walk (bound_scan_walk) on [tmin,
    tmax_eff] from the lane's cursor, and each sweep the culled face sweep
    (tri_sweep_walk) of the candidate found. Returns ((best, binst, key)
    as cand_fused_plain, work (N, 9) int64: the scan's chunks tested,
    chunks met, rows swept and roots taken, then the sweep's chunks
    tested, chunks met, cones tested, faces guard-tested and faces swept,
    summed over the rounds, warp (2,) int: the scan's and the sweep's chunks met per
    warp (warp_sum), summed over the rounds)."""
    n, m_tbl, f_pad = rays.shape[1], inst_tbl.shape[1], tri_tbl.shape[0]
    dev = rays.device
    n_ic = _check_scan_bounds(inst_bounds, m_tbl, bscan_tbl.shape[0])
    chunk = _check_tri_bounds(tri_bounds, chunk, f_pad, dev)
    pos_mask = (1 << pos_bits(bscan_tbl.shape[0])) - 1
    trunc_f = ~((1 << pos_bits(f_pad)) - 1)
    scan_rows = torch.clamp(m_tbl - INST_CHUNK * torch.arange(
        n_ic, device=dev), max=INST_CHUNK)
    live0 = rays[7] >= rays[6]
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best = torch.full_like(cursor, INF_BITS)
    binst = torch.zeros_like(cursor)
    work = torch.zeros((n, 9), dtype=torch.int64, device=dev)
    warp = [0, 0]
    for it in range(rounds + 1):
        tmx = torch.minimum(rays[7], (best & trunc_f).view(torch.float32))
        scanning = live0 & (cursor < INF_BITS) & (tmx >= rays[6])
        cur = rays.clone()
        cur[7] = torch.where(scanning, tmx, float("-inf"))
        met, key, roots = bound_scan_walk(cur, bscan_tbl, cursor,
                                          inst_bounds, m_tbl)
        work[:, 0] += torch.where(scanning, n_ic, 0)
        work[:, 1] += met.sum(1)
        work[:, 2] += met.mul(scan_rows).sum(1)
        work[:, 3] += roots
        warp[0] += warp_sum(met)
        cursor = key
        if it == rounds:
            break
        cand = torch.where(key < INF_BITS, key & pos_mask, m_tbl)
        idx = torch.nonzero(cand < m_tbl)[:, 0]
        best, binst, met_l, work_l = _culled_sweep(
            rays, idx, cand, best, binst, tmx, inst_tbl, tri_tbl, tri_bounds,
            chunk)
        work[idx, 4:] += work_l
        met = torch.zeros((n, f_pad // chunk), dtype=torch.bool, device=dev)
        met[idx] = met_l
        warp[1] += warp_sum(met)
    return (best, binst, key), work, warp


def cand_fused_work(rays, bscan_tbl, inst_tbl, inst_bounds, tri_tbl,
                    tri_bounds, chunk: int, rounds: int, block: int = 65536):
    """The work B10's kernel needs on these rays (cand_fused_walk, in
    blocks of lanes). Returns (the walk's (best, binst, key), a dict of
    sums over the lanes and rounds: scan_tests,
    scan_met, scan_rows, scan_roots, tri_tests, tri_met, cones, guards,
    faces (faces swept), scan_warp_met and tri_warp_met (chunks met per warp),
    and warps (warps with a live lane))."""
    names = ("scan_tests", "scan_met", "scan_rows", "scan_roots",
             "tri_tests", "tri_met", "cones", "guards", "faces")
    out = dict.fromkeys((*names, "scan_warp_met", "tri_warp_met", "warps"),
                        0)
    words = [torch.empty(rays.shape[1], dtype=torch.int32,
                         device=rays.device) for _ in range(3)]
    block = max(32, block // 32 * 32)
    for s in range(0, rays.shape[1], block):
        r = rays[:, s:s + block]
        walked, work, warp = cand_fused_walk(r, bscan_tbl, inst_tbl,
                                             inst_bounds, tri_tbl, tri_bounds,
                                             chunk, rounds)
        for w, x in zip(words, walked):
            w[s:s + block] = x
        for j, name in enumerate(names):
            out[name] += int(work[:, j].sum())
        out["scan_warp_met"] += warp[0]
        out["tri_warp_met"] += warp[1]
        out["warps"] += warp_sum((r[7] >= r[6])[:, None])
    return tuple(words), out


def cand_fused(rays, bscan_tbl, inst_tbl, inst_bounds, tri_tbl, tri_bounds,
               chunk: int, rounds: int, block: int = 16384):
    """B10; see cand_fused_plain for the contract. inst_bounds (4, IC_pad)
    holds the covering spheres of the instance table's chunks
    (make_inst_tables), by which each round's scan culls as B5 does;
    tri_bounds (TRI_BOUND_ROWS, C_pad) those of the triangle table's
    chunks of `chunk` rows (tri_chunk_bounds), by which each sweep culls
    as B8 does
    (cand_fused_walk repeats the kernel's walk). A CUDA tensor launches
    drts_cand_fused (csrc/trimesh.cu)."""
    _check_rays(rays)
    _check_table("bscan_tbl", bscan_tbl, 4, rays.device, rows_first=False)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("inst_bounds", inst_bounds, 4, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    m_tbl, m_pad = inst_tbl.shape[1], bscan_tbl.shape[0]
    _check_scan_bounds(inst_bounds, m_tbl, m_pad)
    chunk = _check_tri_bounds(tri_bounds, chunk, tri_tbl.shape[0],
                              rays.device)
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if rays.device.type == "cpu":
        return cand_fused_plain(rays, bscan_tbl, inst_tbl, inst_bounds,
                                tri_tbl, tri_bounds, chunk, rounds, block)
    lib = backend.kernels()
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    best = torch.empty(n, dtype=torch.int32, device=rays.device)
    binst = torch.empty_like(best)
    key = torch.empty_like(best)
    rc = lib.drts_cand_fused(
        rays.data_ptr(), n, bscan_tbl.data_ptr(), m_pad, pos_bits(m_pad),
        inst_tbl.data_ptr(), m_tbl, inst_bounds.data_ptr(),
        inst_bounds.shape[1], INST_CHUNK, tri_tbl.data_ptr(), f_pad,
        pos_bits(f_pad), tri_bounds.data_ptr(), tri_bounds.shape[1], chunk,
        intersect_kernels.CULL_SCALE, TRI_CULL_SCALE, TRI_GUARD, rounds,
        best.data_ptr(), binst.data_ptr(), key.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_cand_fused")
    backend.launched("cand_fused")
    return best, binst, key


def intersect_mesh_instances_cand_fused(rays, inst_tbl, inst_bounds, tri_tbl,
                                        tri_bounds, chunk: int,
                                        n_ichunks: int,
                                        rounds: int = CAND_ROUNDS,
                                        block: int = 16384):
    """Fused candidate-iteration closest hit (the reference's
    DRTS_MESH_CAND=2): B10 runs every round in one launch, then B7 walks
    the unresolved rays as in intersect_mesh_instances_cand. B10 visits
    the candidates of the multi-launch loop in the same order, so both
    return the same words."""
    best, binst, key = cand_fused(rays, make_bscan_table(inst_tbl), inst_tbl,
                                  inst_bounds, tri_tbl, tri_bounds, chunk,
                                  rounds, block)
    return _backstop(rays, best, binst, key, inst_tbl, inst_bounds, tri_tbl,
                     tri_bounds, chunk, n_ichunks, block)


def intersect_mesh_instances_any_cand(rays, inst_tbl, inst_bounds, tri_tbl,
                                      tri_bounds, chunk: int, n_ichunks: int,
                                      rounds: int = ANY_ROUNDS,
                                      block: int = 16384):
    """Candidate-iteration any hit: `rounds` times, B5 hands every ray its
    next bounding sphere front to back and B8 tests that one instance; a
    blocked lane leaves the enumeration with a dead range. Then B5 marks
    the lanes that are not blocked and still have a sphere ahead, and B9
    walks those exactly. Returns blocked (N,) bool. `rays` is not
    modified."""
    n, m_tbl = rays.shape[1], inst_tbl.shape[1]
    dev = rays.device
    bscan = make_bscan_table(inst_tbl)
    pos_mask = (1 << pos_bits(bscan.shape[0])) - 1

    def without(gone):
        """The caller's rays, the lanes of `gone` given a dead range."""
        cur = rays.clone()
        cur[7] = torch.where(gone, rays[6] - 1.0, rays[7])
        return cur

    cur = rays
    cursor = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros(n, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        key = bound_scan(cur, bscan, cursor, inst_bounds, m_tbl, block)
        # m_tbl marks "no candidate": keys name real columns only.
        cand = torch.where(key < INF_BITS, key & pos_mask, m_tbl).to(
            torch.int32)
        occ = shared_blas_any(cur, cand, occ, inst_tbl, tri_tbl, tri_bounds,
                              chunk, block)
        cursor = key
        cur = without(occ > 0)

    key = bound_scan(cur, bscan, cursor, inst_bounds, m_tbl, block)
    unresolved = (key < INF_BITS) & (occ == 0)
    occ_fb = intersect_mesh_instances_any(
        without(~unresolved), inst_tbl, inst_bounds, tri_tbl, tri_bounds,
        chunk, n_ichunks, block)
    return (occ > 0) | (occ_fb > 0)


def refine_hit(mesh, center, rotation, scale, origin, direction, t_trunc,
               face, inst):
    """Exact (t, u, v) of each ray's winning (instance, face): one
    Moeller-Trumbore in object space. It restores the mantissa bits the
    packed word truncated and yields the barycentrics."""
    hit = torch.isfinite(t_trunc)
    inv_s = (1.0 / torch.clamp(scale, min=1e-12))[inst][..., None]
    inv_rot = m.quat_conj(rotation[inst])
    o_l = m.quat_rotate(inv_rot, origin - center[inst]) * inv_s
    d_l = m.quat_rotate(inv_rot, direction) * inv_s

    v0, e1, e2 = mesh.v0[face], mesh.e1[face], mesh.e2[face]
    pvec = m.cross(d_l, e2)
    det = torch.sum(pvec * e1, dim=-1)
    sound = torch.abs(det) > 1e-20
    inv = 1.0 / torch.where(sound, det, 1.0)
    tvec = o_l - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv
    qvec = m.cross(tvec, e1)
    v = torch.sum(qvec * d_l, dim=-1) * inv
    t = torch.sum(qvec * e2, dim=-1) * inv
    t = torch.where(hit & sound, t, float("inf"))
    return t, torch.clamp(u, 0.0, 1.0), torch.clamp(v, 0.0, 1.0)
