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
  B7, the exact backstop of the any-hit candidate loop.
- ``cand_fused`` replaces ``trimesh_pallas.cand_fused`` (B10): every round
  of the candidate loop (B5, then B6 on the candidate found) and the last
  scan in one launch, each lane walking its own candidates in the loop's
  order, so it returns the loop's words.

What the TPU kernels were: blocks of 2,048 rays that decide per block (a
bundle's origin sphere and direction cone cull instance chunks, instances
and triangle chunks for the whole block; B6 loops over the block's
distinct candidates). Those culls are conservative and change no result.
On the H100 each kernel takes one thread per ray, which reads its own
candidate row and keeps its best in a register; a pair costs ~25 (B5) or
~50 (B6, B7) separately rounded float32 operations against 32-48 bytes per
ray, so all of them are bound by the instruction rate, not by memory. Culls
kept: a dead lane (tmax < tmin) does no work and a block of dead lanes
leaves before it reads a table (B5, B6, B8); B5 tests each ray against the
instance chunks' covering spheres, with a segment that ends at its best
key so far (B1's half-line cull, ``intersect_kernels.segment_misses``),
sweeps only the rows of the chunks it meets and takes no root where the
discriminant is negative (``bound_scan_walk`` repeats its walk and
``bound_scan_work`` counts it); B7 and B9 test each ray against the
instance chunks' covering spheres and the instances' bounding spheres,
with the ray's running best (B7) or its own tmax (B9) as the far limit,
and sweep only what passes. The reference's triangle-chunk culls
(chunk bounding spheres, normal cones, the convex back-face cull) are left
out together with their tables: every sweep visits all faces. B10 also
leaves out the reference's front-to-back chunk order (MESH_F2B), which
changes no result either: a packed min does not depend on the order of
the visits.

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
INST_CHUNK = 16       # instances per TLAS chunk
BSCAN_CHUNK = 128     # the bound-scan table is padded to a multiple of this
CAND_ROUNDS = 3       # candidate rounds before the serial backstop
ANY_ROUNDS = 2        # any-hit candidate rounds before the serial backstop
# Slack of B7's per-ray sphere tests: radius * BOUND_SCALE + BOUND_PAD
# (the kernel takes both, and INST_CHUNK, as arguments).
BOUND_SCALE = 1.0001
BOUND_PAD = 1e-5


# ----------------------------------------------------------------------------
# Tables


def build_mesh_tables(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
    """Host-side BLAS build (numpy, once per mesh): Morton-order the faces
    by centroid and pad to a multiple of TRI_PAD with all-zero rows, which
    never hit. Returns (order (F,), tri_tbl (F_pad, 9) [v0 e1 e2])."""
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
    return order, tbl


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
    tbl[:, 3] = 1e30
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


def _sweep_packed(ol, dl, tmn, tmx, tri_tbl, trunc, block):
    """Two-sided Moeller-Trumbore of L rays (ol, dl: three (L,) tensors
    each; tmn, tmx (L,)) against every row of tri_tbl. Returns (L,) int32:
    the least packed (t bits & trunc | face row) over the rows hit in
    [tmn, tmx], INF_BITS where none. 1 / det is +-inf on a degenerate or
    padded row, whose NaN or inf u, v, t fail the compares."""
    n, f_pad = ol[0].shape[0], tri_tbl.shape[0]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        c[None, :] for c in tri_tbl.T)
    pos = torch.arange(f_pad, dtype=torch.int32,
                       device=tri_tbl.device)[None, :]
    out = torch.empty(n, dtype=torch.int32, device=tri_tbl.device)
    starts, step = _blocks(n, f_pad, block)
    for s in starts:
        olx, oly, olz = (x[s:s + step, None] for x in ol)
        dlx, dly, dlz = (x[s:s + step, None] for x in dl)
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
              & (t >= tmn[s:s + step, None]) & (t <= tmx[s:s + step, None]))
        ti = (t.view(torch.int32) & trunc) | pos
        out[s:s + step] = torch.where(ok, ti, INF_BITS).amin(dim=1)
    return out


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
                            block: int = 16384):
    """Plain PyTorch B6. rays (8, N); cand (N,) int32 table position of
    the ray's candidate instance (outside [0, M) = none); best (N,) int32
    packed (world t bits | face row) so far, INF_BITS = none; binst (N,)
    int32 its instance position; inst_tbl (9, M); tri_tbl (F_pad, 9).

    A lane is live when min(tmax, best t) >= tmin and it has a candidate.
    It sweeps the triangle table in the candidate's object frame with the
    direction rotated but not scaled, so t is in object units; the least
    packed word is rescaled (t * scale) and repacked, and replaces the
    best where it is smaller. Returns the new (best, binst)."""
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


def shared_blas_sweep(rays, cand, best, binst, inst_tbl, tri_tbl,
                      block: int = 16384):
    """B6; see shared_blas_sweep_plain for the contract. A CUDA tensor
    launches drts_shared_blas_sweep (csrc/trimesh.cu)."""
    _check_rays(rays)
    n = rays.shape[1]
    for name, x in (("cand", cand), ("best", best), ("binst", binst)):
        _check_words(name, x, n, rays.device)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    if rays.device.type == "cpu":
        return shared_blas_sweep_plain(rays, cand, best, binst, inst_tbl,
                                       tri_tbl, block)
    lib = backend.kernels()
    f_pad = tri_tbl.shape[0]
    best_out = torch.empty_like(best)
    binst_out = torch.empty_like(binst)
    rc = lib.drts_shared_blas_sweep(
        rays.data_ptr(), n, cand.data_ptr(), best.data_ptr(),
        binst.data_ptr(), inst_tbl.data_ptr(), inst_tbl.shape[1],
        tri_tbl.data_ptr(), f_pad, pos_bits(f_pad), best_out.data_ptr(),
        binst_out.data_ptr(), backend.stream_handle(rays))
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


def intersect_mesh_instances_plain(rays, inst_tbl, inst_bounds, tri_tbl,
                                   n_ichunks: int, block: int = 16384,
                                   work: dict = None):
    """Plain PyTorch B7. rays (8, N), unit directions; inst_tbl (9, M)
    with M = n_ichunks * INST_CHUNK; inst_bounds (4, IC_pad) chunk
    spheres; tri_tbl (F_pad, 9). Per ray, the closest hit over every
    instance and face, the direction scaled by 1/scale so t stays in world
    units. Returns (t (N,) float32 truncated down to the packed precision,
    inf on miss; face (N,) int32 table row; inst (N,) int32 table
    position: the first, in table order, at which the packed best
    improved).

    The live lanes are compacted, then the instances are visited in table
    order as the kernel visits them: a chunk, then an instance, is
    entered by the lanes whose segment up to their running best meets its
    sphere (_reaches), and only those (ray, instance) pairs are swept.
    `work`, when given, receives the counts of this call: live lanes,
    chunk_tests, inst_tests (sphere tests made) and sweeps ((ray,
    instance) pairs swept over the triangle table)."""
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    if inst_tbl.shape[1] != n_ichunks * INST_CHUNK:
        raise ValueError(f"inst_tbl has {inst_tbl.shape[1]} columns, "
                         f"expected {n_ichunks} x {INST_CHUNK}")
    trunc = ~((1 << pos_bits(f_pad)) - 1)
    packed = torch.full((n,), INF_BITS, dtype=torch.int32,
                        device=rays.device)
    inst = torch.zeros(n, dtype=torch.int32, device=rays.device)
    live = torch.nonzero(rays[7] >= rays[6])[:, 0]
    counts = {"live": live.numel(), "chunk_tests": 0, "inst_tests": 0,
              "sweeps": 0}
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
                rk = r[:, sel]
                ol, dl, inv_s = _to_object(rk, row)
                dl = tuple(x * inv_s for x in dl)
                hit = _sweep_packed(ol, dl, rk[6], rk[7], tri_tbl, trunc,
                                    block)
                better = hit < best[sel]
                binst[sel] = torch.where(better, k, binst[sel])
                best[sel] = torch.where(better, hit, best[sel])
        packed[live] = best
        inst[live] = binst
    if work is not None:
        work.update(counts)
    return (packed & trunc).view(torch.float32), packed & ~trunc, inst


def intersect_mesh_instances(rays, inst_tbl, inst_bounds, tri_tbl,
                             n_ichunks: int, block: int = 16384):
    """B7; see intersect_mesh_instances_plain for the contract. A CUDA
    tensor launches drts_mesh_instances_closest (csrc/trimesh.cu)."""
    _check_rays(rays)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("inst_bounds", inst_bounds, 4, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    if rays.device.type == "cpu":
        return intersect_mesh_instances_plain(rays, inst_tbl, inst_bounds,
                                              tri_tbl, n_ichunks, block)
    if (inst_tbl.shape[1] != n_ichunks * INST_CHUNK
            or inst_bounds.shape[1] < n_ichunks):
        raise ValueError(f"inst_tbl {tuple(inst_tbl.shape)} and inst_bounds "
                         f"{tuple(inst_bounds.shape)} do not hold "
                         f"{n_ichunks} chunks of {INST_CHUNK}")
    lib = backend.kernels()
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    face = torch.empty(n, dtype=torch.int32, device=rays.device)
    inst = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_mesh_instances_closest(
        rays.data_ptr(), n, inst_tbl.data_ptr(), inst_tbl.shape[1],
        inst_bounds.data_ptr(), inst_bounds.shape[1], n_ichunks, INST_CHUNK,
        BOUND_SCALE, BOUND_PAD, tri_tbl.data_ptr(), f_pad, pos_bits(f_pad),
        t.data_ptr(), face.data_ptr(), inst.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_mesh_instances_closest")
    backend.launched("intersect_mesh_instances")
    return t, face, inst


# ----------------------------------------------------------------------------
# B8: does each ray's candidate instance block it?


def shared_blas_any_plain(rays, cand, occ_in, inst_tbl, tri_tbl,
                          block: int = 16384, work: dict = None):
    """Plain PyTorch B8. rays (8, N); cand (N,) int32 table position of the
    ray's candidate instance (outside [0, M) = none); occ_in (N,) int32
    blocked bit so far; inst_tbl (9, M); tri_tbl (F_pad, 9).

    A lane is live when tmax >= tmin, it has a candidate and occ_in is 0;
    every other lane returns occ_in. A live lane sweeps the triangle table
    in the candidate's object frame with the direction rotated but not
    scaled, so tmin and tmax are scaled into object units; it returns 1
    where some triangle's hit lies in that range. Returns occ (N,) int32.
    `work`, when given, receives the counts of this call: live lanes and
    tri_tests, the (ray, triangle) pairs up to each lane's first blocking
    row (all rows where none blocks)."""
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


def shared_blas_any(rays, cand, occ_in, inst_tbl, tri_tbl,
                    block: int = 16384):
    """B8; see shared_blas_any_plain for the contract. A CUDA tensor
    launches drts_shared_blas_any (csrc/trimesh.cu)."""
    _check_rays(rays)
    n = rays.shape[1]
    _check_words("cand", cand, n, rays.device)
    _check_words("occ_in", occ_in, n, rays.device)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    if rays.device.type == "cpu":
        return shared_blas_any_plain(rays, cand, occ_in, inst_tbl, tri_tbl,
                                     block)
    lib = backend.kernels()
    occ = torch.empty_like(occ_in)
    rc = lib.drts_shared_blas_any(
        rays.data_ptr(), n, cand.data_ptr(), occ_in.data_ptr(),
        inst_tbl.data_ptr(), inst_tbl.shape[1], tri_tbl.data_ptr(),
        tri_tbl.shape[0], occ.data_ptr(), backend.stream_handle(rays))
    backend.check_launch(rc, "drts_shared_blas_any")
    backend.launched("shared_blas_any")
    return occ


# ----------------------------------------------------------------------------
# B9: the serial any-hit walk over every instance


def intersect_mesh_instances_any_plain(rays, inst_tbl, inst_bounds, tri_tbl,
                                       n_ichunks: int, block: int = 16384,
                                       work: dict = None):
    """Plain PyTorch B9. Inputs as intersect_mesh_instances_plain (unit
    directions). Per ray, 1 where some triangle of some instance has its
    hit in [tmin, tmax], the direction scaled by 1/scale so t stays in
    world units and tmin, tmax are used as given. Returns occ (N,) int32.

    The live lanes are compacted and walk the instances in table order; a
    chunk, then an instance, is entered by the lanes not yet blocked whose
    segment [tmin, tmax] meets its sphere (_reaches), and a blocked lane
    leaves the walk. `work`, when given, receives the counts of this call:
    live lanes, chunk_tests, inst_tests (sphere tests made), sweeps ((ray,
    instance) pairs entered) and tri_tests ((ray, triangle) pairs up to
    each sweep's first blocking row)."""
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    if inst_tbl.shape[1] != n_ichunks * INST_CHUNK:
        raise ValueError(f"inst_tbl has {inst_tbl.shape[1]} columns, "
                         f"expected {n_ichunks} x {INST_CHUNK}")
    occ = torch.zeros(n, dtype=torch.int32, device=rays.device)
    live = torch.nonzero(rays[7] >= rays[6])[:, 0]
    counts = {"live": live.numel(), "chunk_tests": 0, "inst_tests": 0,
              "sweeps": 0, "tri_tests": 0}
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
                rk = r[:, sel]
                ol, dl, inv_s = _to_object(rk, row)
                dl = tuple(x * inv_s for x in dl)
                first = _sweep_packed(ol, dl, rk[6], rk[7], tri_tbl, 0, block)
                hit = first < INF_BITS
                blocked[sel] = hit
                counts["tri_tests"] += int(
                    torch.where(hit, first + 1, f_pad).sum())
        occ[live] = blocked.to(torch.int32)
    if work is not None:
        work.update(counts)
    return occ


def intersect_mesh_instances_any(rays, inst_tbl, inst_bounds, tri_tbl,
                                 n_ichunks: int, block: int = 16384):
    """B9; see intersect_mesh_instances_any_plain for the contract. A CUDA
    tensor launches drts_mesh_instances_any (csrc/trimesh.cu)."""
    _check_rays(rays)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("inst_bounds", inst_bounds, 4, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    if rays.device.type == "cpu":
        return intersect_mesh_instances_any_plain(
            rays, inst_tbl, inst_bounds, tri_tbl, n_ichunks, block)
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
        occ.data_ptr(), backend.stream_handle(rays))
    backend.check_launch(rc, "drts_mesh_instances_any")
    backend.launched("intersect_mesh_instances_any")
    return occ


# ----------------------------------------------------------------------------
# The candidate loop and the hit refinement


def cand_loop(rays, bscan_tbl, inst_tbl, inst_bounds, tri_tbl, rounds: int,
              block: int = 16384):
    """The candidate rounds of the multi-launch loop: `rounds` times, B5
    hands every ray its next bounding sphere front to back (culling by
    the chunk spheres inst_bounds), B6 sweeps that instance and tmax
    tightens to the best hit; then one more B5 scan. Returns (best, binst,
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
                                        tri_tbl, block)
        cursor = key
        cur[7] = torch.minimum(rays[7], (best & trunc_f).view(torch.float32))
    return best, binst, bound_scan(cur, bscan_tbl, cursor, inst_bounds, m_tbl,
                                   block)


def _backstop(rays, best, binst, key, inst_tbl, inst_bounds, tri_tbl,
              n_ichunks: int, block: int):
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
        cur, inst_tbl, inst_bounds, tri_tbl, n_ichunks, block)
    fb_better = unresolved & (t_fb < t_w)
    t_w = torch.where(fb_better, t_fb,
                      torch.where(best < INF_BITS, t_w, float("inf")))
    face = torch.where(fb_better, face_fb, best & ~trunc_f)
    inst = torch.where(fb_better, inst_fb, torch.clamp(binst, max=m_tbl - 1))
    return t_w, face, inst


def intersect_mesh_instances_cand(rays, inst_tbl, inst_bounds, tri_tbl,
                                  n_ichunks: int, rounds: int = CAND_ROUNDS,
                                  block: int = 16384):
    """Candidate-iteration closest hit (the reference's DRTS_MESH_CAND=1):
    the rounds of cand_loop, then B7 walks the rays that still have a
    sphere ahead exactly, on their tightened range. Same contract as
    intersect_mesh_instances."""
    best, binst, key = cand_loop(rays, make_bscan_table(inst_tbl), inst_tbl,
                                 inst_bounds, tri_tbl, rounds, block)
    return _backstop(rays, best, binst, key, inst_tbl, inst_bounds, tri_tbl,
                     n_ichunks, block)


# ----------------------------------------------------------------------------
# B10: the candidate rounds fused into one launch


def cand_fused_plain(rays, bscan_tbl, inst_tbl, tri_tbl, rounds: int,
                     block: int = 16384, work: dict = None):
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
    kernel does (the dead lanes, tmax < tmin, sweep nothing). `work`, when
    given, receives the counts of this call: live lanes, scans (lane
    scans made) and sweeps (lanes that swept an instance)."""
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
                                              inst_tbl, tri_tbl, block)
    if work is not None:
        work.update(counts)
    return best, binst, key


def cand_fused(rays, bscan_tbl, inst_tbl, tri_tbl, rounds: int,
               block: int = 16384):
    """B10; see cand_fused_plain for the contract. A CUDA tensor launches
    drts_cand_fused (csrc/trimesh.cu)."""
    _check_rays(rays)
    _check_table("bscan_tbl", bscan_tbl, 4, rays.device, rows_first=False)
    _check_table("inst_tbl", inst_tbl, 9, rays.device)
    _check_table("tri_tbl", tri_tbl, 9, rays.device, rows_first=False)
    if rounds < 0:
        raise ValueError(f"rounds must be >= 0, got {rounds}")
    if rays.device.type == "cpu":
        return cand_fused_plain(rays, bscan_tbl, inst_tbl, tri_tbl, rounds,
                                block)
    lib = backend.kernels()
    n, m_pad, f_pad = rays.shape[1], bscan_tbl.shape[0], tri_tbl.shape[0]
    best = torch.empty(n, dtype=torch.int32, device=rays.device)
    binst = torch.empty_like(best)
    key = torch.empty_like(best)
    rc = lib.drts_cand_fused(
        rays.data_ptr(), n, bscan_tbl.data_ptr(), m_pad, pos_bits(m_pad),
        inst_tbl.data_ptr(), inst_tbl.shape[1], tri_tbl.data_ptr(), f_pad,
        pos_bits(f_pad), rounds, best.data_ptr(), binst.data_ptr(),
        key.data_ptr(), backend.stream_handle(rays))
    backend.check_launch(rc, "drts_cand_fused")
    backend.launched("cand_fused")
    return best, binst, key


def intersect_mesh_instances_cand_fused(rays, inst_tbl, inst_bounds, tri_tbl,
                                        n_ichunks: int,
                                        rounds: int = CAND_ROUNDS,
                                        block: int = 16384):
    """Fused candidate-iteration closest hit (the reference's
    DRTS_MESH_CAND=2): B10 runs every round in one launch, then B7 walks
    the unresolved rays as in intersect_mesh_instances_cand. B10 visits
    the candidates of the multi-launch loop in the same order, so both
    return the same words."""
    best, binst, key = cand_fused(rays, make_bscan_table(inst_tbl), inst_tbl,
                                  tri_tbl, rounds, block)
    return _backstop(rays, best, binst, key, inst_tbl, inst_bounds, tri_tbl,
                     n_ichunks, block)


def intersect_mesh_instances_any_cand(rays, inst_tbl, inst_bounds, tri_tbl,
                                      n_ichunks: int,
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
        occ = shared_blas_any(cur, cand, occ, inst_tbl, tri_tbl, block)
        cursor = key
        cur = without(occ > 0)

    key = bound_scan(cur, bscan, cursor, inst_bounds, m_tbl, block)
    unresolved = (key < INF_BITS) & (occ == 0)
    occ_fb = intersect_mesh_instances_any(
        without(~unresolved), inst_tbl, inst_bounds, tri_tbl, n_ichunks,
        block)
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
