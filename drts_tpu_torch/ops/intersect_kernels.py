"""The ray-sphere kernels of the port: wrappers, plain versions, counters.

Counterpart of ``drts_tpu/ops/intersect_pallas.py``. Each of its six TPU
kernels becomes a CUDA C++ kernel for Hopper in ``csrc/intersect.cu``:

- ``intersect_morton`` replaces ``intersect_pallas.intersect_morton_planar``
  (B1): closest hit over a Morton-ordered sphere table, reduced as the min
  of a packed int32 (truncated t bits | object id).
- ``intersect_brute`` replaces ``intersect_pallas.intersect_spheres_planar``
  (B11): brute-force closest hit over all spheres; smallest t wins, the
  lowest index on ties.
- ``occlusion_morton`` replaces ``intersect_pallas.occlusion_morton_planar``
  (B2): the any-hit shadow ray over B1's table, with one excluded object
  per ray (the target light).
- ``intersect_morton_mxu`` and ``occlusion_morton_mxu`` replace
  ``intersect_pallas.intersect_morton_mxu`` (B12a) and
  ``occlusion_morton_mxu`` (B12b), the reference's opt-in
  (``models/clusters._USE_MXU``): B1's and B2's functions with the
  quadratic's b and c0 - |o|^2 from a product of per-chunk A-matrices
  (``MortonAccel.mxu_a``) and the rays at the reference's
  ``DRTS_MXU_PREC`` (one, three or six bf16 products: MXU_PRODUCTS), on
  the tensor cores. Their results differ from B1's and B2's near grazing
  (at "default", by the single pass's rounding, far from it too).
- ``intersect_clustered`` replaces
  ``intersect_pallas.intersect_clustered_planar`` (B13): closest hit over
  a ClusteredAccel, a bound test per cluster and a sweep of its member
  slots; exact t, the first minimum within a cluster, clusters merged in
  plan order by a strict <.

What bounds them on the H100: each ray-sphere pair costs ~25 float
operations and one IEEE sqrt against 32 bytes of ray read once per ray, so
the sweep is bound by instruction issue, not by memory bandwidth. The
design keeps one thread per ray, stages the table in shared memory (a
broadcast read per pair) and keeps the running best in registers, with no
atomics. B11 has no accel: a block of dead lanes skips the table, only
the spheres with r > 0 are staged and swept, and a pair whose
discriminant is not positive takes no root. B1 and B2 cull per lane: each
skips a chunk of the Morton table whose bound (``MortonAccel.bounds``) the
ray's segment passes farther than a margin that covers rounding, and
sweeps only a chunk's filled slots. B1's segment ends at the hit it
already holds (the largest t that truncates to its packed best), and its
margin holds on the half-line of a ray with tmax = inf (the cull that B5
shares: ``segment_cull``, ``segment_misses``); B2 leaves at its first
blocker. No skip or cull changes a bit of the result (``csrc/intersect.cu``
and ``csrc/rays.cuh`` state the margins). B12a and B12b run the product
for a warp's 32 rays and cull chunks per warp, with B1's and B2's tests
and a margin that covers the product's rounding (MXU_CULL_SCALE, per
precision); B13
sweeps a cluster's members for a warp where any lane touches its bound,
up to the cluster's filled count (``clustered_filled``). B12a and B13 run
on a persistent grid whose blocks stage the table or plan once (up to
92 KB; a larger one in tiles per block of rays), and B12a folds each
ray's pairs in that ray's own lane.
``closest_chunk_walk``, ``mxu_chunk_walk`` and ``mxu_occlusion_walk``
repeat B1's, B12a's and B12b's walks, and ``intersect_morton_work``,
``intersect_brute_work``, ``occlusion_morton_work``,
``intersect_morton_mxu_work``, ``occlusion_morton_mxu_work`` and
``intersect_clustered_work`` count the chunk or cluster tests, pairs and
roots that the kernels need, with their own culls, for the bounds of
``chip_smoke.py``.

Dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the kernel, or the wrapper raises. There is
no fallback. Each wrapper counts its kernel launches in
``backend.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .. import backend

INF_BITS = 0x7F800000  # bit pattern of +inf: the packed miss


def pos_bits(n_cols: int) -> int:
    """Mantissa bits that carry the object id in the packed t|obj word."""
    return max(1, (n_cols - 1).bit_length())


def _check(name, x, rows, dtype=torch.float32):
    if x.dtype != dtype or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, N) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_pair(rays, table, table_rows, ray_rows=8):
    _check("rays", rays, ray_rows)
    _check("table", table, table_rows)
    if rays.device != table.device:
        raise ValueError(f"rays on {rays.device}, table on {table.device}")
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")
    if table.shape[1] < 1:
        raise ValueError("empty sphere table")


def _ray_rows(rays):
    ox, oy, oz, dx, dy, dz, tmin, tmax = (r[:, None] for r in rays)
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    return ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo


def _blocks(n, cols, block):
    """Ray blocks for the plain sweeps: (block, cols) temporaries."""
    step = max(1, min(block, (1 << 24) // cols))
    return range(0, n, step), step


# ----------------------------------------------------------------------------
# B1: Morton-table closest hit, packed min


def closest_pairs(rays, table, trunc):
    """B1's pair test of each ray x table column, in the kernel's
    operations and order: (packed (N, cols) int32, root (N, cols) bool).
    packed is the word (truncated t bits | object id), INF_BITS where the
    column is not hit in [tmin, tmax]; root is true where the
    discriminant is not negative, the pairs for which the kernel takes the
    root. ``trunc`` masks the t bits of the whole table's packing
    (pos_bits of its columns)."""
    cx, cy, cz, _, obj, m2x, m2y, m2z, ccrr = (c[None, :] for c in table)
    ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = _ray_rows(rays)
    b2 = od - (cx * dx + cy * dy + cz * dz)
    c2 = oo + (m2x * ox + m2y * oy + m2z * oz) + ccrr
    return _packed_tail(b2, c2, tmin, tmax, obj, trunc)


def _packed_tail(b2, c2, tmin, tmax, obj, trunc):
    """The closest-hit tail of the Morton kernels (B1, B12a;
    ``intersect_pallas._slim_tail``): (packed, root) as closest_pairs
    returns them, from the quadratic's b2 and c2."""
    disc = b2 * b2 - c2
    sq = torch.sqrt(disc)                      # NaN when the ray misses
    t_near = -b2 - sq
    t = torch.where(t_near >= tmin, t_near, sq - b2)
    ok = (t >= tmin) & (t <= tmax)             # NaN t fails both
    ti = (t.view(torch.int32) & trunc) | obj.to(torch.int32)
    return torch.where(ok, ti, INF_BITS), ~(disc < 0)


def intersect_morton_plain(rays, table, bounds=None, block: int = 16384):
    """Plain PyTorch B1: the unculled packed-min sweep. rays (8, N)
    [ox oy oz dx dy dz tmin tmax] with tmin >= 0; table (9, cols)
    [cx cy cz r obj -2cx -2cy -2cz |c|^2-r^2]. Returns t (N,) float32,
    truncated down to the packed precision, and obj (N,) int32.
    ``bounds`` is ignored: the kernel's culls do not change the result,
    which this computes from the table alone."""
    n, cols = rays.shape[1], table.shape[1]
    trunc = ~((1 << pos_bits(cols)) - 1)
    packed = torch.empty(n, dtype=torch.int32, device=rays.device)
    starts, step = _blocks(n, cols, block)
    for s in starts:
        packed[s:s + step] = closest_pairs(rays[:, s:s + step], table,
                                           trunc)[0].amin(dim=1)
    return (packed & trunc).view(torch.float32), packed & ~trunc


def segment_cull(rays, scale=None):
    """The per-lane terms of the half-line chunk cull that B1, B5 and
    B12a share (csrc/rays.cuh states it and its margin), in its operations
    and order: (inv_dd, m_o, slope), each (N,). ``scale`` is the rounding
    margin, CULL_SCALE by default."""
    scale = CULL_SCALE if scale is None else scale
    ox, oy, oz, dx, dy, dz = rays[:6]
    dd = dx * dx + dy * dy + dz * dz
    o1 = ox.abs() + oy.abs() + oz.abs()
    dev = (dd - 1.0).abs()
    slope = torch.where(dev <= 2.0 ** -8,
                        1.125 * (torch.sqrt(dev) + scale), float("inf"))
    return 1.0 / dd, scale * o1, slope


def cull_spheres(bounds, scale=None):
    """(4, n_chunks) chunk spheres as the cull reads them: centre and
    R + scale (|C|_1 + R), from the first four rows of `bounds`; ``scale``
    is CULL_SCALE by default."""
    scale = CULL_SCALE if scale is None else scale
    bx, by, bz, br = bounds[:4]
    return torch.stack([bx, by, bz, br + scale * (
        bx.abs() + by.abs() + bz.abs() + br)])


def segment_end(tmax, best, trunc):
    """The cull's segment end: tmax, or min(tmax, top(best)) once the
    packed best holds a key, top(best) being the largest float whose
    truncated bits equal the best's."""
    hit = (best >= 0) & (best < INF_BITS)
    top = ((best & trunc) | ~trunc).view(torch.float32)
    return torch.where(hit, torch.fmin(tmax, top), tmax)


def segment_misses(rays, cull, sphere, t_end):
    """(N,) bool: the segment [tmin, t_end] of each ray passes farther than
    the margin from `sphere` (one column of cull_spheres): the lane skips
    the chunk."""
    ox, oy, oz, dx, dy, dz, tmin = rays[:7]
    inv_dd, m_o, slope = cull
    vx, vy, vz = sphere[0] - ox, sphere[1] - oy, sphere[2] - oz
    vd = vx * dx + vy * dy + vz * dz
    s_star = vd * inv_dd
    s = torch.fmin(torch.fmax(s_star, tmin), t_end)
    wx, wy, wz = vx - s * dx, vy - s * dy, vz - s * dz
    e = sphere[3] + m_o
    lim = e + slope * (s_star.abs() + e)
    return wx * wx + wy * wy + wz * wz > lim * lim


def closest_chunk_walk(rays, table, bounds):
    """B1's kernel walk, lane by lane in its operations and order: chunks
    in table order, each tested against the ray's segment [tmin, t_end]
    (t_end = tmax, then min(tmax, top(best)) once the packed best holds a
    hit; csrc/intersect.cu states the cull and its margin), and a met
    chunk's filled slots folded into the best. Returns (met (N, n_chunks)
    bool, the packed best (N,) int32, roots (N,) int64: the swept pairs
    whose discriminant is not negative). Dead lanes meet nothing."""
    n, cols = rays.shape[1], table.shape[1]
    chunk = _check_bounds(table, bounds)
    trunc = ~((1 << pos_bits(cols)) - 1)
    live = rays[7] >= rays[6]
    cull = segment_cull(rays)
    spheres = cull_spheres(bounds)
    count = torch.clamp(bounds[4].to(torch.int64), 0, chunk).tolist()
    best = torch.full((n,), INF_BITS, dtype=torch.int32, device=rays.device)
    met = torch.zeros((n, len(count)), dtype=torch.bool, device=rays.device)
    roots = torch.zeros(n, dtype=torch.int64, device=rays.device)
    for k, cnt in enumerate(count):
        t_end = segment_end(rays[7], best, trunc)
        met[:, k] = ~segment_misses(rays, cull, spheres[:, k], t_end) & live
        if cnt:
            c0 = k * chunk
            pk, root = closest_pairs(rays, table[:, c0:c0 + cnt], trunc)
            best = torch.where(met[:, k], torch.minimum(best, pk.amin(1)),
                               best)
            roots += root.sum(1) * met[:, k]
    return met, best, roots


def intersect_morton_work(rays, table, bounds, block: int = 16384):
    """The work B1's kernel needs on these rays, in its visit order (see
    closest_chunk_walk): per ray, (chunk tests, chunks met, pairs swept,
    roots taken), each int64 (N,). A live ray tests every chunk, sweeps
    the filled slots of each chunk it meets and takes the root of each
    swept pair whose discriminant is not negative; dead lanes do
    nothing."""
    n = rays.shape[1]
    chunk = _check_bounds(table, bounds)
    count = torch.clamp(bounds[4].to(torch.int64), 0, chunk)
    out = [torch.zeros(n, dtype=torch.int64, device=rays.device)
           for _ in range(4)]
    starts, step = _blocks(n, chunk, block)
    for s in starts:
        r = rays[:, s:s + step]
        met, _, roots = closest_chunk_walk(r, table, bounds)
        out[0][s:s + step] = torch.where(r[7] >= r[6], bounds.shape[1], 0)
        out[1][s:s + step] = met.sum(1)
        out[2][s:s + step] = met.mul(count).sum(1)
        out[3][s:s + step] = roots
    return tuple(out)


def intersect_morton(rays, table, bounds, block: int = 16384):
    """B1 closest hit; see intersect_morton_plain for the contract. bounds
    (5, n_chunks) is ``MortonAccel.bounds`` for ``table``; the kernel culls
    chunks by it per lane. A CUDA tensor launches drts_morton_closest_hit
    (csrc/intersect.cu)."""
    _check_pair(rays, table, 9)
    _check_bounds(table, bounds)
    if rays.device.type == "cpu":
        return intersect_morton_plain(rays, table, bounds, block)
    lib = backend.kernels()
    n, cols = rays.shape[1], table.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    obj = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_morton_closest_hit(rays.data_ptr(), n, table.data_ptr(),
                                     cols, bounds.data_ptr(),
                                     bounds.shape[1], CULL_SCALE,
                                     pos_bits(cols), t.data_ptr(),
                                     obj.data_ptr(),
                                     backend.stream_handle(rays))
    backend.check_launch(rc, "drts_morton_closest_hit")
    backend.launched("intersect_morton")
    return t, obj


# ----------------------------------------------------------------------------
# B11: brute-force closest hit


def intersect_brute_plain(rays, spheres, block: int = 16384):
    """Plain PyTorch B11: masked argmin over all spheres. rays (8, N);
    spheres (4, K) [cx cy cz r], padded entries r = 0. Returns t (N,)
    float32 exact (inf on miss) and the sphere index (N,) int32 (0 on
    miss); ties go to the lowest index."""
    n, k = rays.shape[1], spheres.shape[1]
    cx, cy, cz, r = (c[None, :] for c in spheres)
    cc = cx * cx + cy * cy + cz * cz - r * r
    t_out = torch.empty(n, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(n, dtype=torch.int32, device=rays.device)
    starts, step = _blocks(n, k, block)
    for s in starts:
        ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = _ray_rows(
            rays[:, s:s + step])
        b = od - (cx * dx + cy * dy + cz * dz)
        c0 = oo - 2.0 * (cx * ox + cy * oy + cz * oz) + cc
        disc = b * b - c0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_near = -b - sq
        t = torch.where(t_near >= tmin, t_near, -b + sq)
        valid = (disc > 0.0) & (t >= tmin) & (t <= tmax) & (r > 0.0)
        t = torch.where(valid, t, float("inf"))
        best_t, best_i = torch.min(t, dim=1)   # first index among ties
        t_out[s:s + step] = best_t
        i_out[s:s + step] = best_i.to(torch.int32)
    return t_out, i_out


def intersect_brute_work(rays, spheres, block: int = 16384):
    """The work B11's kernel needs on these rays: per ray, (pairs swept,
    roots taken), each int64 (N,). A live ray sweeps every sphere with
    r > 0 (the kernel stages only those) and takes the root of each whose
    discriminant is positive; dead lanes do nothing."""
    n = rays.shape[1]
    cx, cy, cz, r = (c[None, :] for c in spheres)
    keep = r > 0.0
    cc = cx * cx + cy * cy + cz * cz - r * r
    pairs = torch.zeros(n, dtype=torch.int64, device=rays.device)
    roots = torch.zeros_like(pairs)
    starts, step = _blocks(n, spheres.shape[1], block)
    for s in starts:
        ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = _ray_rows(
            rays[:, s:s + step])
        b = od - (cx * dx + cy * dy + cz * dz)
        c0 = oo - 2.0 * (cx * ox + cy * oy + cz * oz) + cc
        live = (tmax >= tmin)[:, 0]
        pairs[s:s + step] = torch.where(live, int(keep.sum()), 0)
        roots[s:s + step] = ((b * b - c0 > 0.0) & keep).sum(1) * live
    return pairs, roots


def intersect_brute(rays, spheres, block: int = 16384):
    """B11 closest hit; see intersect_brute_plain for the contract. A CUDA
    tensor launches drts_brute_closest_hit (csrc/intersect.cu)."""
    _check_pair(rays, spheres, 4)
    if rays.device.type == "cpu":
        return intersect_brute_plain(rays, spheres, block)
    lib = backend.kernels()
    n, k = rays.shape[1], spheres.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    idx = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_brute_closest_hit(rays.data_ptr(), n, spheres.data_ptr(),
                                    k, t.data_ptr(), idx.data_ptr(),
                                    backend.stream_handle(rays))
    backend.check_launch(rc, "drts_brute_closest_hit")
    backend.launched("intersect_brute")
    return t, idx


# ----------------------------------------------------------------------------
# B2: Morton-table any-hit occlusion


def occlusion_morton_plain(rays9, table, bounds=None, block: int = 16384):
    """Plain PyTorch B2: rays9 (9, N) [ox oy oz dx dy dz tmin tmax
    exclude_obj] (exclude -1 = none); table (9, cols) as B1. Returns
    occluded (N,) bool: some column has t in [tmin, tmax] and an object id
    other than the ray's excluded one. Dead lanes (tmax < tmin) are never
    occluded. ``bounds`` is ignored: the kernel's culls do not change the
    result, which this computes from the table alone."""
    n, cols = rays9.shape[1], table.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=rays9.device)
    starts, step = _blocks(n, cols, block)
    for s in starts:
        occ[s:s + step] = occlusion_pair_blocked(rays9[:, s:s + step],
                                                 table).any(1)
    return occ


def occlusion_pair_blocked(rays9, table):
    """(N, cols) bool: the table column blocks the ray (B2's pair test, in
    the kernel's operations and order; dead lanes block nothing)."""
    cx, cy, cz, _, obj, m2x, m2y, m2z, ccrr = (c[None, :] for c in table)
    ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = _ray_rows(rays9[:8])
    exclude = rays9[8, :, None]
    b2 = od - (cx * dx + cy * dy + cz * dz)
    c2 = oo + (m2x * ox + m2y * oy + m2z * oz) + ccrr
    sq = torch.sqrt(b2 * b2 - c2)              # NaN when the ray misses
    t_near = -b2 - sq
    t = torch.where(t_near >= tmin, t_near, sq - b2)
    return (t >= tmin) & (t <= tmax) & (obj != exclude)


# Rounding margin of the chunk culls of B1, B2 and B5
# (ops/trimesh_kernels.py), relative to S = |o|_1 + |C|_1 + R + T, where T
# bounds |t| of a root: max(|tmin|, |tmax|) for B2, 1.125 (|s*| + e) for
# B1 and B5 (csrc/intersect.cu and csrc/rays.cuh state the culls).
# The wrappers pass it to the kernels, and the walks (occlusion_chunk_met,
# segment_cull, cull_spheres) read it, so each cull runs with this one
# value. A computed root t of the quadratic lies at most sqrt(E) from its
# sphere's surface, E <= 32 u S^2 with u = 2^-24 (the rounding of od, oo,
# the -2c.o term, |c|^2-r^2, b2^2 - c2, the sqrt and t), so
# sqrt(E) <= 2^-9.5 S; 2^-8 S also covers the rounding of the covering
# radius (the refit's, or make_inst_tables' float32 max(d + r) + 1e-5,
# a few ulp of R) and the cull test's.
CULL_SCALE = 2.0 ** -8


def _check_bounds(table, bounds):
    _check("bounds", bounds, 5)
    n_chunks = bounds.shape[1]
    if bounds.device != table.device:
        raise ValueError(f"bounds on {bounds.device}, table on "
                         f"{table.device}")
    if n_chunks < 1 or table.shape[1] % n_chunks:
        raise ValueError(f"{n_chunks} chunk bounds do not divide "
                         f"{table.shape[1]} table columns")
    return table.shape[1] // n_chunks


def occlusion_chunk_met(rays9, bounds, scale=None):
    """(N, n_chunks) bool: B2's chunk cull (B12b's with mxu_cull_scale())
    lets the chunk through for the ray (its segment passes within the
    chunk's bound plus the margins), in the kernel's operations and
    order; ``scale`` is CULL_SCALE by default. Dead lanes meet nothing."""
    scale = CULL_SCALE if scale is None else scale
    ox, oy, oz, dx, dy, dz, tmin, tmax = (r[:, None] for r in rays9[:8])
    bx, by, bz, br = (b[None, :] for b in bounds[:4])
    m_k = br + scale * (bx.abs() + by.abs() + bz.abs() + br)
    dd = dx * dx + dy * dy + dz * dz
    o1 = ox.abs() + oy.abs() + oz.abs()
    big_t = torch.fmax(tmin.abs(), tmax.abs())
    m_r = torch.where((dd >= 0.5) & (dd <= 2.0),
                      big_t * torch.sqrt((dd - 1.0).abs())
                      + scale * (o1 + big_t), float("inf"))
    inv_dd = 1.0 / dd
    vx, vy, vz = bx - ox, by - oy, bz - oz
    vd = vx * dx + vy * dy + vz * dz
    s = torch.fmin(torch.fmax(vd * inv_dd, tmin), tmax)
    wx, wy, wz = vx - s * dx, vy - s * dy, vz - s * dz
    lim = m_k + m_r
    met = ~(wx * wx + wy * wy + wz * wz > lim * lim)
    return met & (tmax >= tmin)


def occlusion_morton_work(rays9, table, bounds, block: int = 16384):
    """The work B2's kernel needs on these rays, in its visit order: per
    ray, (chunk tests, chunks met, pairs swept), each int64 (N,). A live
    ray tests chunks in table order up to and including the one that holds
    its first blocker (all of them where none blocks) and sweeps the
    filled slots of each chunk it meets, up to and including the blocker
    (the kernel tests slots four at a time, so it may test up to three
    more). Dead lanes do nothing."""
    n = rays9.shape[1]
    chunk = _check_bounds(table, bounds)
    n_chunks = bounds.shape[1]
    count = torch.clamp(bounds[4].to(torch.int64), 0, chunk)
    filled = (torch.arange(chunk, device=table.device)[None, :]
              < count[:, None]).reshape(-1)
    out = [torch.zeros(n, dtype=torch.int64, device=rays9.device)
           for _ in range(3)]
    starts, step = _blocks(n, table.shape[1], block)
    for s in starts:
        r = rays9[:, s:s + step]
        met = occlusion_chunk_met(r, bounds)
        hit = (occlusion_pair_blocked(r, table) & filled
               & met.repeat_interleave(chunk, dim=1))
        blocked = hit.any(1)
        first = torch.where(blocked, hit.to(torch.uint8).argmax(1),
                            hit.shape[1] - 1)
        last = (first // chunk)[:, None]   # the last chunk tested
        k = torch.arange(n_chunks, device=r.device)[None, :]
        pairs = (met & (k < last)).mul(count).sum(1) + torch.where(
            blocked, first % chunk + 1, met[:, -1] * count[-1])
        live = r[7] >= r[6]
        out[0][s:s + step] = torch.where(live, last[:, 0] + 1, 0)
        out[1][s:s + step] = (met & (k <= last)).sum(1)
        out[2][s:s + step] = torch.where(live, pairs, 0)
    return tuple(out)


def occlusion_morton(rays9, table, bounds, block: int = 16384):
    """B2 any-hit; see occlusion_morton_plain for the contract. bounds
    (5, n_chunks) is ``MortonAccel.bounds`` for ``table``. A CUDA tensor
    launches drts_morton_occlusion (csrc/intersect.cu)."""
    _check_pair(rays9, table, 9, ray_rows=9)
    _check_bounds(table, bounds)
    if rays9.device.type == "cpu":
        return occlusion_morton_plain(rays9, table, bounds, block)
    lib = backend.kernels()
    n, cols = rays9.shape[1], table.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=rays9.device)
    rc = lib.drts_morton_occlusion(rays9.data_ptr(), n, table.data_ptr(),
                                   cols, bounds.data_ptr(), bounds.shape[1],
                                   CULL_SCALE, occ.data_ptr(),
                                   backend.stream_handle(rays9))
    backend.check_launch(rc, "drts_morton_occlusion")
    backend.launched("occlusion_morton")
    return occ


# ----------------------------------------------------------------------------
# B12a / B12b: the Morton kernels with b and c0 - |o|^2 from a product of
# bf16 parts on the tensor cores

# The reference's DRTS_MXU_PREC (drts_tpu/ops/intersect_pallas.py:47-76),
# read at import as it reads it: "default", "high" (the shipping value) or
# "highest". Its TPU semantics for float32 operands, and the port's
# product Y = A X (A the (2*chunk, 8) chunk matrices, X = [d, o, o.d, 1]):
#
#   default  XLA's DEFAULT: one bf16 pass with float32 sums. Each operand
#            as hi = bf16(x); the product hi.hi.
#   high     built by hand in the reference (bf16x3): hi and lo =
#            bf16(x - hi); (hi.hi + hi.lo) + lo.hi.
#   highest  XLA's HIGHEST (bf16x6): hi, mid = bf16(x - hi) and lo =
#            bf16(x - hi - mid); the six products hi.hi, hi.mid, mid.hi,
#            hi.lo, mid.mid, lo.hi (mid.lo, lo.mid and lo.lo dropped),
#            added smallest first: ((((lo.hi + hi.lo) + mid.mid) + mid.hi)
#            + hi.mid) + hi.hi.
#
# Each product is a K = 8 sum of exact bf16 x bf16 terms with float32
# accumulation, its own matmul here and its own mma.sync on the card, and
# the products are added in float32 in MXU_PRODUCTS' order by both. On the
# CPU the reference's interpret mode runs both DEFAULT and HIGHEST as a
# plain float32 dot, so its CPU run shows neither TPU rounding.
MXU_PREC = os.environ.get("DRTS_MXU_PREC", "high")

# Per precision: the bf16 parts of each operand's split, and the products
# as (part of A, part of X) in the order they are added (0 = hi, 1 = lo at
# "high" and mid at "highest", 2 = lo at "highest").
MXU_PARTS = {"default": 1, "high": 2, "highest": 3}
MXU_PRODUCTS = {
    "default": ((0, 0),),
    "high": ((0, 0), (0, 1), (1, 0)),
    "highest": ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)),
}

# Rounding margin of B12a's and B12b's chunk culls per precision, in the
# form and the place of CULL_SCALE (S = |o|_1 + |C|_1 + R + T). Every
# product of bf16 parts is exact in float32, so the product's error has two
# sources. The split: the part of each term a_k x_k that the kept products
# leave out, relative to |a_k x_k| (a bf16 rounding errs by at most 2^-8
# of its operand). The K = 8 sums: each product runs as its own mma,
# whose sum IEEE does not specify, so the bound takes the worst of any
# order, truncation and no guard bit: each of an mma's 9 addends (8
# products and the zero accumulator) and its final rounding err by at most
# 2^-23 of the sum of the magnitudes, 10 2^-23 for hi.hi (every other
# product's magnitudes are at most 2^-8 of it) and, with the float32 adds
# of the products, < 2^-19.5 of sum |a_k x_k| in all (measured on an H100
# at "high": 2^-22.2; PERF.md). With eps the product's error
# relative to sum |a_k x_k|, and sum |a_k x_k| <= S for b and <= 2 S^2 for
# c0 - |o|^2, the discriminant is off by 2 |b| eps S + 2 eps S^2 <=
# 4 eps S^2 and, with f32's own rounding of the tail (32 u S^2, u =
# 2^-24), by E; a computed root's point lies within sqrt(E) of its sphere,
# which the margin covers with the cull test's own rounding:
#
#   high     lo leaves at most 2^-16 of x, so the split drops at most
#            3 2^-16 (1 + 2^-7) (lo.lo and the two parts' roundings);
#            eps < 2^-14.3, E < 2^-12.3 S^2, sqrt(E) < 2^-6.15 S: 2^-6.
#   highest  hi + mid + lo is x exactly (each part takes the next 8 of
#            float32's 24 bits), so the split drops only mid.lo + lo.mid +
#            lo.lo, at most 2^-23 (1 + 2^-7); eps < 2^-19.3, E < 2^-16.9
#            S^2, sqrt(E) < 2^-8.4 S: 2^-7, half of high's.
#   default  hi.hi drops at most (2 2^-8 + 2^-16) (1 + 2^-8); eps <
#            2^-6.98, E < 2^-4.97 S^2, sqrt(E) < 2^-2.48 S: 2^-2. At a
#            quarter of S every chunk's bound grows past the demo scene's
#            spacing: on its frame's primary rays a warp sweeps 99.95% of
#            the chunks at 2^-2 against 51% at "high"
#            (tests/test_torch_mxu_prec.py holds this at 96x54), so the cull
#            cuts next to nothing and this precision runs with it off: an
#            infinite margin, every chunk met and swept.
#
# The card tests and chip_smoke.py's phase 24 check each finite margin:
# with the cull off (an infinite margin) both kernels give every word they
# give with it.
MXU_CULL_SCALE = {"default": float("inf"), "high": 2.0 ** -6,
                  "highest": 2.0 ** -7}


def _check_mxu_prec(prec=None):
    prec = MXU_PREC if prec is None else prec
    if prec not in MXU_PARTS:
        raise ValueError(f"DRTS_MXU_PREC={prec!r}: the reference's MXU "
                         f"precisions are {tuple(MXU_PARTS)}")
    return prec


def mxu_cull_scale(prec=None):
    """The chunk cull's margin at the precision (MXU_PREC by default)."""
    return MXU_CULL_SCALE[_check_mxu_prec(prec)]


def mxu_products(prec=None):
    """The bf16 products (one mma each on the card) per swept (ray, slot)
    group at the precision: 1, 3 or 6."""
    return len(MXU_PRODUCTS[_check_mxu_prec(prec)])


def split_bf16(x, parts: int = 2):
    """float32 -> [hi, ...], `parts` bfloat16 values held in float32: each
    rounds (to nearest even) what the ones before it leave of x, as the
    reference's chain of ``astype(jnp.bfloat16)`` casts does (x - hi, then
    x - hi - mid, each exact in float32)."""
    out, rest = [], x
    for _ in range(parts):
        p = rest.to(torch.bfloat16).to(torch.float32)
        out.append(p)
        rest = rest - p
    return out


def mxu_product(a, x, prec=None):
    """(rows, 8) @ (8, N) at the reference's MXU precision `prec`
    (MXU_PREC by default; ``intersect_pallas._mxu_dot`` on the TPU): both
    operands split into MXU_PARTS[prec] bf16 parts, each product of
    MXU_PRODUCTS[prec] a float32 matmul of exact terms, the products added
    in float32 in that order ("high": (hi.hi + hi.lo) + lo.hi)."""
    prec = _check_mxu_prec(prec)
    a_p = split_bf16(a, MXU_PARTS[prec])
    x_p = split_bf16(x, MXU_PARTS[prec])
    (i, j), *rest = MXU_PRODUCTS[prec]
    y = a_p[i] @ x_p[j]
    for i, j in rest:
        y = y + a_p[i] @ x_p[j]
    return y


def mxu_coefficients(rays, mxu_a, chunk, prec=None):
    """The tensor-core kernels' quadratic per ray x table column: (b2, c2),
    each (N, cols), b2 from the A-matrices' b rows and c2 = the c rows'
    product + |o|^2, the product at `prec` (MXU_PREC by default). rays
    (8+, N) planar; mxu_a (n_chunks*2*chunk, 8)."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    x = torch.stack([dx, dy, dz, ox, oy, oz, od, torch.ones_like(ox)])
    y = mxu_product(mxu_a, x, prec).reshape(-1, 2, chunk, x.shape[1])
    b2 = y[:, 0].reshape(-1, x.shape[1]).T
    c2 = y[:, 1].reshape(-1, x.shape[1]).T + oo[:, None]
    return b2, c2


def _check_mxu(table, bounds, mxu_a):
    _check_mxu_prec()
    chunk = _check_bounds(table, bounds)
    if mxu_a is None:
        raise ValueError("the MXU route needs MortonAccel.mxu_a "
                         "(make_morton_accel under the opt-in, or "
                         "make_mxu_tables)")
    if (mxu_a.dtype != torch.float32 or mxu_a.dim() != 2
            or tuple(mxu_a.shape) != (2 * table.shape[1], 8)):
        raise ValueError(f"mxu_a must be ({2 * table.shape[1]}, 8) float32, "
                         f"got {tuple(mxu_a.shape)} {mxu_a.dtype}")
    if not mxu_a.is_contiguous() or mxu_a.device != table.device:
        raise ValueError("mxu_a must be contiguous, on the table's device")
    return chunk


def mxu_closest_pairs(rays, table, mxu_a, chunk, trunc, prec=None):
    """B12a's pair test of each ray x table column: the packed word
    (truncated t bits | object id), INF_BITS where the column is not hit
    in [tmin, tmax] (B1's tail, ``intersect_pallas._slim_tail``, on the
    product's b2 and c2 at `prec`, MXU_PREC by default). (N, cols)
    int32."""
    b2, c2 = mxu_coefficients(rays, mxu_a, chunk, prec)
    return _packed_tail(b2, c2, rays[6][:, None], rays[7][:, None],
                        table[4][None, :], trunc)[0]


def intersect_morton_mxu_plain(rays, table, bounds, mxu_a,
                               block: int = 16384):
    """Plain PyTorch B12a: the unculled packed-min sweep with b and
    c0 - |o|^2 from ``mxu_product`` at MXU_PREC. rays (8, N) with
    tmin >= 0; table and bounds as B1's; mxu_a (n_chunks*2*chunk, 8) from
    make_mxu_tables. Returns t (N,) float32, truncated down, and obj (N,)
    int32."""
    chunk = _check_mxu(table, bounds, mxu_a)
    n, cols = rays.shape[1], table.shape[1]
    trunc = ~((1 << pos_bits(cols)) - 1)
    packed = torch.empty(n, dtype=torch.int32, device=rays.device)
    starts, step = _blocks(n, 2 * cols, block)
    for s in starts:
        packed[s:s + step] = mxu_closest_pairs(
            rays[:, s:s + step], table, mxu_a, chunk, trunc).amin(dim=1)
    return (packed & trunc).view(torch.float32), packed & ~trunc


def _warp_any(x):
    """(N, ...) bool -> (N, ...) bool: any over each lane's warp of 32
    consecutive lanes (dimension 0)."""
    n = x.shape[0]
    pad = x.new_zeros(((-n) % 32,) + x.shape[1:])
    w = torch.cat([x, pad]).reshape(-1, 32, *x.shape[1:]).any(1)
    return w.repeat_interleave(32, dim=0)[:n]


def mxu_chunk_walk(rays, table, bounds, mxu_a):
    """B12a's kernel walk in PyTorch: chunks in table order; a lane meets a
    chunk as B1's lane does (closest_chunk_walk) but with the precision's
    margin (mxu_cull_scale);
    a warp of 32 consecutive lanes sweeps the chunk where any of its
    lanes meets it, and every lane of a sweeping warp folds the chunk's
    pairs (``mxu_closest_pairs``) into its packed best. Returns (met
    (N, n_chunks) bool, swept (N, n_chunks) bool: the lane's warp swept
    the chunk, the packed best (N,) int32)."""
    chunk = _check_mxu(table, bounds, mxu_a)
    n, cols = rays.shape[1], table.shape[1]
    trunc = ~((1 << pos_bits(cols)) - 1)
    live = rays[7] >= rays[6]
    scale = mxu_cull_scale()
    cull = segment_cull(rays, scale)
    spheres = cull_spheres(bounds, scale)
    pk = mxu_closest_pairs(rays, table, mxu_a, chunk, trunc)
    best = torch.full((n,), INF_BITS, dtype=torch.int32, device=rays.device)
    n_chunks = bounds.shape[1]
    met = torch.zeros((n, n_chunks), dtype=torch.bool, device=rays.device)
    swept = torch.zeros_like(met)
    for k in range(n_chunks):
        t_end = segment_end(rays[7], best, trunc)
        met[:, k] = ~segment_misses(rays, cull, spheres[:, k], t_end) & live
        swept[:, k] = _warp_any(met[:, k])
        c0 = k * chunk
        best = torch.where(swept[:, k], torch.minimum(
            best, pk[:, c0:c0 + chunk].amin(1)), best)
    return met, swept, best


def _slots_swept(bounds, chunk):
    """Per chunk, the slots a tensor-core kernel sweeps: its filled slots
    rounded up to whole groups of 8 spheres, (n_chunks,) int64."""
    count = torch.clamp(bounds[4].to(torch.int64), 0, chunk)
    return count, (count + 7) // 8 * 8


def intersect_morton_mxu_work(rays, table, bounds, mxu_a,
                              block: int = 32768):
    """The work B12a's kernel needs on these rays (see mxu_chunk_walk):
    per ray, (chunk tests, chunks met, chunks its warp swept, filled slots
    of the chunks it met, slots of the chunks its warp swept), each int64
    (N,), at MXU_PREC's margin. A live ray tests every chunk; dead lanes
    test none. The products and tails a lane needs at the least are the
    filled slots of the chunks it meets, each slot's product
    mxu_products() mmas (1, 3 or 6; chip_smoke.py's bound counts them);
    the kernel runs them for every lane of a sweeping warp, in groups of 8
    slots."""
    n = rays.shape[1]
    chunk = _check_mxu(table, bounds, mxu_a)
    count, groups = _slots_swept(bounds, chunk)
    out = [torch.zeros(n, dtype=torch.int64, device=rays.device)
           for _ in range(5)]
    step = max(32, block // 32 * 32)
    for s in range(0, n, step):
        r = rays[:, s:s + step]
        met, swept, _ = mxu_chunk_walk(r, table, bounds, mxu_a)
        out[0][s:s + step] = torch.where(r[7] >= r[6], bounds.shape[1], 0)
        out[1][s:s + step] = met.sum(1)
        out[2][s:s + step] = swept.sum(1)
        out[3][s:s + step] = met.mul(count).sum(1)
        out[4][s:s + step] = swept.mul(groups).sum(1)
    return tuple(out)


def intersect_morton_mxu(rays, table, bounds, mxu_a, block: int = 16384):
    """B12a closest hit; see intersect_morton_mxu_plain for the contract.
    A CUDA tensor launches drts_morton_mxu_closest_hit (csrc/intersect.cu),
    which runs the product on the tensor cores, culls chunks per warp by
    `bounds` with mxu_cull_scale() and folds each ray's pairs in its own
    lane, on a persistent grid that stages a table of up to 92 KB once per
    block. The kernel is built for each precision and takes MXU_PREC's
    parts."""
    _check_pair(rays, table, 9)
    _check_mxu(table, bounds, mxu_a)
    if rays.device.type == "cpu":
        return intersect_morton_mxu_plain(rays, table, bounds, mxu_a, block)
    lib = backend.kernels()
    n, cols = rays.shape[1], table.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    obj = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_morton_mxu_closest_hit(
        rays.data_ptr(), n, table.data_ptr(), cols, bounds.data_ptr(),
        bounds.shape[1], mxu_a.data_ptr(), MXU_PARTS[MXU_PREC],
        mxu_cull_scale(), pos_bits(cols), t.data_ptr(), obj.data_ptr(),
        backend.stream_handle(rays))
    backend.check_launch(rc, "drts_morton_mxu_closest_hit")
    backend.launched("intersect_morton_mxu")
    return t, obj


def _kernel_info(fn, name, *args) -> dict:
    out = (ctypes.c_int * 7)()
    backend.check_launch(fn(*args, out), name)
    return dict(zip(("registers", "local_bytes", "shared_bytes", "threads",
                     "blocks_per_sm", "grid", "resident"), out))


def intersect_morton_mxu_info(table, bounds, n: int) -> dict:
    """B12a's resources on the card for this table, n rays and MXU_PREC's
    build: registers and local (stack and spill) bytes per thread, shared
    bytes and threads per block, the blocks one SM holds at once, the
    persistent grid's blocks and whether the table's image is resident (1)
    or tiled (0)."""
    lib = backend.kernels()
    return _kernel_info(lib.drts_morton_mxu_closest_hit_info,
                        "drts_morton_mxu_closest_hit_info", table.shape[1],
                        bounds.shape[1], n, MXU_PARTS[_check_mxu_prec()])


def occlusion_morton_mxu_info(table, bounds, n: int) -> dict:
    """B12b's resources on the card, as intersect_morton_mxu_info's."""
    lib = backend.kernels()
    return _kernel_info(lib.drts_morton_mxu_occlusion_info,
                        "drts_morton_mxu_occlusion_info", table.shape[1],
                        bounds.shape[1], n, MXU_PARTS[_check_mxu_prec()])


def mxu_occlusion_pair_blocked(rays9, table, mxu_a, chunk, prec=None):
    """B12b's pair test, (N, cols) bool (``_anyhit_mxu_kernel``'s tail):
    the unguarded sqrt of the product's discriminant (NaN below 0), the
    near root unless it lies before tmin, blocked where t is in
    [tmin, tmax] and the column's object is not the ray's excluded one.
    The product at `prec` (MXU_PREC by default)."""
    b2, c2 = mxu_coefficients(rays9, mxu_a, chunk, prec)
    tmin, tmax, exclude = (r[:, None] for r in rays9[6:9])
    sq = torch.sqrt(b2 * b2 - c2)              # NaN when the ray misses
    t_near = -b2 - sq
    t = torch.where(t_near >= tmin, t_near, sq - b2)
    return (t >= tmin) & (t <= tmax) & (table[4][None, :] != exclude)


def occlusion_morton_mxu_plain(rays9, table, bounds, mxu_a,
                               block: int = 16384):
    """Plain PyTorch B12b: rays9 (9, N) [ox oy oz dx dy dz tmin tmax
    exclude_obj] (exclude -1 = none); table and bounds as B2's; mxu_a as
    B12a's; the product at MXU_PREC. Returns occluded (N,) bool: some
    column blocks the ray (``mxu_occlusion_pair_blocked``)."""
    chunk = _check_mxu(table, bounds, mxu_a)
    n, cols = rays9.shape[1], table.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=rays9.device)
    starts, step = _blocks(n, 2 * cols, block)
    for s in starts:
        occ[s:s + step] = mxu_occlusion_pair_blocked(
            rays9[:, s:s + step], table, mxu_a, chunk).any(1)
    return occ


def mxu_occlusion_walk(rays9, table, bounds, mxu_a):
    """B12b's kernel walk in PyTorch: chunks in table order while the
    lane's warp of 32 consecutive lanes holds an open lane (live, not yet
    blocked); an open lane meets a chunk as B2's lane does
    (occlusion_chunk_met) but with mxu_cull_scale(); the warp sweeps the
    chunk where any lane meets it, and a swept chunk's blocking pairs
    block its lanes. Returns (tested (N, n_chunks) bool: the lane was
    open and tested the chunk, swept (N, n_chunks) bool, occluded
    (N,) bool)."""
    chunk = _check_mxu(table, bounds, mxu_a)
    n = rays9.shape[1]
    live = rays9[7] >= rays9[6]
    met_all = occlusion_chunk_met(rays9, bounds, mxu_cull_scale())
    blocks = mxu_occlusion_pair_blocked(rays9, table, mxu_a, chunk)
    occ = torch.zeros(n, dtype=torch.bool, device=rays9.device)
    n_chunks = bounds.shape[1]
    tested = torch.zeros((n, n_chunks), dtype=torch.bool,
                         device=rays9.device)
    swept = torch.zeros_like(tested)
    for k in range(n_chunks):
        open_ = live & ~occ
        tested[:, k] = open_ & _warp_any(open_)
        swept[:, k] = _warp_any(met_all[:, k] & open_)
        c0 = k * chunk
        occ |= swept[:, k] & live & blocks[:, c0:c0 + chunk].any(1)
    return tested, swept, occ


def occlusion_morton_mxu_work(rays9, table, bounds, mxu_a,
                              block: int = 32768):
    """The work B12b's kernel needs on these rays (see mxu_occlusion_walk):
    per ray, (chunk tests, chunks met, chunks its warp swept, filled slots
    of the chunks it met, slots of the chunks its warp swept), each int64
    (N,), at MXU_PREC's margin and with its mxu_products() mmas a slot as
    intersect_morton_mxu_work's; a lane tests chunks while it is open."""
    n = rays9.shape[1]
    chunk = _check_mxu(table, bounds, mxu_a)
    count, groups = _slots_swept(bounds, chunk)
    out = [torch.zeros(n, dtype=torch.int64, device=rays9.device)
           for _ in range(5)]
    step = max(32, block // 32 * 32)
    for s in range(0, n, step):
        r = rays9[:, s:s + step]
        tested, swept, _ = mxu_occlusion_walk(r, table, bounds, mxu_a)
        met = tested & occlusion_chunk_met(r, bounds, mxu_cull_scale())
        out[0][s:s + step] = tested.sum(1)
        out[1][s:s + step] = met.sum(1)
        out[2][s:s + step] = swept.sum(1)
        out[3][s:s + step] = met.mul(count).sum(1)
        out[4][s:s + step] = swept.mul(groups).sum(1)
    return tuple(out)


def occlusion_morton_mxu(rays9, table, bounds, mxu_a, block: int = 16384):
    """B12b any hit; see occlusion_morton_mxu_plain for the contract. A
    CUDA tensor launches drts_morton_mxu_occlusion (csrc/intersect.cu):
    the product on the tensor cores, chunks culled per warp by `bounds`
    with mxu_cull_scale(), each ray's pairs tested in its own lane, a warp
    leaving once every lane is blocked, on B12a's persistent grid, built
    for each precision as B12a is."""
    _check_pair(rays9, table, 9, ray_rows=9)
    _check_mxu(table, bounds, mxu_a)
    if rays9.device.type == "cpu":
        return occlusion_morton_mxu_plain(rays9, table, bounds, mxu_a,
                                          block)
    lib = backend.kernels()
    n, cols = rays9.shape[1], table.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=rays9.device)
    rc = lib.drts_morton_mxu_occlusion(
        rays9.data_ptr(), n, table.data_ptr(), cols, bounds.data_ptr(),
        bounds.shape[1], mxu_a.data_ptr(), MXU_PARTS[MXU_PREC],
        mxu_cull_scale(), occ.data_ptr(), backend.stream_handle(rays9))
    backend.check_launch(rc, "drts_morton_mxu_occlusion")
    backend.launched("occlusion_morton_mxu")
    return occ


# ----------------------------------------------------------------------------
# B13: cluster-culled closest hit


def _check_clustered(rays, bounds_tbl, members_tbl, n_clusters,
                     max_members):
    _check("rays", rays, 8)
    _check("bounds_tbl", bounds_tbl, 4)
    if (members_tbl.dtype != torch.float32 or members_tbl.dim() != 2
            or members_tbl.shape[1] != 8 or not members_tbl.is_contiguous()):
        raise ValueError(f"members_tbl must be contiguous (C_pad*M, 8) "
                         f"float32, got {tuple(members_tbl.shape)}")
    if not 0 < n_clusters <= bounds_tbl.shape[1] or max_members < 1 or (
            members_tbl.shape[0] != bounds_tbl.shape[1] * max_members):
        raise ValueError(f"{n_clusters} clusters of {max_members} do not "
                         f"fit bounds {tuple(bounds_tbl.shape)} and "
                         f"members {tuple(members_tbl.shape)}")
    if not (rays.device == bounds_tbl.device == members_tbl.device):
        raise ValueError("rays, bounds_tbl and members_tbl must share a "
                         "device")
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")


def clustered_disc(rays, bounds_tbl, n_clusters):
    """(b, disc), each (N, n_clusters): the quadratic of the ray against
    each cluster's bounding sphere (the reference's per-cluster test,
    ``intersect_pallas._clustered_kernel``, in its operations and order)."""
    bx, by, bz, br = (b[None, :n_clusters] for b in bounds_tbl)
    ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = _ray_rows(rays)
    b = od - (bx * dx + by * dy + bz * dz)
    c0 = oo - 2.0 * (bx * ox + by * oy + bz * oz) \
        + (bx * bx + by * by + bz * bz - br * br)
    return b, b * b - c0


def clustered_touched(rays, bounds_tbl, n_clusters):
    """(N, n_clusters) bool: the ray's line meets the cluster's bounding
    sphere with an interval that overlaps [tmin, tmax] (the reference's
    per-cluster test, ``intersect_pallas._clustered_kernel``, in its
    operations and order); dead lanes touch nothing."""
    tmin, tmax = rays[6][:, None], rays[7][:, None]
    b, disc = clustered_disc(rays, bounds_tbl, n_clusters)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return ((disc > 0.0) & (-b - sq <= tmax) & (-b + sq >= tmin)
            & (tmax >= tmin))


def clustered_member_t(rays, members_tbl, n_slots):
    """(t (N, n_slots), disc2 > 0 (N, n_slots)) of each ray x member slot
    in the reference's operations and order: the hit t, inf where the slot
    is empty (r = 0), its discriminant is not positive or t leaves
    [tmin, tmax]."""
    cx, cy, cz, r = (c[None, :] for c in members_tbl[:n_slots, :4].T)
    ox, oy, oz, dx, dy, dz, tmin, tmax, od, oo = _ray_rows(rays)
    b2 = od - (cx * dx + cy * dy + cz * dz)
    c2 = oo - 2.0 * (cx * ox + cy * oy + cz * oz) \
        + (cx * cx + cy * cy + cz * cz - r * r)
    disc2 = b2 * b2 - c2
    sq2 = torch.sqrt(torch.clamp(disc2, min=0.0))
    t_near = -b2 - sq2
    t = torch.where(t_near >= tmin, t_near, -b2 + sq2)
    valid = (disc2 > 0.0) & (t >= tmin) & (t <= tmax) & (r > 0.0)
    return torch.where(valid, t, float("inf")), disc2 > 0.0


def intersect_clustered_plain(rays, bounds_tbl, members_tbl,
                              n_clusters: int, max_members: int,
                              block: int = 16384):
    """Plain PyTorch B13: every cluster's members swept, no cull. rays
    (8, N); bounds_tbl (4, C_pad); members_tbl (C_pad*M, 8)
    [cx cy cz r obj 0 0 0] (models/clusters.pack_for_kernel). Per cluster
    the first member at the least t, across clusters the first cluster
    at the least t (strict < in plan order). Returns t (N,) float32
    exact (inf on a miss) and obj (N,) int32 (0 on a miss).
    ``bounds_tbl`` is checked but not read: the kernel's cull changes no
    result."""
    _check_clustered(rays, bounds_tbl, members_tbl, n_clusters,
                     max_members)
    n, mm = rays.shape[1], max_members
    obj = members_tbl[:n_clusters * mm, 4].reshape(n_clusters, mm)
    t_out = torch.empty(n, dtype=torch.float32, device=rays.device)
    i_out = torch.empty(n, dtype=torch.int32, device=rays.device)
    starts, step = _blocks(n, n_clusters * mm, block)
    for s in starts:
        r = rays[:, s:s + step]
        t, _ = clustered_member_t(r, members_tbl, n_clusters * mm)
        chunk_t, arg = t.reshape(-1, n_clusters, mm).min(dim=2)
        best_t, best_c = chunk_t.min(dim=1)     # first cluster of the min
        chunk_obj = obj[best_c, arg.gather(1, best_c[:, None])[:, 0]]
        t_out[s:s + step] = best_t
        i_out[s:s + step] = torch.where(torch.isfinite(best_t), chunk_obj,
                                        0.0).to(torch.int32)
    return t_out, i_out


def clustered_filled(members_tbl, n_clusters: int, max_members: int):
    """(n_clusters,) int64: each cluster's filled count, the last member
    slot with r > 0 plus one (0 for a cluster with none). B13's kernel
    sweeps a cluster's slots up to it: the slots after it have r = 0 and
    never hit."""
    r = members_tbl[:n_clusters * max_members, 3].reshape(n_clusters,
                                                         max_members)
    pos = torch.arange(1, max_members + 1, device=members_tbl.device)
    return torch.where(r > 0.0, pos, 0).amax(1)


def intersect_clustered_work(rays, bounds_tbl, members_tbl,
                             n_clusters: int, max_members: int,
                             block: int = 32768):
    """The work B13's kernel needs on these rays: per ray, (cluster tests,
    cluster roots: the tests whose discriminant is positive, clusters
    touched, clusters its warp of 32 consecutive lanes swept, slots: the
    filled slots (``clustered_filled``) of the clusters it touches, roots:
    the slots among those whose discriminant is positive), each int64
    (N,). A live ray tests every cluster and needs the member sweep of the
    filled slots of each cluster it touches; the kernel sweeps a cluster
    for a whole warp where any lane touches it."""
    _check_clustered(rays, bounds_tbl, members_tbl, n_clusters,
                     max_members)
    n, mm = rays.shape[1], max_members
    filled = clustered_filled(members_tbl, n_clusters, mm)
    in_filled = (torch.arange(mm, device=rays.device)[None, :]
                 < filled[:, None])
    out = [torch.zeros(n, dtype=torch.int64, device=rays.device)
           for _ in range(6)]
    step = max(32, min(block, (1 << 24) // (n_clusters * mm)) // 32 * 32)
    for s in range(0, n, step):
        r = rays[:, s:s + step]
        touched = clustered_touched(r, bounds_tbl, n_clusters)
        swept = _warp_any(touched)
        _, pos = clustered_member_t(r, members_tbl, n_clusters * mm)
        roots = (pos.reshape(-1, n_clusters, mm) & in_filled).sum(2)
        live = r[7] >= r[6]
        out[0][s:s + step] = torch.where(live, n_clusters, 0)
        _, disc = clustered_disc(r, bounds_tbl, n_clusters)
        out[1][s:s + step] = ((disc > 0.0) & live[:, None]).sum(1)
        out[2][s:s + step] = touched.sum(1)
        out[3][s:s + step] = swept.sum(1)
        out[4][s:s + step] = (filled * touched).sum(1)
        out[5][s:s + step] = (roots * touched).sum(1)
    return tuple(out)


def intersect_clustered(rays, bounds_tbl, members_tbl, n_clusters: int,
                        max_members: int, block: int = 16384):
    """B13 closest hit; see intersect_clustered_plain for the contract. A
    CUDA tensor launches drts_clustered_closest_hit (csrc/intersect.cu):
    a persistent grid whose blocks stage the plan in shared memory (once,
    where it fits in 92 KB), each member sweep stopping at the cluster's
    filled count (``clustered_filled``). members_tbl must be 16-byte
    aligned, as every table the allocator gives is."""
    _check_clustered(rays, bounds_tbl, members_tbl, n_clusters,
                     max_members)
    if rays.device.type == "cpu":
        return intersect_clustered_plain(rays, bounds_tbl, members_tbl,
                                         n_clusters, max_members, block)
    lib = backend.kernels()
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    obj = torch.empty(n, dtype=torch.int32, device=rays.device)
    rc = lib.drts_clustered_closest_hit(
        rays.data_ptr(), n, bounds_tbl.data_ptr(), bounds_tbl.shape[1],
        members_tbl.data_ptr(), n_clusters, max_members, t.data_ptr(),
        obj.data_ptr(), backend.stream_handle(rays))
    backend.check_launch(rc, "drts_clustered_closest_hit")
    backend.launched("intersect_clustered")
    return t, obj


def intersect_clustered_info(n_clusters: int, max_members: int,
                             n: int) -> dict:
    """B13's resources on the card for a plan of ``n_clusters`` clusters of
    ``max_members`` slots and n rays (as intersect_morton_mxu_info)."""
    lib = backend.kernels()
    return _kernel_info(lib.drts_clustered_closest_hit_info,
                        "drts_clustered_closest_hit_info", n_clusters,
                        max_members, n)
