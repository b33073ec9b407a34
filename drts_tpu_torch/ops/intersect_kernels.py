"""The ray-sphere kernels of the port: wrappers, plain versions, counters.

Counterpart of ``drts_tpu/ops/intersect_pallas.py``. Three TPU kernels are
on the port's paths so far, and each becomes a CUDA C++ kernel for Hopper
in ``csrc/intersect.cu``:

- ``intersect_morton`` replaces ``intersect_pallas.intersect_morton_planar``
  (B1): closest hit over a Morton-ordered sphere table, reduced as the min
  of a packed int32 (truncated t bits | object id).
- ``intersect_brute`` replaces ``intersect_pallas.intersect_spheres_planar``
  (B11): brute-force closest hit over all spheres; smallest t wins, the
  lowest index on ties.
- ``occlusion_morton`` replaces ``intersect_pallas.occlusion_morton_planar``
  (B2): the any-hit shadow ray over B1's table, with one excluded object
  per ray (the target light). It also serves ``occlusion_morton_mxu``
  (B12b), which computes the same function.

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
and ``csrc/rays.cuh`` state the margins). ``closest_chunk_walk``
repeats B1's walk lane by lane, and ``intersect_morton_work``,
``intersect_brute_work`` and ``occlusion_morton_work`` count the chunk
tests, pairs and roots that B1, B11 and B2 need, with the kernels' own
culls, for the bounds of ``chip_smoke.py``.

Dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
version; a CUDA tensor launches the kernel, or the wrapper raises. There is
no fallback. Each wrapper counts its kernel launches in
``backend.LAUNCHES``.
"""

from __future__ import annotations

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


def segment_cull(rays):
    """The per-lane terms of the half-line chunk cull that B1 and B5 share
    (csrc/rays.cuh states it and its margin), in its operations
    and order: (inv_dd, m_o, slope), each (N,)."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    dd = dx * dx + dy * dy + dz * dz
    o1 = ox.abs() + oy.abs() + oz.abs()
    dev = (dd - 1.0).abs()
    slope = torch.where(dev <= 2.0 ** -8,
                        1.125 * (torch.sqrt(dev) + CULL_SCALE), float("inf"))
    return 1.0 / dd, CULL_SCALE * o1, slope


def cull_spheres(bounds):
    """(4, n_chunks) chunk spheres as the cull reads them: centre and
    R + CULL_SCALE (|C|_1 + R), from the first four rows of `bounds`."""
    bx, by, bz, br = bounds[:4]
    return torch.stack([bx, by, bz, br + CULL_SCALE * (
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


def occlusion_chunk_met(rays9, bounds):
    """(N, n_chunks) bool: B2's chunk cull lets the chunk through for the
    ray (its segment passes within the chunk's bound plus the margins),
    in the kernel's operations and order. Dead lanes meet nothing."""
    ox, oy, oz, dx, dy, dz, tmin, tmax = (r[:, None] for r in rays9[:8])
    bx, by, bz, br = (b[None, :] for b in bounds[:4])
    m_k = br + CULL_SCALE * (bx.abs() + by.abs() + bz.abs() + br)
    dd = dx * dx + dy * dy + dz * dz
    o1 = ox.abs() + oy.abs() + oz.abs()
    big_t = torch.fmax(tmin.abs(), tmax.abs())
    m_r = torch.where((dd >= 0.5) & (dd <= 2.0),
                      big_t * torch.sqrt((dd - 1.0).abs())
                      + CULL_SCALE * (o1 + big_t), float("inf"))
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
