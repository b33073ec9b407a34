"""The culled walks of B5 (``trimesh_kernels.bound_scan_walk``) and the work
counts of B5 and B11, on the CPU.

The CUDA kernels of B5 and B11 skip work that cannot change their result:
B5 culls the instance table's chunks per lane by their covering spheres
(the half-line cull of B1, ``csrc/rays.cuh``), and B11 skips rows
of radius 0 and the root of every missed row. ``bound_scan_walk`` repeats
B5's walk lane by lane in the kernel's operations and order; here it is
held to the unculled plain version, which tests/test_torch_trimesh.py
holds to the reference's Pallas kernel. The kernels themselves are held to
the walks and the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Inputs, from numpy seeds: tests/test_torch_trimesh.py's hard scene (a
giant ground-like instance whose bound holds most origins, half the rays
spawned on instance surfaces) at 5, 24, 48 and 438 instances, tables from
``make_inst_tables``; and hand cases: rays tangent to the member spheres
that touch their chunk's covering sphere, from near and from far, origins
inside covering spheres, tmax = inf, dead lanes and a last chunk that is
mostly padding.

Tolerance 0 throughout: the walk must give the plain version's keys bit for
bit, and the work counts must equal direct counts.
"""

import numpy as np
import pytest
import torch

from drts_tpu_torch.ops import intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik
from drts_tpu_torch.ops import trimesh_kernels as tk

T = torch.from_numpy


def unit_rows(rng, n, cols):
    v = rng.randn(n, cols)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def hard_scene(seed, k, n=2048):
    """tests/test_torch_trimesh.py's hard scene, as TLAS tables and rays:
    every 7th lane dead, every other live lane with tmax = inf."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(k, 3).astype(np.float32) * 6
    scale = (0.4 + rng.rand(k) * 1.4).astype(np.float32)
    pos[0] = [0.0, -100.0, 0.0]
    scale[0] = 99.0
    rot = unit_rows(rng, k, 4)
    o = rng.randn(n, 3).astype(np.float32) * 8
    half = n // 2
    which = rng.randint(0, k, half)
    o[:half] = (pos[which] + unit_rows(rng, half, 3)
                * scale[which][:, None] * 1.001)
    tables = tk.make_inst_tables(T(pos), T(rot), T(scale),
                                 torch.tensor(1.25),
                                 sort_origin=T(o.mean(0)))
    rays = tintersect.pack_rays(T(o), T(unit_rows(rng, n, 3)),
                                torch.zeros(n), torch.full((n,), 1e9))
    rays[7, ::2] = float("inf")
    rays[7, ::7] = -1.0
    return tables, rays


def hand_scene(seed=3, k=20):
    """k instances (two chunks, the second 4 members and 12 padding
    columns) and hand-made rays: for each chunk, rays tangent to the member
    that touches the covering sphere, at the touching point moved out by
    0 to 1e-3 of the covering radius, from 2 to 1,000 units away; rays
    from inside each covering sphere; every other tmax = inf, every 5th
    lane dead."""
    rng = np.random.RandomState(seed)
    pos = (rng.randn(k, 3) * 4).astype(np.float32)
    scale = (0.2 + rng.rand(k)).astype(np.float32)
    tables = tk.make_inst_tables(T(pos), T(unit_rows(rng, k, 4)), T(scale),
                                 torch.tensor(1.0),
                                 sort_origin=torch.zeros(3))
    inst, bounds, _, n_ic = tables
    rows = []
    for ch in range(n_ic):
        cols = slice(ch * tk.INST_CHUNK, (ch + 1) * tk.INST_CHUNK)
        c = inst[0:3, cols].double().numpy().T
        r = inst[8, cols].double().numpy()
        bc = bounds[0:3, ch].double().numpy()
        br = float(bounds[3, ch])
        reach = np.where(r > 0, np.linalg.norm(c - bc, axis=1) + r, -1.0)
        e = c[np.argmax(reach)] - bc
        e /= np.linalg.norm(e)
        for _ in range(24):
            u = np.cross(e, rng.randn(3))
            u /= np.linalg.norm(u)
            length = float(np.exp(rng.uniform(np.log(2.0), np.log(1000.0))))
            for rel in (0.0, 1e-6, 1e-5, 1e-4, 1e-3):
                o = bc + e * br * (1.0 + rel) - u * length
                rows.append([*o, *u, 0.0, 2.0 * length])
        for _ in range(24):
            inside = bc + unit_rows(rng, 1, 3)[0] * br * rng.rand()
            rows.append([*inside, *unit_rows(rng, 1, 3)[0], 0.0, 50.0])
    rays = torch.from_numpy(np.asarray(rows, np.float32).T.copy())
    rays[7, ::2] = float("inf")
    rays[7, ::5] = -1.0
    return tables, rays


CASES = {f"hard-{k}": (lambda k=k: hard_scene(k, k)) for k in (5, 24, 48,
                                                               438)}
CASES["hand"] = hand_scene


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    (inst, bounds, _, _), rays = CASES[request.param]()
    return inst, bounds, tk.make_bscan_table(inst), rays


def test_walk_equals_plain_over_three_rounds(case):
    """bound_scan_walk gives bound_scan_plain's keys bit for bit from cursor
    -1 and from the two cursors that follow, with the segment ending at the
    best hit so far in the later rounds, as cand_loop leaves it (here the
    found key's entry t plus 2); and the cull skips chunks where there is
    more than one (hard-5's one chunk holds the giant instance, whose
    bound holds every origin)."""
    inst, bounds, bscan, rays = case
    m_tbl = inst.shape[1]
    trunc = ~((1 << ik.pos_bits(bscan.shape[0])) - 1)
    cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32)
    cur = rays.clone()
    skipped = 0
    for _ in range(3):
        key = tk.bound_scan_plain(cur, bscan, cursor)
        met, walked, _ = tk.bound_scan_walk(cur, bscan, cursor, bounds, m_tbl)
        assert torch.equal(walked, key)
        live = cur[7] >= cur[6]
        assert bool((key[~live] == ik.INF_BITS).all())
        assert not bool(met[~live].any())
        skipped += int((~met[live]).sum())
        found = key < ik.INF_BITS
        entry = (key & trunc).view(torch.float32)
        cur[7] = torch.where(found, torch.fmin(rays[7], entry + 2.0), cur[7])
        cursor = key
    assert skipped > 0 or met.shape[1] == 1


def test_margin_is_needed(monkeypatch):
    """With the cull's rounding margin set to 0, the walk drops the member
    that a ray from far away meets only by rounding, and its key differs
    from the plain version's on some lane: the margin is what keeps the
    walk exact."""
    (inst, bounds, _, _), rays = hand_scene()
    bscan = tk.make_bscan_table(inst)
    cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32)
    key = tk.bound_scan_plain(rays, bscan, cursor)
    walked = tk.bound_scan_walk(rays, bscan, cursor, bounds,
                                inst.shape[1])[1]
    assert torch.equal(walked, key)
    monkeypatch.setattr(ik, "CULL_SCALE", 0.0)
    unmargined = tk.bound_scan_walk(rays, bscan, cursor, bounds,
                                    inst.shape[1])[1]
    assert int((unmargined != key).sum()) > 0


def test_bound_scan_work_counts_the_kernels_walk():
    """bound_scan_work equals a lane-by-lane walk of the kernel's loops on
    the hand scene's rays from cursor -1, written out here in float32
    scalars: chunks in table order, the cull against [tmin, t_end] with
    t_end from the best key, the rows below m_tbl of a met chunk, a root
    for each swept row whose discriminant is not negative."""
    (inst, bounds, _, _), rays = hand_scene()
    rays = rays[:, ::3].contiguous()
    bscan = tk.make_bscan_table(inst)
    m_tbl = inst.shape[1]
    cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32)
    work = [x.numpy() for x in tk.bound_scan_work(rays, bscan, cursor,
                                                  bounds, m_tbl, block=64)]
    key = tk.bound_scan_plain(rays, bscan, cursor).numpy()
    trunc = ~((1 << ik.pos_bits(bscan.shape[0])) - 1)
    f = np.float32
    scale = f(ik.CULL_SCALE)
    b = bounds.numpy()
    tbl = bscan.numpy()
    n_chunks = -(-m_tbl // tk.INST_CHUNK)
    for i in range(rays.shape[1]):
        ox, oy, oz, dx, dy, dz, tmin, tmax = (f(x) for x in rays[:, i])
        walk = [0, 0, 0, 0]
        best = ik.INF_BITS
        if tmax >= tmin:
            od = ox * dx + oy * dy + oz * dz
            oo = ox * ox + oy * oy + oz * oz
            dd = dx * dx + dy * dy + dz * dz
            dev = abs(dd - f(1.0))
            slope = (f(1.125) * (np.sqrt(dev) + scale)
                     if dev <= f(2.0 ** -8) else f(np.inf))
            m_o = scale * (abs(ox) + abs(oy) + abs(oz))
            inv_dd = f(1.0) / dd
            for k in range(n_chunks):
                walk[0] += 1
                t_end = tmax
                if best < ik.INF_BITS:
                    top = np.array((best & trunc) | ~trunc,
                                   np.int32).view(np.float32)[()]
                    t_end = np.fmin(tmax, top)
                bx, by, bz, br = b[:4, k]
                bw = br + scale * (abs(bx) + abs(by) + abs(bz) + br)
                vx, vy, vz = bx - ox, by - oy, bz - oz
                s_star = (vx * dx + vy * dy + vz * dz) * inv_dd
                s = np.fmin(np.fmax(s_star, tmin), t_end)
                wx, wy, wz = vx - s * dx, vy - s * dy, vz - s * dz
                e = bw + m_o
                lim = e + slope * (abs(s_star) + e)
                if wx * wx + wy * wy + wz * wz > lim * lim:
                    continue
                walk[1] += 1
                for c in range(k * tk.INST_CHUNK,
                               min((k + 1) * tk.INST_CHUNK, m_tbl)):
                    walk[2] += 1
                    cx, cy, cz, ccrr = tbl[c]
                    bb = od - (cx * dx + cy * dy + cz * dz)
                    c0 = oo - f(2.0) * (cx * ox + cy * oy + cz * oz) + ccrr
                    disc = bb * bb - c0
                    if disc < 0:
                        continue
                    walk[3] += 1
                    sq = np.sqrt(disc)
                    entry, exit_t = -bb - sq, sq - bb
                    ce = entry if entry > 0 else f(0.0)
                    kk = int((np.array(ce, np.float32).view(np.int32)
                              & trunc) | c)
                    if exit_t >= tmin and entry <= tmax and kk > -1:
                        best = min(best, kk)
        assert [int(w[i]) for w in work] == walk, i
        assert best == key[i], i
    live = (rays[7] >= rays[6]).numpy()
    assert (work[2][live] < m_tbl).any() and work[3].sum() > 0


@pytest.mark.parametrize("zeroed", [False, True])
def test_brute_work_counts(zeroed):
    """intersect_brute_work against a direct float32 count: a live ray
    sweeps every sphere with r > 0 and takes a root where b^2 - c0 > 0;
    with half the rows zeroed (the compact light table's unused rows) only
    the others are swept. Dead lanes count nothing."""
    rng = np.random.RandomState(11)
    k, n = 128, 700
    c = (rng.randn(k, 3) * 8).astype(np.float32)
    r = (0.05 + rng.rand(k)).astype(np.float32)
    if zeroed:
        c[1::2] = 0.0
        r[1::2] = 0.0
    o = (rng.randn(n, 3) * 12).astype(np.float32)
    aim = c[rng.randint(0, k, n)] - o
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    tmax = np.where(rng.rand(n) < 0.2, -1.0, np.inf).astype(np.float32)
    rays = tintersect.pack_rays(T(o), T(d), torch.zeros(n), T(tmax))
    spheres = tintersect.pack_spheres(T(c), T(r))
    pairs, roots = (x.numpy() for x in ik.intersect_brute_work(
        rays, spheres, block=100))
    live = tmax >= 0.0
    od = o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1] + o[:, 2] * d[:, 2]
    oo = o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1] + o[:, 2] * o[:, 2]
    cc = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
    b = od[:, None] - (c[None, :, 0] * d[:, None, 0]
                       + c[None, :, 1] * d[:, None, 1]
                       + c[None, :, 2] * d[:, None, 2])
    c0 = oo[:, None] - np.float32(2.0) * (c[None, :, 0] * o[:, None, 0]
                                          + c[None, :, 1] * o[:, None, 1]
                                          + c[None, :, 2] * o[:, None, 2])
    c0 = c0 + cc[None, :]
    keep = r > 0
    np.testing.assert_array_equal(pairs, np.where(live, keep.sum(), 0))
    np.testing.assert_array_equal(
        roots, ((b * b - c0 > 0) & keep).sum(1) * live)
    assert 0 < roots.sum() < pairs.sum()
    assert pairs.max() == (k // 2 if zeroed else k)


def test_culled_loop_equals_fused_plain(monkeypatch):
    """cand_loop with every B5 launch replaced by the culled walk (the
    kernel's visits, lane by lane) still equals cand_fused_plain word for
    word: the culls change no candidate of the multi-launch loop."""
    from drts_tpu_torch.models import geometry
    from drts_tpu_torch.ops import trimesh

    (inst, bounds, _, _), rays = hard_scene(7, 24, n=1024)
    rays[7] = torch.where(rays[7] >= rays[6], 1e9, rays[7])
    mesh = trimesh.make_mesh(*geometry.create_geosphere(2.0, 2),
                             device="cpu")
    tri_tbl = mesh.tri_tbl
    bscan = tk.make_bscan_table(inst)
    walks = []

    def walked(rays_, bscan_, cursor, inst_bounds, m_tbl, block=16384):
        walks.append(m_tbl)
        return tk.bound_scan_walk(rays_, bscan_, cursor, inst_bounds,
                                  m_tbl)[1]
    monkeypatch.setattr(tk, "bound_scan", walked)
    rounds = 3
    loop = tk.cand_loop(rays, bscan, inst, bounds, tri_tbl, mesh.tri_bounds,
                        mesh.tri_chunk, rounds)
    fused = tk.cand_fused_plain(rays, bscan, inst, bounds, tri_tbl,
                                mesh.tri_bounds, mesh.tri_chunk, rounds)
    assert walks == [inst.shape[1]] * (rounds + 1)
    for lp, fu in zip(loop, fused):
        assert torch.equal(lp, fu)
    assert bool((loop[0] < ik.INF_BITS).any())
