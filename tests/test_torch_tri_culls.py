"""The triangle-chunk culls of B6, B8, B9 and B10 (``trimesh_kernels.
tri_sweep_walk``, ``shared_blas_sweep_work``, ``shared_blas_any_walk``,
``intersect_mesh_instances_any_walk``, ``cand_fused_walk``) and the chunk
table they read (``tri_chunk_bounds``), on the CPU.

The CUDA kernels of B6, B8, B9 and B10 sweep an instance's faces chunk by
chunk: a lane skips the faces of a chunk whose covering sphere its
object-space segment misses by more than the margin of TRI_CULL_SCALE,
except the faces its ray grazes (|dl . A| < TRI_GUARD, ``face_guards``),
whose Moeller-Trumbore t may be rounding noise anywhere on the segment
(csrc/trimesh.cu states the argument; B9 tests Moeller-Trumbore on its own
ray, whose direction has length 1/scale). B10's scans are B5's culled
walk.
The walks repeat the kernels lane by lane in their operations and order;
here they are held to the unculled plain versions, which
tests/test_torch_trimesh_any.py and tests/test_torch_cand_fused.py hold to
the reference. The kernels are held to the walks and the plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Inputs, from numpy seeds: tests/test_torch_scan_culls.py's hard scene with
a 128-face geosphere; geospheres at tessellations 1-3 (8, 32 and 128 faces:
padding rows and padding chunks included); and a hand scene of rays
grazing faces' planes (many of which Moeller-Trumbore accepts far from
the face), origins inside the mesh with tmin > 0, rays tangent to a
chunk's covering sphere, and segments ending on the hit they find.

Tolerance 0 throughout: the walks give the plain versions' words bit for
bit, and the chunk spheres equal the reference's rows 0-3 bit for bit.
The two tests that read the reference import it inside the test, so that
tests/test_torch_cuda.py can take the hand scene from here on a machine
without JAX.
"""

import functools

import numpy as np
import pytest
import torch

from drts_tpu_torch import convert
from drts_tpu_torch.models import geometry
from drts_tpu_torch.ops import intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik
from drts_tpu_torch.ops import trimesh as ttrimesh
from drts_tpu_torch.ops import trimesh_kernels as tk
from test_torch_scan_culls import hard_scene, unit_rows

T = torch.from_numpy


def corners(arrays):
    pos, _, _, faces = arrays
    v0 = pos[faces[:, 0]]
    return v0, pos[faces[:, 1]] - v0, pos[faces[:, 2]] - v0


def quat_rotate(q, v):
    """v rotated by the unit quaternions q (x y z w), float64."""
    qv, w = q[:, :3], q[:, 3:]
    c = np.cross(qv, v) + w * v
    return v + 2.0 * np.cross(qv, c)


# ----------------------------------------------------------------------------
# The chunk table


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunk_spheres_equal_the_reference(chunk):
    """Rows 0-3 of the reference's tri_bounds, bit for bit, where both pad
    the table alike: geospheres of 128 and 512 faces, and 192 random faces
    (a table without padding)."""
    from drts_tpu.models import geometry as jgeometry
    from drts_tpu.ops import trimesh_pallas as jtp

    rng = np.random.RandomState(chunk)
    meshes = [corners(jgeometry.create_geosphere(2.0, tess))
              for tess in (3, 4)]
    meshes.append(tuple((rng.randn(192, 3) * s).astype(np.float32)
                        for s in (3.0, 0.4, 0.4)))
    for v0, e1, e2 in meshes:
        order, tbl, bounds = tk.build_mesh_tables(v0, e1, e2, chunk)
        j_order, j_tbl, j_bounds = jtp.build_mesh_tables(v0, e1, e2,
                                                         chunk)[:3]
        np.testing.assert_array_equal(order, j_order)
        np.testing.assert_array_equal(tbl, j_tbl)
        assert bounds.shape == (tk.TRI_BOUND_ROWS, j_bounds.shape[1])
        assert bounds.dtype == np.float32
        np.testing.assert_array_equal(bounds[:4], j_bounds[:4])
        np.testing.assert_array_equal(bounds, tk.tri_chunk_bounds(tbl, chunk))


def test_padding_chunks_hold_the_origin():
    """32 faces padded to 64 rows at chunk 16: the two chunks of padding
    rows cover the origin with radius 1e-5 and have the cone that skips
    every face (c = s = 0, h = -1: an all-zero row never passes
    Moeller-Trumbore), and the chunk count is padded to 8 columns of
    zeros."""
    _, tbl, bounds = tk.build_mesh_tables(
        *corners(geometry.create_geosphere(1.0, 2)), 16)
    assert tbl.shape == (64, 9) and bounds.shape == (tk.TRI_BOUND_ROWS, 8)
    np.testing.assert_array_equal(bounds[:3, 2:], 0.0)
    np.testing.assert_array_equal(bounds[3, 2:4], np.float32(1e-5))
    np.testing.assert_array_equal(bounds[3, 4:], 0.0)
    np.testing.assert_array_equal(bounds[4:9, 2:], 0.0)
    np.testing.assert_array_equal(bounds[9, 2:4], -1.0)
    assert (bounds[3, :2] > 0.5).all() and (bounds[7, :2] > 0).all()


@pytest.mark.parametrize("tess,chunk", [(3, 8), (4, 16), (4, 64)])
def test_guard_cones_bound_every_face(tess, chunk):
    """Rows 4-9 of tri_bounds: for 4,000 directions (|d.d - 1| up to
    2^-9) and every chunk, each face's G = |d . A| / |d| (float64, A =
    e1 x e2 / |e1||e2| of the float32 rows) is at least the lane's
    float32 cone value c |d . w| - s sqrt(d.d - (d . w)^2) - h, less the
    4u of its last three roundings; the cone spares a share of the
    (direction, chunk) pairs their guard tests; a chunk with a face that
    stands across the others, or a face without area, gets no cone."""
    _, tbl, bounds = tk.build_mesh_tables(
        *corners(geometry.create_geosphere(1.0, tess)), chunk)
    rng = np.random.RandomState(tess * chunk)
    d = unit_rows(rng, 4000, 3) * rng.uniform(
        1.0 - 2.0 ** -10, 1.0 + 2.0 ** -10, (4000, 1)).astype(np.float32)
    e1, e2 = tbl[:, 3:6].astype(np.float64), tbl[:, 6:9].astype(np.float64)
    a = np.cross(e1, e2) / (np.linalg.norm(e1, axis=1)
                            * np.linalg.norm(e2, axis=1))[:, None]
    d64 = d.astype(np.float64)
    g = np.abs(d64 @ a.T) / np.linalg.norm(d64, axis=1, keepdims=True)

    def lane(b):
        """The kernel's cone value per (direction, chunk), float32."""
        dt = torch.from_numpy(d)
        dd = dt[:, 0] * dt[:, 0] + dt[:, 1] * dt[:, 1] + dt[:, 2] * dt[:, 2]
        x = (dt[:, 0, None] * T(b[4]) + dt[:, 1, None] * T(b[5])
             + dt[:, 2, None] * T(b[6]))
        return ((T(b[7]) * x.abs() - T(b[8]) * torch.sqrt(torch.clamp(
            dd[:, None] - x * x, min=0.0))) - T(b[9])).double().numpy()

    n = tbl.shape[0] // chunk
    cone = lane(bounds)[:, :n]
    for c in range(n):
        low = g[:, c * chunk:(c + 1) * chunk].min(1)
        assert (low >= cone[:, c] - 4 * 2.0 ** -24).all(), c
    assert 0.2 < (cone >= tk.TRI_GUARD).mean() < 0.95
    rows = tbl[:chunk].copy()
    nrm = np.cross(rows[0, 3:6], rows[0, 6:9])
    rows[0, 6:9] = rows[0, 3:6]
    rows[0, 3:6] = nrm / np.linalg.norm(nrm) * 0.1   # across the others
    w, c_q, s_q, h = tk._chunk_cone(rows)
    assert c_q < 0.1 and s_q > 0.5
    rows = tbl[:chunk].copy()
    rows[3, 6:9] = rows[3, 3:6] * 2.0                # e2 = 2 e1: no area
    assert tk._chunk_cone(rows)[1:] == (0.0, 0.0, 1.0)


def test_tri_mesh_builds_the_ports_table():
    """convert.tri_mesh carries the reference's triangle table and builds
    the port's chunk spheres from it, at TRI_CHUNK: not the reference's
    8-row table at its own chunk, which would share the field's name."""
    from drts_tpu.models import geometry as jgeometry
    from drts_tpu.ops import trimesh as jtrimesh

    arrays = jgeometry.create_geosphere(2.0, 4)
    jmesh = jtrimesh.make_mesh(*arrays)
    conv = convert.tri_mesh(jmesh, "cpu")
    made = ttrimesh.make_mesh(*arrays, device="cpu")
    j_bounds = np.asarray(jmesh.tri_bounds)
    assert j_bounds.shape[0] == 8
    assert conv.tri_chunk == made.tri_chunk == tk.TRI_CHUNK
    assert conv.tri_bounds.shape == (tk.TRI_BOUND_ROWS, 512 // tk.TRI_CHUNK)
    np.testing.assert_array_equal(conv.tri_tbl.numpy(),
                                  np.asarray(jmesh.tri_tbl))
    np.testing.assert_array_equal(
        conv.tri_bounds.numpy(),
        tk.tri_chunk_bounds(np.asarray(jmesh.tri_tbl), tk.TRI_CHUNK))
    np.testing.assert_array_equal(conv.tri_bounds.numpy(),
                                  made.tri_bounds.numpy())
    assert conv.tri_bounds.shape != j_bounds.shape


@pytest.mark.parametrize("chunk", [0, -8, 4, 12, 24, 40, 128, 16.0, "16"])
def test_bad_chunk_sizes_raise(chunk):
    """A chunk that is not a positive multiple of 8 dividing TRI_PAD (64)
    raises in the table makers and in both wrappers."""
    v0, e1, e2 = corners(geometry.create_geosphere(1.0, 2))
    with pytest.raises(ValueError):
        tk.build_mesh_tables(v0, e1, e2, chunk)
    tbl = np.zeros((64, 9), np.float32)
    with pytest.raises(ValueError):
        tk.tri_chunk_bounds(tbl, chunk)
    rays = torch.zeros((8, 4))
    words = torch.zeros(4, dtype=torch.int32)
    inst = torch.zeros((9, 16))
    bounds = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        tk.shared_blas_any(rays, words, words, inst, T(tbl), bounds, chunk)
    with pytest.raises(ValueError):
        tk.cand_fused(rays, torch.zeros((128, 4)), inst, bounds, T(tbl),
                      bounds, chunk, 1)


# ----------------------------------------------------------------------------
# Scenes


def mesh_tables(tess, chunk, radius=2.0):
    _, tbl, bounds = tk.build_mesh_tables(
        *corners(geometry.create_geosphere(radius, tess)), chunk)
    return T(tbl), T(bounds)


@functools.lru_cache(maxsize=None)
def scene_of_hard(tess):
    """The hard scene's TLAS and rays (24 instances, bound radius 1.25:
    the mesh's radius is 1.25 here) over a geosphere."""
    (inst, bounds, _, _), rays = hard_scene(11, 24, n=768)
    return inst, bounds, rays, mesh_tables(tess, tk.TRI_CHUNK, 1.25)


@functools.lru_cache(maxsize=None)
def hand_scene(seed=5, tess=3, chunk=tk.TRI_CHUNK):
    """Three instances (identity, and two rotated and scaled) of a unit
    geosphere, and rays built in an instance's object frame, then moved to
    world: (a) rays in the plane of a face, passing up to 1.5 units from
    it, origins moved off the plane by 0 to 1e-6; (b) origins inside the
    mesh, tmin from 1e-3 to 0.5; (c) rays tangent to a chunk's covering
    sphere, moved out by 0 to 1e-6 of its radius, from 0.5 to 100 units
    away; (d) rays aimed at the mesh, three times each: tmax at the
    object-space t of the hit found and moved by 1e-7 of it either way,
    scaled to world units with the instance (every 9th lane dead). Returns (inst_tbl, inst_bounds, rays,
    cand: each ray's instance position, (tri_tbl, tri_bounds)), built once
    per argument set: callers do not modify them."""
    rng = np.random.RandomState(seed)
    tri_tbl, tri_bounds = mesh_tables(tess, chunk, 1.0)
    tbl = tri_tbl.double().numpy()
    n_faces = 8 * 4 ** (tess - 1)
    pos = np.array([[0, 0, 0], [3, 0.5, 0], [-1, 4, 1]], np.float32)
    rot = np.concatenate([[[0, 0, 0, 1]], unit_rows(rng, 2, 4)]).astype(
        np.float32)
    scale = np.array([1.0, 0.5, 2.0], np.float32)
    tables = tk.make_inst_tables(T(pos), T(rot), T(scale),
                                 torch.tensor(1.0),
                                 sort_origin=torch.zeros(3))
    inst = tables[0]
    order = tables[2].numpy()
    o, d, tmin, tmax = [], [], [], []

    # (a) in the plane of a face.
    m = 1200
    f = rng.randint(0, n_faces, m)
    v0, e1, e2 = tbl[f, 0:3], tbl[f, 3:6], tbl[f, 6:9]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    a = rng.randn(m, 3)
    a -= (a * nrm).sum(1, keepdims=True) * nrm
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    cent = v0 + (e1 + e2) / 3.0
    o.append(cent + np.cross(nrm, a) * rng.uniform(-1.5, 1.5, (m, 1))
             - a * rng.uniform(0.5, 3.0, (m, 1))
             + nrm * rng.choice([0.0, 1e-7, -1e-7, 1e-6], (m, 1)))
    d.append(a)
    tmin.append(np.zeros(m))
    tmax.append(np.where(rng.rand(m) < 0.5, 1e9, 4.0))

    # (b) origins inside the mesh, tmin > 0.
    m = 200
    o.append(unit_rows(rng, m, 3) * rng.uniform(0.0, 0.9, (m, 1)))
    d.append(unit_rows(rng, m, 3))
    tmin.append(rng.uniform(1e-3, 0.5, m))
    tmax.append(np.full(m, 1e9))

    # (c) tangent to a chunk's covering sphere.
    bnd = tri_bounds.double().numpy()
    for c in range(n_faces // chunk):
        cc, rr = bnd[:3, c], bnd[3, c]
        for _ in range(12):
            e = unit_rows(rng, 1, 3)[0].astype(np.float64)
            u = np.cross(e, rng.randn(3))
            u /= np.linalg.norm(u)
            length = float(np.exp(rng.uniform(np.log(0.5), np.log(100.0))))
            for rel in (0.0, 1e-7, 1e-6, -1e-6):
                o.append((cc + e * rr * (1.0 + rel) - u * length)[None])
                d.append(u[None])
                tmin.append(np.zeros(1))
                tmax.append(np.array([2.0 * length]))

    # (d) aimed at the mesh; the segment then ends on the hit found.
    m = 200
    oo = unit_rows(rng, m, 3) * rng.uniform(1.5, 6.0, (m, 1))
    dd = unit_rows(rng, m, 3) * 0.5 - oo
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    hit = tk._sweep_packed(
        tuple(T(oo[:, i].astype(np.float32)) for i in range(3)),
        tuple(T(dd[:, i].astype(np.float32)) for i in range(3)),
        torch.zeros(m), torch.full((m,), 1e9), tri_tbl.float(),
        ~((1 << ik.pos_bits(tri_tbl.shape[0])) - 1), 4096)
    t_hit = (hit & ~((1 << ik.pos_bits(tri_tbl.shape[0])) - 1)).view(
        torch.float32).numpy().astype(np.float64)
    t_hit = np.where(np.isfinite(t_hit), t_hit, 3.0)
    for bump in (0.0, 1e-7, -1e-7):
        o.append(oo)
        d.append(dd)
        tmin.append(np.zeros(m))
        tmax.append(t_hit * (1.0 + bump))

    o, d = np.concatenate(o), np.concatenate(d)
    tmin, tmax = np.concatenate(tmin), np.concatenate(tmax)
    n = o.shape[0]
    k = rng.randint(0, 3, n)
    q = rot[k].astype(np.float64)
    s = scale[k].astype(np.float64)[:, None]
    o_w = pos[k] + s * quat_rotate(q, o)
    d_w = quat_rotate(q, d)
    d_w /= np.linalg.norm(d_w, axis=1, keepdims=True)
    rays = tintersect.pack_rays(T(o_w.astype(np.float32)),
                                T(d_w.astype(np.float32)),
                                T((tmin * s[:, 0]).astype(np.float32)),
                                T((tmax * s[:, 0]).astype(np.float32)))
    rays[7, ::9] = -1.0
    pos_of = np.zeros(3, np.int64)                 # instance -> position
    pos_of[order[order >= 0]] = np.flatnonzero(order >= 0)
    cand = pos_of[k].astype(np.int32)
    return inst, tables[1], rays, T(cand), (tri_tbl, tri_bounds)


# ----------------------------------------------------------------------------
# The walks against the plain versions


def b8_case(name):
    """(rays, cand, occ_in, inst_tbl, tri_tbl, tri_bounds) for B8: the
    first candidates of B5's scan, every 5th lane's bit already set."""
    if name == "hand":
        inst, _, rays, cand, (tri_tbl, tri_bounds) = hand_scene()
    else:
        if name == "hard":
            inst, bounds, rays, (tri_tbl, tri_bounds) = scene_of_hard(3)
        else:
            tess = int(name[-1])
            (inst, bounds, _, _), rays = hard_scene(tess, 24, n=512)
            tri_tbl, tri_bounds = mesh_tables(tess, tk.TRI_CHUNK, 1.25)
        bscan = tk.make_bscan_table(inst)
        cursor = torch.full((rays.shape[1],), -1, dtype=torch.int32)
        key = tk.bound_scan_plain(rays, bscan, cursor)
        mask = (1 << ik.pos_bits(bscan.shape[0])) - 1
        cand = torch.where(key < ik.INF_BITS, key & mask,
                           inst.shape[1]).to(torch.int32)
    occ = torch.zeros(rays.shape[1], dtype=torch.int32)
    occ[::5] = 1
    return rays, cand, occ, inst, tri_tbl, tri_bounds


CASES = ("hard", "tess1", "tess2", "tess3", "hand")


@pytest.mark.parametrize("name", CASES)
def test_anyhit_walk_equals_plain(name):
    """shared_blas_any_walk gives shared_blas_any_plain's bits, with the
    tmax of every other live lane cut to 3 units; the cull skips chunks
    and the guard sweeps faces of skipped chunks."""
    rays, cand, occ, inst, tri_tbl, tri_bounds = b8_case(name)
    rays = rays.clone()
    rays[7, ::2] = torch.clamp(rays[7, ::2], max=3.0)
    for r in (b8_case(name)[0], rays):
        plain = tk.shared_blas_any_plain(r, cand, occ, inst, tri_tbl)
        walked, met, work = tk.shared_blas_any_walk(
            r, cand, occ, inst, tri_tbl, tri_bounds, tk.TRI_CHUNK)
        assert torch.equal(walked, plain)
        assert 0 < int((plain > occ).sum())
        tests, n_met, cones, guards, swept = work.sum(0).tolist()
        assert n_met < tests and swept < tests * tk.TRI_CHUNK
        assert n_met == int(met.sum()) and cones == tests - n_met
    if name == "hand":
        assert guards > 0 and swept > n_met * tk.TRI_CHUNK
        assert guards < cones * tk.TRI_CHUNK


@pytest.mark.parametrize("name", CASES)
def test_fused_walk_equals_plain(name):
    """cand_fused_walk gives cand_fused_plain's best, binst and key over 3
    rounds; the scan and the sweep cull."""
    if name == "hand":
        inst, bounds, rays, _, (tri_tbl, tri_bounds) = hand_scene()
    elif name == "hard":
        inst, bounds, rays, (tri_tbl, tri_bounds) = scene_of_hard(3)
    else:
        tess = int(name[-1])
        (inst, bounds, _, _), rays = hard_scene(tess + 20, 24, n=512)
        tri_tbl, tri_bounds = mesh_tables(tess, tk.TRI_CHUNK, 1.25)
    args = (rays, tk.make_bscan_table(inst), inst, bounds, tri_tbl,
            tri_bounds, tk.TRI_CHUNK, 3)
    plain = tk.cand_fused_plain(*args)
    walked, work, warp = tk.cand_fused_walk(*args)
    for p, w in zip(plain, walked):
        assert torch.equal(p, w)
    assert bool((plain[0] < ik.INF_BITS).any())
    s = work.sum(0).tolist()
    assert s[1] <= s[0] and s[5] < s[4] and s[8] < s[4] * tk.TRI_CHUNK
    assert s[6] == s[4] - s[5] and s[7] < s[6] * tk.TRI_CHUNK
    assert 0 < warp[1] and 0 < warp[0]


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_walks_equal_plain_at_other_chunks(chunk):
    """Both walks on the hand scene at the other chunk sizes."""
    inst, bounds, rays, cand, (tri_tbl, tri_bounds) = hand_scene(
        seed=chunk, chunk=chunk)
    occ = torch.zeros(rays.shape[1], dtype=torch.int32)
    assert torch.equal(
        tk.shared_blas_any_walk(rays, cand, occ, inst, tri_tbl, tri_bounds,
                                chunk)[0],
        tk.shared_blas_any_plain(rays, cand, occ, inst, tri_tbl))
    args = (rays, tk.make_bscan_table(inst), inst, bounds, tri_tbl,
            tri_bounds, chunk, 2)
    for p, w in zip(tk.cand_fused_plain(*args), tk.cand_fused_walk(*args)[0]):
        assert torch.equal(p, w)


@pytest.mark.parametrize("margin,guard", [(True, True), (False, False)])
def test_margin_and_guard_keep_the_walks_exact(monkeypatch, margin, guard):
    """At the kept TRI_CULL_SCALE and TRI_GUARD the walks equal the plain
    versions on the hand scene; with the margin at 0 and no guard, they
    drop hits that Moeller-Trumbore accepts on grazing rays, far from the
    face: both walks then differ from the plain versions."""
    inst, bounds, rays, cand, (tri_tbl, tri_bounds) = hand_scene()
    occ = torch.zeros(rays.shape[1], dtype=torch.int32)
    plain8 = tk.shared_blas_any_plain(rays, cand, occ, inst, tri_tbl)
    args = (rays, tk.make_bscan_table(inst), inst, bounds, tri_tbl,
            tri_bounds, tk.TRI_CHUNK, 1)
    plain10 = tk.cand_fused_plain(*args)
    if not margin:
        monkeypatch.setattr(tk, "TRI_CULL_SCALE", 0.0)
    if not guard:
        monkeypatch.setattr(tk, "TRI_GUARD", 0.0)
    walked8 = tk.shared_blas_any_walk(rays, cand, occ, inst, tri_tbl,
                                      tri_bounds, tk.TRI_CHUNK)[0]
    walked10 = tk.cand_fused_walk(*args)[0]
    lost8 = int((walked8 != plain8).sum())
    lost10 = int((walked10[0] != plain10[0]).sum())
    if margin and guard:
        assert lost8 == lost10 == 0
    else:
        assert lost8 > 0 and lost10 > 0
        assert bool((walked8 <= plain8).all())


def test_anyhit_work_counts_the_kernels_walk():
    """shared_blas_any_walk's counts on 60 lanes of the hand scene equal a
    lane-by-lane count written out here in float32 scalars: chunks in table
    order up to the first blocking face, the cull at TRI_CULL_SCALE, a
    missed chunk's guard cone, then the guard on each of its faces where
    the cone does not spare them, Moeller-Trumbore on the others."""
    inst, _, rays, cand, (tri_tbl, tri_bounds) = hand_scene()
    occ = torch.zeros(rays.shape[1], dtype=torch.int32)
    occ_w, _, work = tk.shared_blas_any_walk(rays, cand, occ, inst, tri_tbl,
                                             tri_bounds, tk.TRI_CHUNK)
    live, rl = tk._anyhit_lanes(rays, cand, occ, inst)
    idx = torch.nonzero(live)[:, 0]
    f = np.float32
    scale, guard, chunk = f(tk.TRI_CULL_SCALE), f(tk.TRI_GUARD), tk.TRI_CHUNK
    b = tri_bounds.numpy()
    guards = tk.face_guards(tri_tbl).numpy()
    pos = torch.arange(tri_tbl.shape[0], dtype=torch.int32)
    step = max(1, idx.numel() // 60)
    for j in range(0, idx.numel(), step):
        ox, oy, oz, dx, dy, dz, tmn, tmx = (f(x) for x in rl[:, j])
        dd = dx * dx + dy * dy + dz * dz
        dev = abs(dd - f(1.0))
        slope = f(1.125) * scale if dev <= f(2.0 ** -8) else f(np.inf)
        m_o = scale * (abs(ox) + abs(oy) + abs(oz))
        inv_dd = f(1.0) / dd
        hits = tk._mt_pairs(tuple(rl[i, j:j + 1] for i in range(3)),
                            tuple(rl[i, j:j + 1] for i in range(3, 6)),
                            rl[6, j:j + 1], rl[7, j:j + 1], tri_tbl, 0,
                            pos)[0] < ik.INF_BITS
        count, blocked = [0, 0, 0, 0, 0], False
        for k in range(tri_tbl.shape[0] // chunk):
            if blocked:
                break
            count[0] += 1
            bx, by, bz, br = b[:4, k]
            bw = br + scale * (abs(bx) + abs(by) + abs(bz) + br)
            vx, vy, vz = bx - ox, by - oy, bz - oz
            s_star = (vx * dx + vy * dy + vz * dz) * inv_dd
            s = np.fmin(np.fmax(s_star, tmn), tmx)
            wx, wy, wz = vx - s * dx, vy - s * dy, vz - s * dz
            e = bw + m_o
            lim = e + slope * (abs(s_star) + e)
            met = not (wx * wx + wy * wy + wz * wz > lim * lim)
            count[1] += met
            if not met:
                count[2] += 1
                cx, cy, cz, c_q, s_q, h = b[4:10, k]
                x = dx * cx + dy * cy + dz * cz
                low = (c_q * abs(x) - s_q * np.sqrt(max(dd - x * x, f(0.0))))
                if low - h >= guard:
                    continue
            for fi in range(k * chunk, (k + 1) * chunk):
                if not met:
                    count[3] += 1
                    ax, ay, az = guards[fi]
                    if abs(dx * ax + dy * ay + dz * az) >= guard:
                        continue
                count[4] += 1
                if bool(hits[fi]):
                    blocked = True
                    break
        lane = int(idx[j])
        assert work[lane].tolist() == count, lane
        assert int(occ_w[lane]) == blocked


def test_work_counters_sum_the_walks():
    """shared_blas_any_work and cand_fused_work, taken in blocks of 512
    lanes, return the walks' words and the sums of their per-lane counts
    and per-warp chunks over the whole batch; B8's `faces` is the plain
    version's count of the unculled sweep."""
    inst, bounds, rays, cand, (tri_tbl, tri_bounds) = hand_scene()
    occ = torch.zeros(rays.shape[1], dtype=torch.int32)
    occ[::7] = 1
    b8 = (rays, cand, occ, inst, tri_tbl, tri_bounds, tk.TRI_CHUNK)
    walked, met, work = tk.shared_blas_any_walk(*b8)
    occ_w, w = tk.shared_blas_any_work(*b8, block=512)
    plain = {}
    assert torch.equal(occ_w, tk.shared_blas_any_plain(*b8[:5], work=plain))
    assert torch.equal(occ_w, walked)
    assert [w[k] for k in ("tests", "met", "cones", "guards", "rows")] == \
        work.sum(0).tolist()
    assert w["live"] == plain["live"] and w["faces"] == plain["tri_tests"]
    assert w["warp_met"] == tk.warp_sum(met) and w["warps"] > 0

    b10 = (rays, tk.make_bscan_table(inst), inst, bounds, tri_tbl,
           tri_bounds, tk.TRI_CHUNK, 2)
    walked, work, warp = tk.cand_fused_walk(*b10)
    words, w = tk.cand_fused_work(*b10, block=512)
    for a, b in zip(words, tk.cand_fused_plain(*b10)):
        assert torch.equal(a, b)
    names = ("scan_tests", "scan_met", "scan_rows", "scan_roots",
             "tri_tests", "tri_met", "cones", "guards", "faces")
    assert [w[k] for k in names] == work.sum(0).tolist()
    assert [w["scan_warp_met"], w["tri_warp_met"]] == warp


@pytest.mark.parametrize("name", ["hard", "hand"])
def test_b6_sweep_with_the_culls_equals_plain(name):
    """shared_blas_sweep_work (B6's kernel walk, with the triangle-chunk
    culls it shares with B8 and B10, counted for its bound) folds the same
    best and binst as shared_blas_sweep_plain, from the first candidates
    and from a best already held on a third of the lanes."""
    if name == "hand":
        inst, bounds, rays, _, (tri_tbl, tri_bounds) = hand_scene()
    else:
        inst, bounds, rays, (tri_tbl, tri_bounds) = scene_of_hard(3)
    bscan = tk.make_bscan_table(inst)
    n = rays.shape[1]
    key = tk.bound_scan_plain(rays, bscan, torch.full((n,), -1,
                                                      dtype=torch.int32))
    mask = (1 << ik.pos_bits(bscan.shape[0])) - 1
    cand = torch.where(key < ik.INF_BITS, key & mask, inst.shape[1]).to(
        torch.int32)
    best = torch.full((n,), ik.INF_BITS, dtype=torch.int32)
    binst = torch.zeros(n, dtype=torch.int32)
    for _ in range(2):
        plain = tk.shared_blas_sweep_plain(rays, cand, best, binst, inst,
                                           tri_tbl, tri_bounds, tk.TRI_CHUNK)
        culled, w = tk.shared_blas_sweep_work(rays, cand, best, binst, inst,
                                              tri_tbl, tri_bounds,
                                              tk.TRI_CHUNK, block=256)
        for p, c in zip(plain, culled):
            assert torch.equal(p, c)
        assert w["rows"] < w["live"] * tri_tbl.shape[0] and w["met"] > 0
        best = torch.where(torch.arange(n) % 3 == 0, plain[0], best)


def b9_hand(scale, short=False):
    """The hand scene for B9: (rays, inst_tbl, inst_bounds, tri_tbl,
    tri_bounds, n_ichunks), only the rays built for the instance of the
    given scale live, every other live tmax cut to 3 units with `short`."""
    inst, bounds, rays, cand, (tri_tbl, tri_bounds) = hand_scene()
    rays = rays.clone()
    mine = inst[7, cand.long()] == np.float32(1.0 / scale)   # 1/scale
    rays[7] = torch.where(mine, rays[7], -1.0)
    if short:
        rays[7, ::2] = torch.clamp(rays[7, ::2], max=3.0)
    return (rays, inst, bounds, tri_tbl, tri_bounds,
            inst.shape[1] // tk.INST_CHUNK)


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_serial_anyhit_walk_equals_plain(scale, short):
    """intersect_mesh_instances_any_walk (B9's kernel walk: the triangle
    culls in B8's frame, Moeller-Trumbore on B9's own ray, whose direction
    has length 1/scale) gives the plain version's bits on the hand scene's
    rays built for the instance of scale 0.5, 1 or 2 (grazing rays,
    origins inside, tangent rays, segments ending on a hit), with the full
    ranges and with every other tmax cut to 3 units; the cull skips chunks
    and the guard sweeps faces of skipped chunks."""
    rays, inst, bounds, tri_tbl, tri_bounds, n_ic = b9_hand(scale, short)
    plain_work = {}
    plain = tk.intersect_mesh_instances_any_plain(
        rays, inst, bounds, tri_tbl, None, None, n_ic, work=plain_work)
    occ, counts, work = tk.intersect_mesh_instances_any_walk(
        rays, inst, bounds, tri_tbl, tri_bounds, tk.TRI_CHUNK, n_ic)
    assert torch.equal(occ, plain)
    assert counts == {k: plain_work[k] for k in counts}
    assert 0 < int(plain.sum()) < counts["live"]
    tests, met, cones, guards, swept = work.sum(0).tolist()
    assert met < tests and cones == tests - met
    assert 0 < guards < cones * tk.TRI_CHUNK
    assert swept < plain_work["tri_tests"]


def test_serial_anyhit_walk_needs_the_margin_and_guard(monkeypatch):
    """With the cull's margin at 0 and no guard, B9's walk drops hits that
    Moeller-Trumbore accepts on the hand scene's grazing rays, at every
    scale; the work counter sums the walk's counts and the plain
    version's."""
    for scale in (0.5, 1.0, 2.0):
        args = b9_hand(scale)
        blas = (*args[:4], args[4], tk.TRI_CHUNK, args[5])
        plain = tk.intersect_mesh_instances_any_plain(*blas)
        occ, w = tk.intersect_mesh_instances_any_work(*blas, block=512)
        assert torch.equal(occ, plain)
        walked = tk.intersect_mesh_instances_any_walk(*blas)
        assert [w[k] for k in ("tests", "met", "cones", "guards", "rows")] \
            == walked[2].sum(0).tolist()
        with monkeypatch.context() as mp:
            mp.setattr(tk, "TRI_CULL_SCALE", 0.0)
            mp.setattr(tk, "TRI_GUARD", 0.0)
            lost = tk.intersect_mesh_instances_any_walk(*blas)[0]
        assert bool((lost <= plain).all()) and bool((lost < plain).any())
