"""B7's triangle-chunk culls (``trimesh_kernels.intersect_mesh_instances_walk``
and ``intersect_mesh_instances_work``), on the CPU.

B7's CUDA kernel walks the instances in table order with the running best
as the far limit, and sweeps each instance it enters chunk by chunk with
the triangle-chunk cull of B6, B8 and B9 (csrc/trimesh.cu states the
argument): in B8's frame (the direction rotated only, so |d.d - 1| stays
within 2^-8 at any instance scale, the segment scaled by 1/scale and
ending at the running world best times 1/scale), with Moeller-Trumbore on
B7's own ray (the direction scaled by 1/scale, the world segment). The
walk repeats the kernel lane by lane in its operations and order; here it
is held to the unculled plain version, which tests/test_torch_trimesh.py
holds to the reference. The kernel is held to both on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Inputs, from numpy seeds: three instances of a unit 128-face geosphere at
scales 0.25, 1 and 4 (two of them rotated), and rays built in an
instance's object frame, then moved to world: (a) rays through points of
face edges and corners, nudged off them by 0 to 1e-6, and rays in the
plane of a face, passing up to 1.5 units from it; (b) rays tangent to
a chunk's covering sphere, moved out by 0 to 1e-6 of its radius; (c) rays
aimed at the mesh, their segment ending on the hit found and 1e-7 either
side of it; (d) rays from behind one instance aimed at another, so the
running best meets later instances; every 9th lane dead.

Tolerance 0 throughout: the walk gives the plain version's t, face and
instance words bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from drts_tpu_torch.ops import intersect as tintersect
from drts_tpu_torch.ops import intersect_kernels as ik
from drts_tpu_torch.ops import trimesh_kernels as tk
from test_torch_scan_culls import unit_rows
from test_torch_tri_culls import mesh_tables, quat_rotate

T = torch.from_numpy
SCALES = (0.25, 1.0, 4.0)


def _object_rays(rng, tbl, bnd, n_faces, chunk):
    """(o, d, tmin, tmax) float64 in a unit geosphere's object frame: the
    edge, rim and segment-end rays (a)-(c) of the module's docstring."""
    o, d, tmin, tmax = [], [], [], []
    # (a) through a point of a face's edge or corner.
    m = 600
    f = rng.randint(0, n_faces, m)
    v0, e1, e2 = tbl[f, 0:3], tbl[f, 3:6], tbl[f, 6:9]
    u = rng.rand(m, 1)
    side = rng.randint(0, 4, m)[:, None]
    p = np.where(side == 0, v0 + u * e1,
                 np.where(side == 1, v0 + u * e2,
                          np.where(side == 2, v0 + e1 + u * (e2 - e1),
                                   v0 + e1 * (u > 0.5) + e2 * (u <= 0.5))))
    dirs = unit_rows(rng, m, 3).astype(np.float64)
    nudge = unit_rows(rng, m, 3) * rng.choice([0.0, 1e-7, -1e-7, 1e-6],
                                              (m, 1))
    length = rng.uniform(0.5, 6.0, (m, 1))
    o.append(p + nudge - dirs * length)
    d.append(dirs)
    tmin.append(np.zeros(m))
    tmax.append(np.where(rng.rand(m) < 0.5, 1e9, length[:, 0] * 2.0))
    # ... and in the plane of a face, passing up to 1.5 units from it.
    m = 600
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
    # (b) tangent to a chunk's covering sphere.
    for c in range(n_faces // chunk):
        cc, rr = bnd[:3, c], bnd[3, c]
        for _ in range(6):
            e = unit_rows(rng, 1, 3)[0].astype(np.float64)
            w = np.cross(e, rng.randn(3))
            w /= np.linalg.norm(w)
            length = float(np.exp(rng.uniform(np.log(0.5), np.log(50.0))))
            for rel in (0.0, 1e-7, 1e-6, -1e-6):
                o.append((cc + e * rr * (1.0 + rel) - w * length)[None])
                d.append(w[None])
                tmin.append(np.zeros(1))
                tmax.append(np.array([2.0 * length]))
    # (c) aimed at the mesh; the segment then ends on the hit found.
    m = 150
    oo = unit_rows(rng, m, 3) * rng.uniform(1.5, 6.0, (m, 1))
    dd = unit_rows(rng, m, 3) * 0.5 - oo
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    trunc = ~((1 << ik.pos_bits(tbl.shape[0])) - 1)
    hit = tk._sweep_packed(
        tuple(T(oo[:, i].astype(np.float32)) for i in range(3)),
        tuple(T(dd[:, i].astype(np.float32)) for i in range(3)),
        torch.zeros(m), torch.full((m,), 1e9),
        T(tbl.astype(np.float32)), trunc, 4096)
    t_hit = (hit & trunc).view(torch.float32).numpy().astype(np.float64)
    t_hit = np.where(np.isfinite(t_hit), t_hit, 3.0)
    for bump in (0.0, 1e-7, -1e-7):
        o.append(oo)
        d.append(dd)
        tmin.append(np.zeros(m))
        tmax.append(t_hit * (1.0 + bump))
    return (np.concatenate(o), np.concatenate(d), np.concatenate(tmin),
            np.concatenate(tmax))


@functools.lru_cache(maxsize=None)
def b7_scene(seed=7, tess=3, chunk=tk.TRI_CHUNK):
    """The module's scene: (rays (8, N), inst_tbl, inst_bounds, tri_tbl,
    tri_bounds, n_ichunks, scale_of (N,) float32: the scale of the
    instance each ray was built for, NaN for (d)). Built once per argument
    set: callers do not modify it."""
    rng = np.random.RandomState(seed)
    tri_tbl, tri_bounds = mesh_tables(tess, chunk, 1.0)
    tbl = tri_tbl.double().numpy()
    n_faces = 8 * 4 ** (tess - 1)
    pos = np.array([[0, 0, 0], [3, 0.5, 0], [-2, 9, 1]], np.float32)
    rot = np.concatenate([[[0, 0, 0, 1]], unit_rows(rng, 2, 4)]).astype(
        np.float32)
    scale = np.array(SCALES, np.float32)
    inst, bounds, _, n_ic = tk.make_inst_tables(
        T(pos), T(rot), T(scale), torch.tensor(1.0),
        sort_origin=torch.zeros(3))
    o, d, tmin, tmax = _object_rays(rng, tbl, tri_bounds.double().numpy(),
                                    n_faces, chunk)
    n = o.shape[0]
    k = rng.randint(0, 3, n)
    q = rot[k].astype(np.float64)
    s = scale[k].astype(np.float64)[:, None]
    o_w = pos[k] + s * quat_rotate(q, o)
    d_w = quat_rotate(q, d)
    d_w /= np.linalg.norm(d_w, axis=1, keepdims=True)
    tmin_w, tmax_w = tmin * s[:, 0], tmax * s[:, 0]
    scale_of = scale[k].astype(np.float32)
    # (d) from behind one instance, through it, at another.
    m = 300
    a, b = rng.randint(0, 3, m), rng.randint(0, 3, m)
    b = np.where(a == b, (b + 1) % 3, b)
    aim = pos[b] + scale[b][:, None] * unit_rows(rng, m, 3) * 0.6
    back = pos[a] + scale[a][:, None] * unit_rows(rng, m, 3) * 0.5
    dir_ab = aim - back
    dir_ab /= np.linalg.norm(dir_ab, axis=1, keepdims=True)
    o_w = np.concatenate([o_w, back - dir_ab * 6.0 * scale[a][:, None]])
    d_w = np.concatenate([d_w, dir_ab])
    tmin_w = np.concatenate([tmin_w, np.zeros(m)])
    tmax_w = np.concatenate([tmax_w, np.full(m, 1e9)])
    scale_of = np.concatenate([scale_of, np.full(m, np.nan, np.float32)])
    rays = tintersect.pack_rays(T(o_w.astype(np.float32)),
                                T(d_w.astype(np.float32)),
                                T(tmin_w.astype(np.float32)),
                                T(tmax_w.astype(np.float32)))
    rays[7, ::9] = -1.0
    return rays, inst, bounds, tri_tbl, tri_bounds, n_ic, T(scale_of)


def scene_for(scale):
    """b7_scene with only the rays built for the instance of `scale` live
    (scale None: every ray of the scene, the instance-to-instance ones
    included). Returns intersect_mesh_instances_walk's arguments."""
    rays, inst, bounds, tri_tbl, tri_bounds, n_ic, scale_of = b7_scene()
    rays = rays.clone()
    if scale is not None:
        rays[7] = torch.where(scale_of == np.float32(scale), rays[7], -1.0)
    return rays, inst, bounds, tri_tbl, tri_bounds, tk.TRI_CHUNK, n_ic


@pytest.mark.parametrize("scale", [*SCALES, None])
def test_b7_walk_equals_plain(scale):
    """intersect_mesh_instances_walk (B7's kernel walk) gives the plain
    version's t, face and instance words on the rays built for the
    instance of scale 0.25, 1 or 4 (edge, rim and segment-end rays), and
    on the whole scene, whose instance-to-instance rays end their segments
    at the running best; the cull skips chunks at every scale (the
    direction it reads is the rotated unit one, not the one scaled by
    1/scale), and the guard sweeps faces of skipped chunks."""
    args = scene_for(scale)
    rays, inst, bounds, tri_tbl, _, _, n_ic = args
    plain_work = {}
    plain = tk.intersect_mesh_instances_plain(rays, inst, bounds, tri_tbl,
                                              n_ic, work=plain_work)
    words, counts, work = tk.intersect_mesh_instances_walk(*args)
    for p, w in zip(plain, words):
        assert torch.equal(p.view(torch.int32), w.view(torch.int32))
    assert counts == plain_work
    hits = int(torch.isfinite(plain[0]).sum())
    assert 0 < hits < counts["live"]
    tests, met, cones, guards, swept = work.sum(0).tolist()
    assert 0 < met < tests and cones == tests - met
    assert 0 < guards < cones * tk.TRI_CHUNK
    if scale is None:
        assert len(set(plain[2][torch.isfinite(plain[0])].tolist())) == 3


def test_b7_work_counts_culled_below_unculled():
    """intersect_mesh_instances_work sums the walk's counts: its words are
    the plain version's, the faces it sweeps are fewer than the unculled
    sweeps' (sweeps x F_pad, the plain version's work), and every counter
    equals the walk's own sum."""
    args = scene_for(None)
    rays, inst, bounds, tri_tbl, _, _, n_ic = args
    plain = tk.intersect_mesh_instances_plain(rays, inst, bounds, tri_tbl,
                                              n_ic)
    words, w = tk.intersect_mesh_instances_work(*args, block=700)
    for p, x in zip(plain, words):
        assert torch.equal(p.view(torch.int32), x.view(torch.int32))
    _, counts, work = tk.intersect_mesh_instances_walk(*args)
    assert {k: w[k] for k in counts} == counts
    assert [w[k] for k in ("tests", "met", "cones", "guards", "rows")] \
        == work.sum(0).tolist()
    assert w["tri_tests"] == counts["sweeps"] * tri_tbl.shape[0]
    assert 0 < w["rows"] < w["tri_tests"]


@pytest.mark.parametrize("scale", [0.25, 4.0])
def test_b7_walk_needs_the_margin_and_guard(monkeypatch, scale):
    """With the cull's margin at 0 and no guard, B7's walk loses or moves
    hits that Moeller-Trumbore accepts on the grazing, edge and rim rays
    built for the instances of scale 0.25 and 4: the margin and the guard
    keep it exact there, where the direction Moeller-Trumbore takes is
    not of unit length."""
    args = scene_for(scale)
    plain = tk.intersect_mesh_instances_plain(*args[:4], args[6])
    with monkeypatch.context() as mp:
        mp.setattr(tk, "TRI_CULL_SCALE", 0.0)
        mp.setattr(tk, "TRI_GUARD", 0.0)
        lost = tk.intersect_mesh_instances_walk(*args)[0]
    assert not all(torch.equal(p.view(torch.int32), x.view(torch.int32))
                   for p, x in zip(plain, lost))
