"""The port's instanced-mesh modules against the reference, on the CPU.

The port takes its plain PyTorch versions here; the reference runs its
Pallas kernels in interpret mode (``interpret=True``, or
``intersect.BACKEND = "interpret"`` for the whole path) and its XLA sweep
with ``BACKEND = "xla"``. Inputs come from numpy seeds and go through both.

Tolerances:
- table makers (numpy on both sides): bit for bit. ``make_inst_tables``:
  the order, the instance table (copies and one division) and the chunk
  count exact; the chunk spheres rtol 1e-5 (a 16-term float32 sum taken in
  another order); the bound-scan table's |c|^2 - r^2 rtol 1e-6 (XLA:CPU
  contracts multiply-adds into FMAs).
- B5: the FMA contraction moves an entry t by a few ulp, which crosses a
  truncation step of the packed key (2^7 or 2^9 ulp) on a few percent of
  lanes. Held: the same instance position on > 98% of live lanes, the
  whole key on > 90%, the entry t within rtol 1e-3 / atol 1e-3.
- B6, B7 and ``intersect_instances``: hit classification equal on > 99.9%
  of lanes, t within rtol 1e-3 / atol 1e-4, the same (instance, face) on
  > 98% (near-tie faces at shared edges may resolve to either side): the
  bars of tests/test_trimesh.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drts_tpu.models import geometry as jgeometry
from drts_tpu.ops import intersect as jintersect, trimesh as jtrimesh
from drts_tpu.ops import trimesh_pallas as jtp
from drts_tpu.utils import math as jm
from drts_tpu_torch import convert
from drts_tpu_torch.ops import intersect as tintersect, trimesh as ttrimesh
from drts_tpu_torch.ops import trimesh_kernels as tk
from drts_tpu_torch.ops.intersect_kernels import INF_BITS, pos_bits

T = torch.from_numpy


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def unit_rows(rng, n, cols):
    v = rng.randn(n, cols)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    """tess -> (geosphere arrays, reference TriMesh, port TriMesh)."""
    out = {}
    for tess in (2, 3):
        arrays = jgeometry.create_geosphere(2.0, tess)
        out[tess] = (arrays, jtrimesh.make_mesh(*arrays),
                     ttrimesh.make_mesh(*arrays, device="cpu"))
    return out


def hard_scene(seed, k=24, n=4096):
    """tests/test_trimesh.py's _cand_vs_serial_scene: a giant ground-like
    instance whose bound contains most origins, overlapping bounds, and
    half the rays spawned on instance surfaces."""
    rng = np.random.RandomState(seed)
    pos = rng.randn(k, 3).astype(np.float32) * 6
    scale = (0.4 + rng.rand(k) * 1.4).astype(np.float32)
    pos[0] = [0.0, -100.0, 0.0]
    scale[0] = 99.0
    rot = unit_rows(rng, k, 4)
    o = rng.randn(n, 3).astype(np.float32) * 8
    half = n // 2
    which = rng.randint(0, k, half)
    dir_out = unit_rows(rng, half, 3)
    o[:half] = pos[which] + dir_out * scale[which][:, None] * 1.001
    return pos, rot, scale, o, unit_rows(rng, n, 3)


@pytest.fixture(scope="module")
def kernel_case(meshes):
    """The hard scene's rays (every 7th lane dead) and per-call tables, as
    the reference builds them, for the kernel-alone tests."""
    _, jmesh, tmesh = meshes[3]
    pos, rot, scale, o, d = hard_scene(7)
    n = o.shape[0]
    jt = jtp.make_inst_tables(jnp.asarray(pos), jnp.asarray(rot),
                              jnp.asarray(scale), jmesh.bound_radius,
                              sort_origin=jnp.asarray(o.mean(0)))
    rays = tintersect.pack_rays(T(o), T(d), torch.zeros(n),
                                torch.full((n,), 1e9))
    rays[7, ::7] = -1.0
    bscan = jtp.make_bscan_table(jt[0])
    return {
        "jmesh": jmesh, "tmesh": tmesh, "n": n, "n_ic": jt[3],
        "jrays": jnp.asarray(rays.numpy()), "rays": rays,
        "jinst": jt[0], "jbounds": jt[1], "jbscan": bscan,
        "inst": T(np.array(jt[0])), "bounds": T(np.array(jt[1])),
        "bscan": T(np.array(bscan)),
        "live": (rays[7] >= rays[6]).numpy(),
    }


def j_bound_scan(case, cursor):
    bs = case["jbscan"]
    return np.asarray(jtp.bound_scan(
        case["jrays"], bs, bs.shape[0] // jtp.BSCAN_CHUNK, jtp.BSCAN_CHUNK,
        jnp.asarray(cursor)[None], interpret=True))[0]


def j_sweep(case, cand, best, binst):
    jmesh = case["jmesh"]
    out = jtp.shared_blas_sweep(
        case["jrays"], jnp.asarray(cand)[None], jnp.asarray(best)[None],
        jnp.asarray(binst)[None], case["jinst"], jmesh.tri_bounds,
        jmesh.tri_tbl, case["jinst"].shape[1], jmesh.n_chunks,
        jmesh.tri_tbl.shape[0] // jmesh.n_chunks, interpret=True,
        conv=bool(jmesh.convex), conv_r=float(jmesh.local_radius))
    return np.asarray(out[0])[0], np.asarray(out[1])[0]


# ----------------------------------------------------------------------------
# Tables


@pytest.mark.parametrize("tess", [2, 3])
def test_build_mesh_tables_bit_for_bit(meshes, tess):
    """The face order and the triangle table (the port builds none of the
    reference's chunk bounds). tess 2 is the padded case: 32 faces in a
    64-row table."""
    (pos, _, _, faces), _, _ = meshes[tess]
    v0 = pos[faces[:, 0]]
    e1, e2 = pos[faces[:, 1]] - v0, pos[faces[:, 2]] - v0
    expect = jtp.build_mesh_tables(v0, e1, e2)
    order, tbl, _ = tk.build_mesh_tables(v0, e1, e2, tk.TRI_CHUNK)
    np.testing.assert_array_equal(order, expect[0])
    np.testing.assert_array_equal(tbl, expect[1])
    f = faces.shape[0]
    assert sorted(order.tolist()) == list(range(f))
    assert tbl.shape[0] == max(64, f) and not tbl[f:].any()


def test_build_mesh_tables_open_mesh():
    """Two disjoint triangles (not closed, not convex): same order and
    table as the reference's, 62 all-zero padding rows."""
    v0 = np.array([[0, 0, 0], [2, 0, 0]], np.float32)
    e1 = np.array([[1, 0, 0], [1, 0, 0]], np.float32)
    e2 = np.array([[0, 1, 0], [0, 1, 1]], np.float32)
    expect = jtp.build_mesh_tables(v0, e1, e2)
    order, tbl, _ = tk.build_mesh_tables(v0, e1, e2, tk.TRI_CHUNK)
    np.testing.assert_array_equal(order, expect[0])
    np.testing.assert_array_equal(tbl, expect[1])
    assert tbl.shape == (64, 9) and not tbl[2:].any()


@pytest.mark.parametrize("tess", [2, 3])
def test_make_mesh_fields_equal(meshes, tess):
    """Every TriMesh field of make_mesh, and of convert.tri_mesh, equals
    the reference's (bit for bit; integers exactly)."""
    _, jmesh, tmesh = meshes[tess]
    conv = convert.tri_mesh(to_np(jmesh), "cpu")
    for mesh in (tmesh, conv):
        for name in ("positions", "normals", "uvs", "tangents", "faces",
                     "v0", "e1", "e2", "bound_radius", "tri_tbl"):
            got = getattr(mesh, name).numpy()
            expect = np.asarray(getattr(jmesh, name))
            assert got.shape == expect.shape, name
            np.testing.assert_array_equal(got, expect, err_msg=name)
        assert mesh.faces.dtype == torch.int64
        assert mesh.inscribed_radius == jmesh.inscribed_radius > 0.5
        assert mesh.vertex_motion is None


def test_inscribed_radius_open_and_closed():
    tri = (np.array([[0, 0, 1]], np.float32), np.array([[1, 0, 0]], np.float32),
           np.array([[0, 1, 0]], np.float32), np.array([[0, 1, 2]], np.int32))
    assert ttrimesh._inscribed_radius(*tri) == 0.0
    assert jtrimesh._inscribed_radius(*tri) == 0.0
    pos, _, _, faces = jgeometry.create_geosphere(1.0, 2)
    # A closed sphere moved off the origin: the origin lies outside.
    for shift in (0.0, 3.0):
        p = pos + np.float32(shift)
        v0 = p[faces[:, 0]]
        args = (v0, p[faces[:, 1]] - v0, p[faces[:, 2]] - v0, faces)
        assert (ttrimesh._inscribed_radius(*args)
                == jtrimesh._inscribed_radius(*args))
    assert ttrimesh._inscribed_radius(*args) == 0.0


@pytest.mark.parametrize("with_origin", [False, True])
@pytest.mark.parametrize("k", [5, 48, 438])
def test_inst_tables_match(k, with_origin):
    """5 instances (one ragged chunk), 48 (three chunks) and 438 (the demo
    scene's count: 28 chunks, a 448-column table, a 512-row scan table).
    jnp.argsort and the port's sorts are both stable."""
    rng = np.random.RandomState(k)
    pos = (rng.randn(k, 3) * 6).astype(np.float32)
    rot = unit_rows(rng, k, 4)
    scale = (0.4 + rng.rand(k) * 1.4).astype(np.float32)
    origin = np.array([0.5, 1.0, -3.0], np.float32) if with_origin else None
    j_tbl, j_bounds, j_order, j_nic = jtp.make_inst_tables(
        jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(scale),
        jnp.float32(1.25),
        sort_origin=None if origin is None else jnp.asarray(origin))
    t_tbl, t_bounds, t_order, t_nic = tk.make_inst_tables(
        T(pos), T(rot), T(scale), torch.tensor(1.25),
        sort_origin=None if origin is None else T(origin))
    assert t_nic == j_nic == -(-k // 16)
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    assert sorted(t_order[t_order >= 0].tolist()) == list(range(k))
    np.testing.assert_array_equal(t_tbl.numpy(), np.asarray(j_tbl))
    assert t_bounds.shape == j_bounds.shape
    np.testing.assert_allclose(t_bounds.numpy(), np.asarray(j_bounds),
                               rtol=1e-5, atol=1e-6)
    j_scan = np.asarray(jtp.make_bscan_table(j_tbl))
    t_scan = tk.make_bscan_table(t_tbl).numpy()
    assert t_scan.shape == j_scan.shape == (-(-t_tbl.shape[1] // 128) * 128, 4)
    np.testing.assert_array_equal(t_scan[:, :3], j_scan[:, :3])
    np.testing.assert_allclose(t_scan[:, 3], j_scan[:, 3], rtol=1e-6)
    assert (t_scan[k:, 3] == np.float32(1e30)).all()


# ----------------------------------------------------------------------------
# The kernels alone


def check_keys(case, got, expect):
    live = case["live"]
    m_pad = case["bscan"].shape[0]
    mask = (1 << pos_bits(m_pad)) - 1
    assert (got[~live] == INF_BITS).all()
    got, expect = got[live], expect[live]
    assert ((got < INF_BITS) == (expect < INF_BITS)).mean() > 0.999
    both = (got < INF_BITS) & (expect < INF_BITS)
    assert both.mean() > 0.1
    assert ((got & mask) == (expect & mask))[both].mean() > 0.98
    assert (got == expect).mean() > 0.90
    np.testing.assert_allclose((got[both] & ~mask).view(np.float32),
                               (expect[both] & ~mask).view(np.float32),
                               rtol=1e-3, atol=1e-3)


def test_bound_scan_matches_interpret(kernel_case):
    """B5 from cursor -1 and from a second-round cursor: each side's own
    first-round keys, as in the candidate loop (a cursor taken from the
    other side may sit a truncation step below the same sphere's key
    here, which would then be found again)."""
    case = kernel_case
    start = np.full(case["n"], -1, np.int32)
    tlas = (case["bounds"], case["inst"].shape[1])
    first = j_bound_scan(case, start)
    got = tk.bound_scan(case["rays"], case["bscan"], T(start), *tlas).numpy()
    check_keys(case, got, first)
    second = j_bound_scan(case, first)
    got2 = tk.bound_scan(case["rays"], case["bscan"], T(got.copy()),
                         *tlas).numpy()
    check_keys(case, got2, second)
    # The cursor advanced: every second key lies beyond its first.
    adv = (got2 < INF_BITS) & case["live"]
    assert (got2[adv] > got[adv]).all() and adv.mean() > 0.1


def check_packed(got, expect, got_inst, expect_inst, f_pad):
    mask = (1 << pos_bits(f_pad)) - 1
    hit_g, hit_e = got < INF_BITS, expect < INF_BITS
    assert (hit_g == hit_e).mean() > 0.999
    both = hit_g & hit_e
    assert both.mean() > 0.2
    np.testing.assert_allclose((got[both] & ~mask).view(np.float32),
                               (expect[both] & ~mask).view(np.float32),
                               rtol=1e-3, atol=1e-4)
    same = ((got & mask) == (expect & mask)) & (got_inst == expect_inst)
    assert same[both].mean() > 0.98


def test_shared_blas_sweep_matches_interpret(kernel_case):
    """B6 on the first round's candidates, then on the second round's with
    the first round's best folded in (tmax_eff = min(tmax, best t))."""
    case = kernel_case
    n, m_tbl = case["n"], case["inst"].shape[1]
    tri_tbl = case["tmesh"].tri_tbl
    mask = (1 << pos_bits(case["bscan"].shape[0])) - 1
    key = j_bound_scan(case, np.full(n, -1, np.int32))
    best = np.full(n, INF_BITS, np.int32)
    binst = np.zeros(n, np.int32)
    for _ in range(2):
        cand = np.where(key < INF_BITS, key & mask, m_tbl).astype(np.int32)
        j_best, j_binst = j_sweep(case, cand, best, binst)
        t_best, t_binst = tk.shared_blas_sweep(
            case["rays"], T(cand), T(best.copy()), T(binst.copy()),
            case["inst"], tri_tbl, case["tmesh"].tri_bounds,
            case["tmesh"].tri_chunk)
        check_packed(t_best.numpy(), j_best, t_binst.numpy(), j_binst,
                     tri_tbl.shape[0])
        # Lanes without a candidate keep what they had.
        idle = cand == m_tbl
        np.testing.assert_array_equal(t_best.numpy()[idle], best[idle])
        best, binst = j_best, j_binst
        key = j_bound_scan(case, key)


def test_serial_walk_matches_interpret(kernel_case):
    """B7 over every instance, with and without a far limit."""
    case = kernel_case
    jmesh, tmesh = case["jmesh"], case["tmesh"]
    for tmax in (None, 9.0):
        rays = case["rays"].clone()
        if tmax is not None:
            rays[7] = torch.where(rays[7] > 0, tmax, rays[7])
        j_t, j_face, j_inst = (np.asarray(x) for x in
                               jtp.intersect_mesh_instances(
            jnp.asarray(rays.numpy()), case["jinst"], case["jbounds"],
            jmesh.tri_bounds, jmesh.tri_tbl, case["n_ic"], jtp.INST_CHUNK,
            jmesh.n_chunks, jmesh.tri_tbl.shape[0] // jmesh.n_chunks,
            interpret=True, conv=bool(jmesh.convex),
            conv_r=float(jmesh.local_radius)))
        t_t, t_face, t_inst = (x.numpy() for x in tk.intersect_mesh_instances(
            rays, case["inst"], case["bounds"], tmesh.tri_tbl, case["n_ic"]))
        hit_j, hit_t = np.isfinite(j_t), np.isfinite(t_t)
        assert (hit_j == hit_t).mean() > 0.999
        assert not hit_t[~case["live"]].any()
        both = hit_j & hit_t
        assert both.mean() > 0.2
        np.testing.assert_allclose(t_t[both], j_t[both], rtol=1e-3, atol=1e-4)
        same = (t_face == j_face) & (t_inst == j_inst)
        assert same[both].mean() > 0.98


def dense_serial(rays, inst_tbl, tri_tbl):
    """B7 with no cull at all: every live ray against every instance with
    a positive radius, in table order."""
    n, f_pad = rays.shape[1], tri_tbl.shape[0]
    trunc = ~((1 << pos_bits(f_pad)) - 1)
    best = torch.full((n,), INF_BITS, dtype=torch.int32)
    binst = torch.zeros(n, dtype=torch.int32)
    tmax = torch.where(rays[7] >= rays[6], rays[7], -1.0)
    for k in range(inst_tbl.shape[1]):
        row = inst_tbl[:, k]
        if float(row[8]) <= 0.0:
            continue
        ol, dl, inv_s = tk._to_object(rays, row)
        hit = tk._sweep_packed(ol, tuple(x * inv_s for x in dl), rays[6],
                               tmax, tri_tbl, trunc, 4096)
        binst = torch.where(hit < best, k, binst).to(torch.int32)
        best = torch.minimum(best, hit)
    return (best & trunc).view(torch.float32), best & ~trunc, binst


def test_serial_walk_culls_change_nothing(kernel_case):
    """The plain B7's per-ray sphere tests (chunk spheres, instance
    spheres, the running best as the far limit) are conservative: it
    equals the unculled dense walk bit for bit."""
    case = kernel_case
    rays = case["rays"][:, :1024].contiguous()
    got = tk.intersect_mesh_instances(rays, case["inst"], case["bounds"],
                                      case["tmesh"].tri_tbl, case["n_ic"])
    expect = dense_serial(rays, case["inst"], case["tmesh"].tri_tbl)
    assert bool(torch.isfinite(expect[0]).any())
    for g, e in zip(got, expect):
        assert torch.equal(g.view(torch.int32), e.view(torch.int32))


def test_wrappers_refuse_wrong_tensors(kernel_case):
    case = kernel_case
    n = case["n"]
    words = torch.zeros(n, dtype=torch.int32)
    tlas = (case["bounds"], case["inst"].shape[1])
    with pytest.raises(ValueError):
        tk.bound_scan(case["rays"], case["bscan"], words.long(), *tlas)
    with pytest.raises(ValueError):
        tk.bound_scan(case["rays"], case["bscan"].T, words, *tlas)
    with pytest.raises(ValueError):
        tk.bound_scan(case["rays"][:7], case["bscan"], words, *tlas)
    with pytest.raises(ValueError, match="chunks"):
        tk.bound_scan(case["rays"], case["bscan"], words,
                      case["bounds"][:, :1].contiguous(), tlas[1])
    with pytest.raises(ValueError, match="m_tbl"):
        tk.bound_scan(case["rays"], case["bscan"], words, case["bounds"],
                      case["bscan"].shape[0] + 1)
    tmesh = case["tmesh"]
    with pytest.raises(ValueError):
        tk.shared_blas_sweep(case["rays"], words[:-1], words, words,
                             case["inst"], tmesh.tri_tbl, tmesh.tri_bounds,
                             tmesh.tri_chunk)
    with pytest.raises(ValueError, match="chunk"):
        tk.shared_blas_sweep(case["rays"], words, words, words, case["inst"],
                             tmesh.tri_tbl, tmesh.tri_bounds, 12)
    with pytest.raises(ValueError, match="tri_bounds"):
        tk.shared_blas_sweep(case["rays"], words, words, words, case["inst"],
                             tmesh.tri_tbl,
                             tmesh.tri_bounds[:, :1].contiguous(),
                             tmesh.tri_chunk)
    with pytest.raises(ValueError):
        tk.intersect_mesh_instances(case["rays"], case["inst"],
                                    case["bounds"], case["tmesh"].tri_tbl,
                                    case["n_ic"] + 1)


# ----------------------------------------------------------------------------
# intersect_instances


def reference_instances(backend, cand, mesh, pos, rot, scale, o, d, tmin=0.0):
    n = o.shape[0]
    old = (jintersect.BACKEND, jtrimesh.MESH_CAND)
    jintersect.BACKEND, jtrimesh.MESH_CAND = backend, cand
    try:
        return to_np(jtrimesh.intersect_instances(
            jnp.asarray(o), jnp.asarray(d), jnp.full((n,), tmin),
            jnp.full((n,), 1e9), mesh, jnp.asarray(pos), jnp.asarray(rot),
            jnp.asarray(scale)))
    finally:
        jintersect.BACKEND, jtrimesh.MESH_CAND = old


def port_instances(mesh, pos, rot, scale, o, d, rounds, tmin=0.0):
    n = o.shape[0]
    return ttrimesh.intersect_instances(
        T(o), T(d), torch.full((n,), tmin), torch.full((n,), 1e9), mesh,
        T(pos), T(rot), T(scale), rounds=rounds)


def check_hits(got, expect, inst_share=0.98):
    hit_g, hit_e = got.hit.numpy(), expect.hit
    assert (hit_g == hit_e).mean() > 0.999, (hit_g != hit_e).sum()
    both = hit_g & hit_e
    assert both.mean() > 0.2
    np.testing.assert_allclose(got.t.numpy()[both], expect.t[both],
                               rtol=1e-3, atol=1e-4)
    same = ((got.instance.numpy() == expect.instance)
            & (got.face.numpy() == expect.face))
    assert same[both].mean() > inst_share, same[both].mean()
    sf = both & same
    np.testing.assert_allclose(got.barycentrics.numpy()[sf],
                               expect.barycentrics[sf], atol=2e-3)


@pytest.fixture(scope="module")
def hard_case(meshes):
    _, jmesh, tmesh = meshes[3]
    scene = hard_scene(7)
    serial = reference_instances("interpret", 0, jmesh, *scene)
    return tmesh, scene, serial


@pytest.mark.parametrize("rounds", [3, 1, 0])
def test_intersect_instances_matches_serial_reference(hard_case, rounds):
    """3 rounds (the default), 1 round (the backstop carries most lanes)
    and 0 (B7 alone) against the reference's serial kernel."""
    tmesh, scene, serial = hard_case
    got = port_instances(tmesh, *scene, rounds=rounds)
    assert 0.3 < got.hit.float().mean() < 0.99
    check_hits(got, serial)


def test_intersect_instances_matches_xla_sweep(meshes):
    """5 rotated, scaled instances against the reference's portable XLA
    sweep (tests/test_trimesh.py's first Pallas case), and origins inside
    the instances with tmin > 0."""
    _, jmesh, tmesh = meshes[3]
    rng = np.random.RandomState(3)
    k, n = 5, 4096
    pos = (rng.randn(k, 3) * 4).astype(np.float32)
    rot = unit_rows(rng, k, 4)
    scale = (0.5 + rng.rand(k) * 1.5).astype(np.float32)
    o = (rng.randn(n, 3) * 8).astype(np.float32)
    d = unit_rows(rng, n, 3)
    # Every other ray aims near an instance, so enough rays hit.
    aim = pos[rng.randint(0, k, n)] + 0.5 * rng.randn(n, 3) - o
    d[::2] = (aim / np.linalg.norm(aim, axis=1, keepdims=True))[::2]
    expect = reference_instances("xla", 1, jmesh, pos, rot, scale, o, d)
    check_hits(port_instances(tmesh, pos, rot, scale, o, d, 3), expect)

    which = rng.randint(0, k, 256)
    inside = (pos[which] + unit_rows(rng, 256, 3)
              * (0.5 * scale[which][:, None])).astype(np.float32)
    d_in = unit_rows(rng, 256, 3)
    expect = reference_instances("xla", 1, jmesh, pos, rot, scale, inside,
                                 d_in, tmin=1e-3)
    assert expect.hit.all()
    got = port_instances(tmesh, pos, rot, scale, inside, d_in, 3, tmin=1e-3)
    check_hits(got, expect)


def test_interpolate_attributes_match(hard_case, meshes):
    """Same TriHit in -> same normal, uv and tangent out (rtol 1e-5 / atol
    1e-5: a 3-term float32 sum and a normalize)."""
    _, jmesh, tmesh = meshes[3]
    _, (pos, rot, scale, o, d), serial = hard_case
    j_out = jtrimesh.interpolate_attributes(
        jmesh, jax.tree.map(jnp.asarray, serial), jnp.asarray(rot))
    hit = ttrimesh.TriHit(
        hit=torch.tensor(serial.hit), t=torch.tensor(serial.t),
        face=torch.tensor(serial.face).long(),
        instance=torch.tensor(serial.instance).long(),
        barycentrics=torch.tensor(serial.barycentrics))
    t_out = ttrimesh.interpolate_attributes(tmesh, hit, T(rot))
    for got, expect in zip(t_out, j_out):
        np.testing.assert_allclose(got.numpy(), np.asarray(expect),
                                   rtol=1e-5, atol=1e-5)


def test_unported_entries_raise(meshes):
    """``intersect_mesh`` and ``intersect_instances_any`` once raised as
    unported; both run now. On one identity instance the dense sweep, the
    shadow ray and the closest hit see the same mesh: the same hit bit on
    every ray that does not graze an edge (> 99.9%), t within rtol 1e-3 /
    atol 1e-4, and a ray from the centre hits within the geosphere's
    inscribed and bounding radii. (tests/test_torch_trilight.py and
    tests/test_torch_trimesh_any.py hold both against the reference.)"""
    _, _, tmesh = meshes[3]
    rng = np.random.RandomState(17)
    n = 2048
    o = (unit_rows(rng, n, 3) * 5).astype(np.float32)
    aim = 1.2 * rng.randn(n, 3) - o
    d = (aim / np.linalg.norm(aim, axis=1, keepdims=True)).astype(np.float32)
    o[:256] = 0.0
    tmax = np.where(np.arange(n) % 5 == 0, 4.0, 1e9).astype(np.float32)
    t, face, u, v = ttrimesh.intersect_mesh(T(o), T(d), 0.0, T(tmax), tmesh)
    hit = torch.isfinite(t)
    assert 0.2 < float(hit.float().mean()) < 0.95 and bool(hit[:256].all())
    assert float(t[:256].min()) >= tmesh.inscribed_radius * (1 - 1e-5)
    assert float(t[:256].max()) <= tmesh.bound_radius * (1 + 1e-5)
    assert int(face.max()) < tmesh.v0.shape[0]
    assert bool((face[~hit] == 0).all())
    assert bool(((u >= 0) & (v >= 0) & (u + v <= 1 + 1e-6))[hit].all())
    one = (T(np.zeros((1, 3), np.float32)),
           T(np.array([[0, 0, 0, 1]], np.float32)), torch.ones(1))
    occ = ttrimesh.intersect_instances_any(T(o), T(d), 0.0, T(tmax), tmesh,
                                           *one)
    closest = ttrimesh.intersect_instances(T(o), T(d), 0.0, T(tmax), tmesh,
                                           *one)
    assert occ.dtype == torch.bool
    assert float((occ == hit).float().mean()) > 0.999
    assert float((closest.hit == hit).float().mean()) > 0.999
    both = (closest.hit & hit).numpy()
    np.testing.assert_allclose(closest.t.numpy()[both], t.numpy()[both],
                               rtol=1e-3, atol=1e-4)
